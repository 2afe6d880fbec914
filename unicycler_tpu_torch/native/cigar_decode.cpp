// Native traceback decoders for the device DP kernels.
//
// The banded DP kernels (ops/banded_kernel.py, csrc/banded.cu) emit packed 4-bit move
// matrices; turning them into CIGAR operation runs is a strictly serial
// walk of up to n+m steps per alignment. In Python that walk caps driver
// throughput at ~1M steps/s, so it lives here as the framework's native
// runtime component (the role the reference's C++ layer plays for its
// Python driver, ref unicycler/cpp_wrappers.py — this is new code, not a
// port: the reference decodes SeqAn gap rows, we decode packed move bits).
//
// Move byte layout (must match ops/pairwise.py):
//   bits 0-1: H source (0=DIAG, 1=E/horizontal, 2=F/vertical)
//   bit 2:    E-extend   bit 3: F-extend

#include <cstddef>
#include <cstdint>

using std::size_t;

namespace {

constexpr int DIAG = 0;
constexpr int E_SRC = 1;
constexpr int F_SRC = 2;
constexpr int E_EXT_BIT = 4;
constexpr int F_EXT_BIT = 8;

// op codes written to out_ops: 0=M, 1=I (consumes s1), 2=D (consumes s2)
struct OpWriter {
    int32_t* ops;       // interleaved (count, op) pairs, written backwards
    int capacity;       // in pairs
    int count = 0;
    bool overflow = false;

    void emit(int op, int n) {
        if (count > 0 && ops[2 * (count - 1) + 1] == op) {
            ops[2 * (count - 1)] += n;
            return;
        }
        if (count >= capacity) { overflow = true; return; }
        ops[2 * count] = n;
        ops[2 * count + 1] = op;
        ++count;
    }
};

}  // namespace

extern "C" {

// Banded traceback over 4-bit-PACKED moves in nibble-plane int32 layout:
// row-major (n_rows, W/8) words where word w of a row holds lanes
// {w, w+W/8, ..., w+7W/8}; lane g*W/8+w lives in nibble g of word w.
// c has n_rows+1 entries (band offset per row). Returns the number of
// (count, op) pairs written in REVERSE path order (caller reverses), or
// -1 if the walk left the band (corrupt path). start_i/start_j receive
// the alignment start cell.
int decode_banded_traceback(const int32_t* moves, const int32_t* c,
                            int n_rows, int W, int end_i, int end_j,
                            int free_start_s1, int free_start_s2,
                            int32_t* out_ops, int max_ops,
                            int32_t* start_i, int32_t* start_j) {
    OpWriter w{out_ops, max_ops};
    const int stride = W / 8;
    int i = end_i, j = end_j;
    int state = 0;  // 0=H, 1=E, 2=F

    auto cell = [&](int row, int lane) -> int {
        int word = lane % stride;
        int group = lane / stride;
        uint32_t v = (uint32_t)moves[(size_t)(row - 1) * stride + word];
        return (v >> (4 * group)) & 0xF;
    };

    for (;;) {
        int lane = j - c[i];
        if (i > 0 && (lane < 0 || lane >= W)) return -1;
        if (state == 0) {
            if (i == 0) {
                if (!free_start_s2 && j > 0) { w.emit(2, j); j = 0; }
                break;
            }
            if (j == 0) {
                if (!free_start_s1 && i > 0) { w.emit(1, i); i = 0; }
                break;
            }
            int b = cell(i, lane);
            int src = b & 3;
            if (src == DIAG) {
                w.emit(0, 1);
                --i; --j;
            } else if (src == E_SRC) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            int b = cell(i, lane);
            w.emit(2, 1);
            --j;
            if (!(b & E_EXT_BIT) || j == 0) state = 0;
        } else {
            int b = cell(i, lane);
            w.emit(1, 1);
            --i;
            if (!(b & F_EXT_BIT) || i == 0) state = 0;
        }
        if (w.overflow) return -2;
    }
    *start_i = i;
    *start_j = j;
    return w.count;
}

// Full-matrix traceback. moves is (n_rows, m1) row-major where column j of
// row i-1 holds the bits for DP cell (i, j); m1 = padded columns + 1.
int decode_full_traceback(const uint8_t* moves, int n_rows, int m1,
                          int end_i, int end_j,
                          int free_start_s1, int free_start_s2,
                          int32_t* out_ops, int max_ops,
                          int32_t* start_i, int32_t* start_j) {
    OpWriter w{out_ops, max_ops};
    int i = end_i, j = end_j;
    int state = 0;
    for (;;) {
        if (state == 0) {
            if (i == 0) {
                if (!free_start_s2 && j > 0) { w.emit(2, j); j = 0; }
                break;
            }
            if (j == 0) {
                if (!free_start_s1 && i > 0) { w.emit(1, i); i = 0; }
                break;
            }
            uint8_t b = moves[(size_t)(i - 1) * m1 + j];
            int src = b & 3;
            if (src == DIAG) {
                w.emit(0, 1);
                --i; --j;
            } else if (src == E_SRC) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            uint8_t b = moves[(size_t)(i - 1) * m1 + j];
            w.emit(2, 1);
            --j;
            if (!(b & E_EXT_BIT) || j == 0) state = 0;
        } else {
            uint8_t b = moves[(size_t)(i - 1) * m1 + j];
            w.emit(1, 1);
            --i;
            if (!(b & F_EXT_BIT) || i == 0) state = 0;
        }
        if (w.overflow) return -2;
    }
    *start_i = i;
    *start_j = j;
    return w.count;
}

}  // extern "C"
