// Traceback walker over the full-matrix DP's moves, on the card.
//
// Replaces: unicycler_tpu/ops/pairwise.py:287 decode_traceback, a host
// function (the JAX package copies the whole (B, n_pad, m_pad + 1) moves
// array to the host and walks each pair there; so did the port before this
// kernel). Plain twin: ops/pairwise.walk_full_plain. It walks each pair's
// moves (csrc/pairwise.cu's bytes: bits 0-1 the H source DIAG 0 / E 1 /
// F 2, bit 2 E-extend, bit 3 F-extend) from (end_i, end_j) with the states
// and stops of decode_traceback and native/cigar_decode.cpp:117: in state
// H at row 0 stop, first emitting D for the j columns left unless
// free_start_s2; at column 0 stop, first emitting I for the i rows left
// unless free_start_s1; else DIAG emits M and steps diagonally, E and F
// change state; state E emits D and steps left, F emits I and steps up,
// each back to H when the cell's extension bit is clear or the walk
// reaches column (row) 0. Runs of one op merge. Output per pair, in walk
// order (the path's last run first, as the native decoder writes them):
// the runs (count, op) with op 0 = M, 1 = I, 2 = D, and a header of score,
// end_i, end_j (copied from the forward's outputs, so one fetch brings
// everything back), the run count, start_i and start_j. Walks start at
// end_i <= n_act and end_j <= m_act and read only moves rows < n_act and
// columns <= m_act, the region csrc/pairwise.cu writes.
//
// What bounds it on an H100: latency. Each step depends on the one before,
// so a walk costs (path length) x (one step), and a launch costs its
// longest walk; the bytes are a few a step. What matters is that a step
// reads shared memory, not device memory, and that the common steps go
// many at a time.
//
// Design (after csrc/banded_walk.cu): one warp a pair, four warps a block.
// The walk goes up the rows in chunks of TR = 32 rows. For each row of a
// chunk the warp stages SPAN = 128 bytes (whole 16-byte groups, one lane a
// row, by cp.async) around a guessed column, the diagonal through the point
// where staging was planned. NBUF chunks are in flight at once: while the
// warp walks chunk k, the copies of chunks k + 1 .. k + NBUF - 1 land, and
// entering chunk k + 1 issues chunk k + NBUF on the diagonal through the
// entry point. Steps go 32 at a time across the lanes: in state H lane k
// reads the cell k steps down the diagonal and the warp takes every
// leading DIAG step at once; in state E (F) lane k reads the cell k
// columns left (rows up) and the warp takes the run up to the first cell
// that ends it. Where a diagonal leaves the staged windows the warp
// restages there and waits; where a gap run leaves them (a long insertion
// or deletion) the warp reads the rest of the run from device memory,
// DW = 8 cells a lane (256 a round trip), and restages once it is back on
// a diagonal. Lane 0 writes the runs. Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;    // pairs a block, one warp each
constexpr int TR = 32;      // moves rows a chunk
constexpr int SPAN = 128;   // bytes staged a row (8 groups of 16)
constexpr int HALF = 56;    // the guessed column's place in its window
constexpr int NBUF = 4;     // chunks in flight
constexpr int DW = 8;       // cells a lane reads a round trip of a gap run
constexpr int HEAD = 6;     // header words a pair: score, end_i, end_j, runs, start_i, start_j
constexpr unsigned FULL = 0xffffffffu;

struct Chunk {
  uint8_t mv[TR][SPAN];  // row top - s's bytes ws[s] .. ws[s] + SPAN - 1
  long long ws[TR];      // offset of each row's window in the moves buffer
};

struct Args {
  const uint8_t* moves;  // (B, n_pad, ms): rows of ms >= m_pad + 1 bytes, 16-byte aligned
  const int* score;
  const int* end_i;
  const int* end_j;
  int* out;              // (B, HEAD + 2 * max_ops): header, then (count, op) runs
  int B, n_pad, ms, max_ops, fs1, fs2;
  long long total16;     // the moves buffer's bytes, rounded down to 16
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage chunk `top` (rows top - TR + 1 .. top) into ch, each row's window
// around the diagonal through (te, je); one lane a row; commits a group
__device__ __forceinline__ void stage(Chunk& ch, const Args& a, long long pbase, int top,
                                      int te, int je, int lane) {
  const int t = top - lane;
  if (t >= 0) {
    const long long want = pbase + (long long)t * a.ms + (je - (te - t)) - HALF;
    long long ws = want & ~15ll;
    if (ws > a.total16 - SPAN) ws = a.total16 - SPAN;
    if (ws < 0) ws = 0;
    ch.ws[lane] = ws;
#pragma unroll
    for (int g = 0; g < SPAN / 16; ++g) cp_async16(&ch.mv[lane][16 * g], a.moves + ws + 16 * g);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(WARPS * 32) pairwise_walk(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= a.B) return;  // uniform over the warp
  Chunk* ring = reinterpret_cast<Chunk*>(smem) + (size_t)warp * NBUF;
  const long long pbase = (long long)b * a.n_pad * a.ms;
  const bool direct = a.total16 < SPAN;  // too small to stage: read device memory
  int i = a.end_i[b], j = a.end_j[b];
  int* hdr = a.out + (size_t)b * (HEAD + 2 * a.max_ops);
  int* runs = hdr + HEAD;
  int n_runs = 0, cur_op = -1, cur_n = 0;
  // one op of n steps; lane 0 writes a run when the op changes
  auto emit = [&](int op, int n) {
    if (n <= 0) return;
    if (op == cur_op) {
      cur_n += n;
      return;
    }
    if (cur_n > 0) {
      if (lane == 0) {
        runs[2 * n_runs] = cur_n;
        runs[2 * n_runs + 1] = cur_op;
      }
      ++n_runs;
    }
    cur_op = op;
    cur_n = n;
  };

  int top = i - 1;  // the current chunk's first row (moves row index)
  int k = 0;        // the current chunk's number; its buffer is k % NBUF
  if (!direct && i > 0 && j > 0) {
    for (int c = 0; c < NBUF; ++c) stage(ring[c], a, pbase, top - c * TR, i - 1, j, lane);
    cp_async_wait<NBUF - 1>();
    __syncwarp();
  }
  // the byte of cell (t + 1, jj) (moves row t); -2 when the row is not in
  // the current chunk, -1 when the column is not in the row's window
  auto cell = [&](int t, int jj) -> int {
    const long long off = pbase + (long long)t * a.ms + jj;
    // the buffer's last partial group is never staged
    if (direct || off >= a.total16) return a.moves[off];
    const int s = top - t;
    if (s < 0 || s >= TR) return -2;
    const Chunk& ch = ring[k % NBUF];
    const long long o = off - ch.ws[s];
    return (o >= 0 && o < SPAN) ? ch.mv[s][o] : -1;
  };
  // restage the current chunk and those ahead around the diagonal through
  // moves row t, column jj, and wait for the current one
  auto restage = [&](int t, int jj) {
    cp_async_wait<0>();
    __syncwarp();
    for (int c = 0; c < NBUF; ++c)
      stage(ring[(k + c) % NBUF], a, pbase, top - c * TR, t, jj, lane);
    cp_async_wait<NBUF - 1>();
    __syncwarp();
  };

  // the rest of a gap run (E: horiz, F: up) from device memory, DW cells a
  // lane; ends in state H
  auto run_direct = [&](bool horiz) {
    for (;;) {
      int v[DW];
#pragma unroll
      for (int c = 0; c < DW; ++c) {
        const int x = lane * DW + c;  // steps from (i, j)
        const int t = horiz ? i - 1 : i - 1 - x, jj = horiz ? j - x : j;
        v[c] = (t >= 0 && jj >= 1) ? a.moves[pbase + (long long)t * a.ms + jj] : 0;
      }
      int first = DW;  // this lane's first cell that ends the run
#pragma unroll
      for (int c = DW - 1; c >= 0; --c) {
        const int x = lane * DW + c;
        const bool stop = horiz ? (!(v[c] & 4) || j - x <= 1) : (!(v[c] & 8) || i - 1 - x <= 0);
        if (stop) first = c;
      }
      const unsigned has = __ballot_sync(FULL, first < DW);
      const int n = has ? (__ffs(has) - 1) * DW + __shfl_sync(FULL, first, __ffs(has) - 1) + 1
                        : 32 * DW;
      emit(horiz ? 2 : 1, n);
      if (horiz)
        j -= n;
      else
        i -= n;
      if (has) return;
    }
  };

  int state = 0;  // 0 H, 1 E, 2 F
  for (;;) {
    if (state == 0) {
      if (i == 0) {
        if (!a.fs2 && j > 0) {
          emit(2, j);
          j = 0;
        }
        break;
      }
      if (j == 0) {
        if (!a.fs1 && i > 0) {
          emit(1, i);
          i = 0;
        }
        break;
      }
    }
    // the walk's row left the current chunk: the next one is in flight
    if (!direct && i - 1 < top - TR + 1) {
      cp_async_wait<NBUF - 2>();
      __syncwarp();
      ++k;
      top -= TR;
      stage(ring[(k + NBUF - 1) % NBUF], a, pbase, top - (NBUF - 1) * TR, i - 1, j, lane);
    }
    if (state == 0) {
      // lane x: the cell x steps down the diagonal
      const int ti = i - 1 - lane, tj = j - lane;
      int c = -1;
      if (i - lane >= 1 && tj >= 1) c = cell(ti, tj);
      const unsigned diag = __ballot_sync(FULL, c >= 0 && (c & 3) == 0);
      const int n = diag == FULL ? 32 : __ffs(~diag) - 1;
      if (n > 0) {
        emit(0, n);
        i -= n;
        j -= n;
        continue;
      }
      const int c0 = __shfl_sync(FULL, c, 0);
      if (c0 < 0) {
        restage(i - 1, j);
        continue;
      }
      state = (c0 & 3) == 1 ? 1 : 2;
    } else {
      // lane x: the cell x columns left (E) or x rows up (F)
      const bool horiz = state == 1;
      const int ti = horiz ? i - 1 : i - 1 - lane, tj = horiz ? j - lane : j;
      int c = -3;
      if (ti >= 0 && tj >= 1) c = cell(ti, tj);
      const bool stop = c >= 0 && (horiz ? (!(c & 4) || tj == 1) : (!(c & 8) || ti == 0));
      const unsigned go = __ballot_sync(FULL, c >= 0 && !stop);
      const unsigned ends = __ballot_sync(FULL, stop);
      const int n = go == FULL ? 32 : __ffs(~go) - 1;
      const bool ended = n < 32 && ((ends >> n) & 1u);
      const int steps = ended ? n + 1 : n;
      emit(horiz ? 2 : 1, steps);
      if (horiz)
        j -= steps;
      else
        i -= steps;
      if (ended) {
        state = 0;
      } else if (n < 32 && __shfl_sync(FULL, c, n) == -1) {
        // the run leaves the windows: finish it from device memory, then
        // restage where it ends if that is past the current chunk
        run_direct(horiz);
        state = 0;
        if (!direct && i > 0 && i - 1 < top - TR + 1) {
          top = i - 1;
          restage(i - 1, j);
        }
      }
    }
  }
  if (cur_n > 0) {
    if (lane == 0) {
      runs[2 * n_runs] = cur_n;
      runs[2 * n_runs + 1] = cur_op;
    }
    ++n_runs;
  }
  cp_async_wait<0>();
  if (lane == 0) {
    hdr[0] = a.score[b];
    hdr[1] = a.end_i[b];
    hdr[2] = a.end_j[b];
    hdr[3] = n_runs;
    hdr[4] = i;
    hdr[5] = j;
  }
}

}  // namespace

// One warp a pair on `stream`. moves (rows of ms >= m_pad + 1 bytes) must
// be 16-byte aligned; out is (B, 6 + 2 * max_ops) int32 with max_ops =
// n_pad + m_pad + 17. Returns a cudaError_t.
extern "C" int pairwise_walk_launch(const uint8_t* moves, const int* score, const int* end_i,
                                    const int* end_j, int* out, int B, int n_pad, int m_pad,
                                    int ms, int fs1, int fs2, void* stream) {
  if (B <= 0 || n_pad < 0 || m_pad < 0 || ms < m_pad + 1) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)moves & 15) return (int)cudaErrorMisalignedAddress;
  const long long total = (long long)B * n_pad * (long long)ms;
  Args a{moves, score, end_i, end_j, out, B, n_pad, ms, n_pad + m_pad + 17,
         fs1, fs2, total & ~15ll};
  const size_t shmem = sizeof(Chunk) * NBUF * WARPS;
  cudaError_t err = cudaFuncSetAttribute(pairwise_walk,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  pairwise_walk<<<(B + WARPS - 1) / WARPS, WARPS * 32, shmem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
