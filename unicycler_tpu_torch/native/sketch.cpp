// Native (w,k)-minimiser sketch — the host seeding hot loop.
//
// Exact semantics of ops/minimizer.sketch (which remains the oracle in
// tests/test_native_seed.py, tests/test_minimizer_batch.py): canonical strand-aware k-mer hashing
// (thomas-wang 64-bit mix masked to 2k bits), leftmost argmin of every
// length-w window via a monotonic deque, consecutive-duplicate
// collapse, invalid/palindromic k-mers excluded. The numpy formulation
// costs ~4.4 ms per long read across five full-array passes; this is
// one pass, and it holds no Python objects so seeding threads overlap.
// Role of the reference's vendored mm_sketch (minimap sketch.c).

#include <cstdint>
#include <vector>

static inline uint64_t hash64(uint64_t x, uint64_t mask)
{
    x = (~x + (x << 21)) & mask;
    x = x ^ (x >> 24);
    x = (x + (x << 3) + (x << 8)) & mask;
    x = x ^ (x >> 14);
    x = (x + (x << 2) + (x << 4)) & mask;
    x = x ^ (x >> 28);
    x = (x + (x << 31)) & mask;
    return x;
}

// Returns the number of minimisers written; out arrays must hold at
// least n entries.
extern "C" int64_t sketch_minimizers(
    const int8_t* codes, int64_t n, int k, int w,
    uint64_t* out_hash, int32_t* out_pos, int8_t* out_strand)
{
    const int64_t nk = n - k + 1;
    if (nk <= 0)
        return 0;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const uint64_t UMAX = ~0ULL;

    // canon[i], ok[i], strand[i] per k-mer, rolling.
    std::vector<uint64_t> canon(nk);
    std::vector<int8_t> strandv(nk);
    std::vector<uint8_t> okv(nk);
    uint64_t fwd = 0, rev = 0;
    int since_bad = 0;          // valid bases accumulated
    for (int64_t i = 0; i < n; ++i) {
        const int8_t c = codes[i];
        if (c < 0 || c > 3) {
            since_bad = 0;
            fwd = 0;
            rev = 0;
        } else {
            ++since_bad;
            fwd = ((fwd << 2) | (uint64_t)c) & mask;
            rev = (rev >> 2)
                | ((uint64_t)(3 - c) << (2 * (k - 1)));
        }
        const int64_t j = i - k + 1;
        if (j < 0)
            continue;
        if (since_bad < k) {
            canon[j] = UMAX;
            strandv[j] = 0;
            okv[j] = 0;
            continue;
        }
        const uint64_t hf = hash64(fwd, mask);
        const uint64_t hr = hash64(rev, mask);
        if (hf == hr) {         // palindromic: excluded
            canon[j] = UMAX;
            strandv[j] = 0;
            okv[j] = 0;
        } else if (hr < hf) {
            canon[j] = hr;
            strandv[j] = 1;
            okv[j] = 1;
        } else {
            canon[j] = hf;
            strandv[j] = 0;
            okv[j] = 1;
        }
    }

    int64_t m = 0;
    if (nk <= w) {
        // single argmin over all k-mers, only if any is valid
        int64_t best = 0;
        uint8_t any = 0;
        for (int64_t i = 0; i < nk; ++i) {
            if (canon[i] < canon[best])
                best = i;
            any |= okv[i];
        }
        if (any && okv[best]) {
            out_hash[0] = canon[best];
            out_pos[0] = (int32_t)best;
            out_strand[0] = strandv[best];
            m = 1;
        }
        return m;
    }

    // monotonic deque of indices; strict > pops keep the LEFTMOST
    // minimum at the front (np.argmin tie semantics)
    std::vector<int64_t> dq(nk);
    int64_t head = 0, tail = 0;     // [head, tail)
    int64_t last_sel = -1;
    for (int64_t i = 0; i < nk; ++i) {
        while (tail > head && canon[dq[tail - 1]] > canon[i])
            --tail;
        dq[tail++] = i;
        const int64_t wstart = i - w + 1;
        if (wstart < 0)
            continue;
        while (dq[head] < wstart)
            ++head;
        const int64_t sel = dq[head];
        if (sel != last_sel) {
            last_sel = sel;
            if (okv[sel]) {
                out_hash[m] = canon[sel];
                out_pos[m] = (int32_t)sel;
                out_strand[m] = strandv[sel];
                ++m;
            }
        }
    }
    return m;
}
