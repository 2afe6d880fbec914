// Parallel windowed k-mer range search over the composite fine index.
//
// The fine index (ops/minimizer.get_fine_index) is a sorted uint64 array
// of (kmer << 32 | position) entries; per alignment task the seeder needs,
// for every query k-mer, the index range of occurrences whose position
// lies in the task's reference window. numpy's searchsorted runs this
// single-threaded at ~100 ns/probe (memory-latency bound); this native
// version splits the query array over a thread pool and finds the upper
// bound with a short exponential gallop from the lower bound (occurrence
// lists are nearly always tiny), roughly halving probe count. The role of
// the reference's per-thread common-k-mer collection loop
// (ref src/semi_global_align.cpp:197-207 + src/kmers.cpp), recast as a
// batch primitive.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

// Bounded variant: each query k-mer's occurrence list [lo0, hi0) in the
// composite index is already known (computed ONCE per (read, reference)
// and cached, ops/minimizer.collect_common_kmers), so the per-window
// search runs over the tiny occurrence list instead of the whole index:
// a linear scan for short lists, binary search otherwise. This removes
// the ~20 cache-missing probes per k-mer per task that repeated
// window_ranges_u64 calls paid when one read seeds several tasks.
extern "C" void window_ranges_bounded(
    const uint64_t* ck,
    const int64_t* lo0, const int64_t* hi0, int64_t m,
    uint64_t lo_add, uint64_t hi_add,
    const uint64_t* qck,
    int64_t* lo_out, int64_t* hi_out,
    int n_threads)
{
    auto work = [=](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            int64_t lo = lo0[i], hi = hi0[i];
            if (lo >= hi) {
                lo_out[i] = lo;
                hi_out[i] = lo;
                continue;
            }
            const uint64_t qlo = qck[i] | lo_add;
            const uint64_t qhi = qck[i] | hi_add;
            if (hi - lo <= 16) {
                int64_t p = lo;
                while (p < hi && ck[p] < qlo)
                    ++p;
                lo_out[i] = p;
                while (p < hi && ck[p] < qhi)
                    ++p;
                hi_out[i] = p;
            } else {
                lo_out[i] = std::lower_bound(ck + lo, ck + hi, qlo) - ck;
                hi_out[i] = std::lower_bound(ck + lo, ck + hi, qhi) - ck;
            }
        }
    };
    if (n_threads <= 1 || m < 65536) {
        work(0, m);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t a = t * chunk;
        int64_t b = std::min(m, a + chunk);
        if (a >= b)
            break;
        threads.emplace_back(work, a, b);
    }
    for (auto& th : threads)
        th.join();
}

extern "C" void window_ranges_u64(
    const uint64_t* ck, int64_t n,      // sorted composite index
    const uint64_t* qck, int64_t m,     // query kmers, pre-shifted << 32
    uint64_t lo_add, uint64_t hi_add,   // window [w0, w1) position bounds
    int64_t* lo_out, int64_t* hi_out,
    int n_threads)
{
    auto work = [=](int64_t a, int64_t b) {
        for (int64_t i = a; i < b; ++i) {
            uint64_t qlo = qck[i] | lo_add;
            int64_t lo = std::lower_bound(ck, ck + n, qlo) - ck;
            lo_out[i] = lo;
            uint64_t qhi = qck[i] | hi_add;
            if (qhi <= qlo) {     // inverted/empty window: plain search
                hi_out[i] = std::lower_bound(ck, ck + n, qhi) - ck;
                continue;
            }
            // exponential gallop for the upper bound: first index >= qhi
            // at or after lo
            int64_t bound = 1;
            while (lo + bound < n && ck[lo + bound - 1] < qhi)
                bound <<= 1;
            int64_t r = std::min(n, lo + bound);
            int64_t l = lo + (bound >> 1);
            if (l > n) l = n;
            hi_out[i] = std::lower_bound(ck + l, ck + r, qhi) - ck;
        }
    };
    if (n_threads <= 1 || m < 4096) {
        work(0, m);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t a = t * chunk;
        int64_t b = std::min(m, a + chunk);
        if (a >= b)
            break;
        threads.emplace_back(work, a, b);
    }
    for (auto& th : threads)
        th.join();
}
