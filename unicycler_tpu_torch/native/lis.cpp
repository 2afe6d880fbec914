// Longest nondecreasing subsequence (patience sort, O(n log n)).
// Hot host loop of the seeding stage (ops/minimizer.py::_lis_indices):
// chains fine k-mer anchors into a colinear corridor line (role of the
// reference's SeqAn chainSeedsGlobally, ref src/semi_global_align.cpp).

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// values: n int64 inputs. out_idx: caller-allocated n int64 slots.
// Returns the chain length L; out_idx[0..L) are ascending input indices.
std::int64_t lis_indices(const std::int64_t* values, std::int64_t n,
                         std::int64_t* out_idx) {
    if (n <= 0) return 0;
    std::vector<std::int64_t> tails;       // last value per chain length
    std::vector<std::int64_t> tails_idx;   // input index of that value
    std::vector<std::int64_t> parent(static_cast<std::size_t>(n), -1);
    tails.reserve(256);
    tails_idx.reserve(256);
    for (std::int64_t i = 0; i < n; ++i) {
        const std::int64_t v = values[i];
        // upper_bound(tails, v): first position with tails[pos] > v
        std::size_t lo = 0, hi = tails.size();
        while (lo < hi) {
            const std::size_t mid = (lo + hi) / 2;
            if (tails[mid] <= v) lo = mid + 1; else hi = mid;
        }
        if (lo == tails.size()) {
            tails.push_back(v);
            tails_idx.push_back(i);
        } else {
            tails[lo] = v;
            tails_idx[lo] = i;
        }
        parent[static_cast<std::size_t>(i)] =
            lo > 0 ? tails_idx[lo - 1] : -1;
    }
    std::int64_t len = static_cast<std::int64_t>(tails.size());
    std::int64_t i = tails_idx.back();
    for (std::int64_t k = len - 1; k >= 0; --k) {
        out_idx[k] = i;
        i = parent[static_cast<std::size_t>(i)];
    }
    return len;
}

}  // extern "C"
