// Minimiser lookup of a whole read set in one native pass: sketch, index
// probe, hit expansion, diagonal clustering and LIS chaining.
//
// Exact semantics of ops/minimizer.MinimizerIndex.lookup, whose numpy
// formulation stays as the fallback (tests/test_torch_seed_native.py
// holds the two equal):
// - each read is sketched by sketch_minimizers (sketch.cpp);
// - each minimiser's occurrences come from a hash table built once per
//   index (seedmap_build_table), whose (start, count) are exactly the
//   searchsorted left/right bounds in the sorted index: one cache miss a
//   probe, where a binary search over the index misses at every step;
// - hits expand in minimiser order, then index order;
// - clustering keeps _cluster_hits' rules: groups by (ref id ascending,
//   forward strand before reverse), read positions mirrored on the
//   reverse strand, a stable sort by diagonal, a split where the
//   diagonal steps by more than the radius, a stable sort of each
//   segment by read position, the chain from lis_indices (lis.cpp) on
//   the same values in the same order, segments and chains shorter than
//   min_hits dropped, and a final stable sort by hit count, descending.
//
// Reads are independent, so a batch is split over threads in contiguous
// runs of reads; the output is in read order whatever the split. The
// call holds no Python objects (ctypes releases the GIL around it).

#include <algorithm>
#include <array>
#include <cstdint>
#include <thread>
#include <utility>
#include <vector>

extern "C" int64_t sketch_minimizers(
    const int8_t* codes, int64_t n, int k, int w,
    uint64_t* out_hash, int32_t* out_pos, int8_t* out_strand);
extern "C" int64_t lis_indices(const int64_t* values, int64_t n,
                               int64_t* out_idx);

namespace {

// No minimiser hash reaches it: hashes are masked to 2k < 64 bits.
constexpr uint64_t EMPTY = ~0ULL;
constexpr int REC = 9;      // int64 fields of a cluster record

inline uint64_t slot_of(uint64_t key, int bits)
{
    return (key * 0x9E3779B97F4A7C15ULL) >> (64 - bits);
}

struct Ctx {
    const int8_t* codes;
    const int64_t* offsets;
    const int64_t* lengths;
    const uint64_t* table;
    int bits;
    const int32_t* ref_ids;
    const int32_t* positions;
    const int8_t* strands;
    int k, w;
    int64_t radius, min_hits;
};

struct Hit {
    int64_t key;        // ref id * 2 + relative strand
    int64_t diag;
    int64_t rp, tp;
};

struct Part {
    std::vector<int64_t> rec;       // REC fields a cluster
    std::vector<int32_t> anchors_read, anchors_ref;
};

struct Scratch {
    std::vector<uint64_t> hash;
    std::vector<int32_t> pos;
    std::vector<int8_t> strand;
    std::vector<Hit> hits;
    std::vector<std::pair<int64_t, int64_t>> seg;
    std::vector<int64_t> tp, chain;
    std::vector<std::array<int64_t, REC>> found;
};

inline bool probe(const Ctx& c, uint64_t key, int64_t& start, int64_t& count)
{
    const uint64_t mask = (1ULL << c.bits) - 1;
    for (uint64_t s = slot_of(key, c.bits);; s = (s + 1) & mask) {
        const uint64_t t = c.table[2 * s];
        if (t == key) {
            const uint64_t v = c.table[2 * s + 1];
            start = (int64_t)(v >> 32);
            count = (int64_t)(v & 0xFFFFFFFFULL);
            return true;
        }
        if (t == EMPTY)
            return false;
    }
}

// One diagonal segment [a, b) of s.hits: chain it and keep the cluster.
void chain_segment(const Ctx& c, int64_t ri, int64_t a, int64_t b,
                   Scratch& s, Part& out)
{
    const int64_t n = b - a;
    if (n < c.min_hits)
        return;
    s.seg.clear();
    for (int64_t t = a; t < b; ++t)
        s.seg.emplace_back(s.hits[t].rp, s.hits[t].tp);
    std::stable_sort(s.seg.begin(), s.seg.end(),
                     [](const std::pair<int64_t, int64_t>& x,
                        const std::pair<int64_t, int64_t>& y) {
                         return x.first < y.first;
                     });
    s.tp.resize(n);
    s.chain.resize(n);
    for (int64_t t = 0; t < n; ++t)
        s.tp[t] = s.seg[t].second;
    const int64_t len = lis_indices(s.tp.data(), n, s.chain.data());
    if (len < c.min_hits)
        return;
    const int64_t key = s.hits[a].key;
    const auto& first = s.seg[s.chain[0]];
    const auto& last = s.seg[s.chain[len - 1]];
    s.found.push_back({ri, key >> 1, key & 1, first.first, last.first + c.k,
                       first.second, last.second + c.k, len,
                       (int64_t)out.anchors_read.size()});
    for (int64_t t = 0; t < len; ++t) {
        out.anchors_read.push_back((int32_t)s.seg[s.chain[t]].first);
        out.anchors_ref.push_back((int32_t)s.seg[s.chain[t]].second);
    }
}

void map_read(const Ctx& c, int64_t ri, Scratch& s, Part& out)
{
    const int64_t len = c.lengths[ri];
    const size_t cap = (size_t)std::max<int64_t>(1, len);
    if (s.hash.size() < cap) {
        s.hash.resize(cap);
        s.pos.resize(cap);
        s.strand.resize(cap);
    }
    const int64_t m = sketch_minimizers(c.codes + c.offsets[ri], len, c.k,
                                        c.w, s.hash.data(), s.pos.data(),
                                        s.strand.data());
    s.hits.clear();
    for (int64_t i = 0; i < m; ++i) {
        int64_t start, count;
        if (!probe(c, s.hash[i], start, count))
            continue;
        for (int64_t j = start; j < start + count; ++j) {
            const int64_t rev = s.strand[i] != c.strands[j];
            const int64_t rp = rev ? len - (s.pos[i] + c.k) : s.pos[i];
            const int64_t tp = c.positions[j];
            s.hits.push_back({(int64_t)c.ref_ids[j] * 2 + rev, tp - rp, rp,
                              tp});
        }
    }
    const int64_t nh = (int64_t)s.hits.size();
    if (nh == 0 || nh < c.min_hits)
        return;
    // grouping by key and the stable sort by diagonal within a group
    // are one stable sort by (key, diagonal)
    std::stable_sort(s.hits.begin(), s.hits.end(),
                     [](const Hit& x, const Hit& y) {
                         return x.key != y.key ? x.key < y.key
                                               : x.diag < y.diag;
                     });
    s.found.clear();
    for (int64_t g0 = 0; g0 < nh;) {
        int64_t g1 = g0 + 1;
        while (g1 < nh && s.hits[g1].key == s.hits[g0].key)
            ++g1;
        if (g1 - g0 >= c.min_hits) {
            int64_t a = g0;
            for (int64_t t = g0 + 1; t < g1; ++t) {
                if (s.hits[t].diag - s.hits[t - 1].diag > c.radius) {
                    chain_segment(c, ri, a, t, s, out);
                    a = t;
                }
            }
            chain_segment(c, ri, a, g1, s, out);
        }
        g0 = g1;
    }
    std::stable_sort(s.found.begin(), s.found.end(),
                     [](const std::array<int64_t, REC>& x,
                        const std::array<int64_t, REC>& y) {
                         return x[7] > y[7];
                     });
    for (const auto& r : s.found)
        out.rec.insert(out.rec.end(), r.begin(), r.end());
}

}  // namespace

// Fills the probe table: 2 << bits uint64 words, a (hash, start << 32 |
// count) pair a slot, for the distinct values of the sorted `hashes`.
// The caller sizes 1 << bits to at least twice the distinct values.
extern "C" void seedmap_build_table(const uint64_t* hashes, int64_t n,
                                    uint64_t* table, int bits)
{
    const uint64_t slots = 1ULL << bits;
    const uint64_t mask = slots - 1;
    for (uint64_t s = 0; s < slots; ++s) {
        table[2 * s] = EMPTY;
        table[2 * s + 1] = 0;
    }
    for (int64_t i = 0; i < n;) {
        int64_t j = i + 1;
        while (j < n && hashes[j] == hashes[i])
            ++j;
        uint64_t s = slot_of(hashes[i], bits);
        while (table[2 * s] != EMPTY)
            s = (s + 1) & mask;
        table[2 * s] = hashes[i];
        table[2 * s + 1] = ((uint64_t)i << 32) | (uint64_t)(j - i);
        i = j;
    }
}

// Looks up n_reads reads (codes joined, each at offsets[r] for
// lengths[r] bases) and returns a handle to the result, with its
// cluster and anchor counts in out_counts[0..2); seedmap_fetch copies
// it out and frees it.
extern "C" void* seedmap_lookup(
    const int8_t* codes, const int64_t* offsets, const int64_t* lengths,
    int64_t n_reads, const uint64_t* table, int bits,
    const int32_t* ref_ids, const int32_t* positions, const int8_t* strands,
    int k, int w, int64_t radius, int64_t min_hits, int n_threads,
    int64_t* out_counts)
{
    const Ctx c{codes, offsets, lengths, table, bits, ref_ids, positions,
                strands, k, w, radius, min_hits};
    int64_t total = 0;
    for (int64_t r = 0; r < n_reads; ++r)
        total += lengths[r];
    // a thread for every 256 kbp at most: a short batch stays inline
    const int64_t T = std::max<int64_t>(1, std::min<int64_t>(
        std::min<int64_t>(n_threads, n_reads), total / (1 << 18)));
    // contiguous runs of reads with about equal bases
    std::vector<int64_t> cut(T + 1, n_reads);
    cut[0] = 0;
    for (int64_t r = 0, t = 1, acc = 0; r < n_reads && t < T; ++r) {
        acc += lengths[r];
        if (acc * T >= total * t)
            cut[t++] = r + 1;
    }
    auto* parts = new std::vector<Part>(T);
    auto work = [&c, &cut, parts](int64_t t) {
        Scratch s;
        for (int64_t r = cut[t]; r < cut[t + 1]; ++r)
            map_read(c, r, s, (*parts)[t]);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < T; ++t)
            pool.emplace_back(work, t);
        for (auto& th : pool)
            th.join();
    }
    out_counts[0] = out_counts[1] = 0;
    for (const auto& p : *parts) {
        out_counts[0] += (int64_t)p.rec.size() / REC;
        out_counts[1] += (int64_t)p.anchors_read.size();
    }
    return parts;
}

// Copies a seedmap_lookup result into (n_clusters, 9) int64 records
// (read index, ref id, reverse, read start, read end, ref start, ref
// end, hits, anchor offset) and the flat int32 anchors, then frees it.
// Null outputs only free it.
extern "C" void seedmap_fetch(void* handle, int64_t* rec,
                              int32_t* anchors_read, int32_t* anchors_ref)
{
    auto* parts = static_cast<std::vector<Part>*>(handle);
    if (rec != nullptr && anchors_read != nullptr && anchors_ref != nullptr) {
        int64_t base = 0;
        for (const auto& p : *parts) {
            for (size_t i = 0; i < p.rec.size(); i += REC) {
                std::copy(p.rec.begin() + i, p.rec.begin() + i + REC, rec);
                rec[REC - 1] += base;
                rec += REC;
            }
            std::copy(p.anchors_read.begin(), p.anchors_read.end(),
                      anchors_read + base);
            std::copy(p.anchors_ref.begin(), p.anchors_ref.end(),
                      anchors_ref + base);
            base += (int64_t)p.anchors_read.size();
        }
    }
    delete parts;
}
