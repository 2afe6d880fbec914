"""Minimiser sketching, reference index, and candidate-window seeding.

Replaces the reference's vendored minimap 0.2 (ref unicycler/src/minimap/*,
mm_sketch/mm_idx_gen/mm_map_file) plus the nanoflann line-tracing stage
(ref src/semi_global_align.cpp:350-427). Exact minimap parity is not
required (SURVEY.md §7.3): downstream banded DP only needs candidate
reference windows plus a rough diagonal corridor, which diagonal-binned
minimiser hits provide directly.

Host code: reference sets are a few MB and the index build is a sort. A
lookup runs as one native pass over its reads (native/seedmap.cpp) with a
numpy formulation as the fallback. The output feeds the device banded-DP
kernel in ops/banded.py.
"""

import threading
from typing import List, NamedTuple

import numpy as np

from ..utils import trace

# minimap-style invertible hash on 2k-bit integers (public-domain finaliser
# mix, same family as minimap's hash64).
def _hash64(x: np.ndarray, mask: np.int64) -> np.ndarray:
    x = x.astype(np.uint64)
    m = np.uint64(mask)
    x = (~x + (x << np.uint64(21))) & m
    x = x ^ (x >> np.uint64(24))
    x = (x + (x << np.uint64(3)) + (x << np.uint64(8))) & m
    x = x ^ (x >> np.uint64(14))
    x = (x + (x << np.uint64(2)) + (x << np.uint64(4))) & m
    x = x ^ (x >> np.uint64(28))
    x = (x + (x << np.uint64(31))) & m
    return x


def _kmer_codes(codes: np.ndarray, k: int):
    """Packed 2-bit k-mer integers for every position; invalid where any
    base is non-ACGT. Returns (kmers uint64 (n-k+1,), valid bool)."""
    n = len(codes)
    if n < k:
        return (np.zeros(0, np.uint64), np.zeros(0, bool))
    c = codes.astype(np.uint64)
    bad = codes > 3
    # rolling pack via cumulative shifts
    kmers = np.zeros(n - k + 1, np.uint64)
    valid = np.ones(n - k + 1, bool)
    for off in range(k):
        kmers = (kmers << np.uint64(2)) | c[off:n - k + 1 + off]
        valid &= ~bad[off:n - k + 1 + off]
    return kmers, valid


def _revcomp_kmers(kmers: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of packed k-mers."""
    comp = ~kmers  # complement of 2-bit codes (A<->T, C<->G under 0..3)
    out = np.zeros_like(kmers)
    for _ in range(k):
        out = (out << np.uint64(2)) | (comp & np.uint64(3))
        comp >>= np.uint64(2)
    return out & np.uint64((1 << (2 * k)) - 1)


class Minimizers(NamedTuple):
    hashes: np.ndarray   # uint64 canonical hashed minimiser values
    pos: np.ndarray      # int32 k-mer start position (on the + strand)
    strand: np.ndarray   # int8: 0 if canonical = forward k-mer, 1 if reverse


def sketch(codes: np.ndarray, k: int, w: int) -> Minimizers:
    """(w,k)-minimisers of one sequence (semantics of minimap's mm_sketch:
    canonical strand-aware k-mer hashing, window minima, no duplicates for
    strand-ambiguous k-mers). Native single-pass implementation
    (native/sketch.cpp) when available; this numpy formulation is the
    semantic oracle it is pinned against (tests/test_native_seed.py
    fuzz; batch sketching in tests/test_minimizer_batch.py)."""
    if k < 32:
        from ..native import native_sketch
        nat = native_sketch(codes, k, w)
        if nat is not None:
            return Minimizers(*nat)
    kmers, valid = _kmer_codes(codes, k)
    if len(kmers) == 0:
        return Minimizers(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                          np.zeros(0, np.int8))
    mask = (1 << (2 * k)) - 1
    fwd = _hash64(kmers, mask)
    rev = _hash64(_revcomp_kmers(kmers, k), mask)
    strand = (rev < fwd).astype(np.int8)
    canon = np.where(strand == 1, rev, fwd)
    # ambiguous (palindromic) and invalid k-mers excluded
    ok = valid & (fwd != rev)
    canon = np.where(ok, canon, np.uint64(np.iinfo(np.uint64).max))

    n = len(canon)
    if n <= w:
        sel = np.array([np.argmin(canon)]) if ok.any() else np.zeros(0, np.int64)
    else:
        sel = np.unique(_sliding_argmin(canon, w))
        sel = sel[ok[sel]]
    return Minimizers(canon[sel], sel.astype(np.int32), strand[sel])


def _sliding_argmin(v: np.ndarray, w: int) -> np.ndarray:
    """Leftmost argmin of every length-w sliding window, O(n) via the
    block prefix/suffix-minima trick (np.argmin over a (n, w) stride view
    is O(n*w) and dominated the sketch profile). Exact tie semantics of
    np.argmin: the leftmost minimum wins."""
    n = len(v)
    nw = n - w + 1
    pad = (-n) % w
    inf = v.dtype.type(np.iinfo(v.dtype).max) if v.dtype.kind in 'ui' \
        else np.inf
    A = np.concatenate([v, np.full(pad, inf, v.dtype)]).reshape(-1, w)
    nb = A.shape[0]
    cols = np.arange(w, dtype=np.int64)[None, :]

    # prefix minima/argmin per block (leftmost: update on strictly less)
    P_min = np.minimum.accumulate(A, axis=1)
    prev = np.concatenate([np.full((nb, 1), inf, v.dtype), P_min[:, :-1]],
                          axis=1)
    P_arg = np.maximum.accumulate(np.where(A < prev, cols, -1), axis=1)
    # suffix minima/argmin per block (leftmost: reversed scan with <=)
    R = A[:, ::-1]
    S_min_r = np.minimum.accumulate(R, axis=1)
    prev_r = np.concatenate([np.full((nb, 1), inf, v.dtype),
                             S_min_r[:, :-1]], axis=1)
    S_arg_r = np.maximum.accumulate(np.where(R <= prev_r, cols, -1), axis=1)
    S_min = S_min_r[:, ::-1]
    S_arg = (w - 1) - S_arg_r[:, ::-1]

    g = np.arange(nw, dtype=np.int64)
    q, r = g // w, g % w
    svals = S_min[q, r]
    sarg = q * w + S_arg[q, r]
    has_p = r > 0
    q1 = np.minimum(q + 1, nb - 1)
    r1 = np.maximum(r - 1, 0)
    pvals = np.where(has_p, P_min[q1, r1], inf)
    parg = (q + 1) * w + P_arg[q1, r1]
    return np.where(svals <= pvals, sarg, parg)


def _sketch_joined(joined, offsets, lengths, gap, k, w):
    """sketch() over many sequences concatenated with `gap` invalid
    bases between them: identical minimisers to per-sequence sketching,
    because only windows lying fully inside one sequence's valid k-mer
    range may select (boundary-spanning windows would otherwise emit
    partial-window minima that per-sequence sketching never produces)."""
    kmers, valid = _kmer_codes(joined, k)
    n = len(kmers)
    empty = Minimizers(np.zeros(0, np.uint64), np.zeros(0, np.int32),
                       np.zeros(0, np.int8))
    if n <= w:
        return empty
    mask = (1 << (2 * k)) - 1
    fwd = _hash64(kmers, mask)
    rev = _hash64(_revcomp_kmers(kmers, k), mask)
    strand = (rev < fwd).astype(np.int8)
    canon = np.where(strand == 1, rev, fwd)
    ok = valid & (fwd != rev)
    canon = np.where(ok, canon, np.uint64(np.iinfo(np.uint64).max))

    # read id per k-mer start; k-mers touching a separator get -1
    n_reads = len(offsets)
    counts_valid = np.maximum(lengths - k + 1, 0)
    counts_rest = (lengths + gap) - counts_valid
    rid = np.repeat(
        np.stack([np.arange(n_reads, dtype=np.int64),
                  np.full(n_reads, -1, np.int64)], 1).ravel(),
        np.stack([counts_valid, counts_rest], 1).ravel())[:n]

    args = _sliding_argmin(canon, w)
    win_ids = rid[:n - w + 1]
    win_ok = (win_ids >= 0) & (rid[w - 1:n] == win_ids)
    if not win_ok.any():
        return empty
    sel = np.unique(args[win_ok])
    sel = sel[ok[sel]]
    return Minimizers(canon[sel], sel.astype(np.int32), strand[sel])


class SeedHitCluster(NamedTuple):
    """A candidate alignment region: read vs one reference strand."""
    ref_id: int
    rev_comp: bool       # read aligns to reference reverse strand
    read_start: int      # positions on the aligned-orientation read
    read_end: int
    ref_start: int
    ref_end: int
    n_hits: int
    anchors_read: np.ndarray   # int32 sorted anchor positions (read)
    anchors_ref: np.ndarray    # int32 anchor positions (ref)


_INDEX_CACHE = {}
_PROBE_LOCK = threading.Lock()


def get_cached_index(ref_codes_list, k, w):
    """A MinimizerIndex for these reference code arrays, memoised by
    array identity: the pipeline aligns against the same reference set
    repeatedly (per sensitivity level, per bridging stage), and the
    index build is a non-trivial host cost."""
    key = (tuple(id(c) for c in ref_codes_list), k, w)
    hit = _INDEX_CACHE.get(key)
    if hit is None:
        idx = MinimizerIndex(ref_codes_list, k=k, w=w)
        if len(_INDEX_CACHE) > 8:
            _INDEX_CACHE.clear()
        # the cached entry PINS the code arrays so their ids cannot be
        # recycled to a different array while the entry lives
        _INDEX_CACHE[key] = (idx, list(ref_codes_list))
        return idx
    return hit[0]


class MinimizerIndex(object):
    """Sorted-array minimiser index over a set of reference sequences."""

    def __init__(self, ref_codes_list: List[np.ndarray], k: int = 15,
                 w: int = 10):
        self.k = k
        self.w = w
        self.ref_lengths = np.array([len(c) for c in ref_codes_list],
                                    dtype=np.int64)
        hashes, ref_ids, positions, strands = [], [], [], []
        for rid, codes in enumerate(ref_codes_list):
            mins = sketch(codes, k, w)
            hashes.append(mins.hashes)
            positions.append(mins.pos)
            strands.append(mins.strand)
            ref_ids.append(np.full(len(mins.pos), rid, np.int32))
        h = np.concatenate(hashes) if hashes else np.zeros(0, np.uint64)
        order = np.argsort(h, kind='stable')
        self.hashes = h[order]
        self.ref_ids = np.concatenate(ref_ids)[order] if ref_ids else \
            np.zeros(0, np.int32)
        self.positions = np.concatenate(positions)[order] if positions else \
            np.zeros(0, np.int32)
        self.strands = np.concatenate(strands)[order] if strands else \
            np.zeros(0, np.int8)
        # Occurrence cap: drop hyper-repetitive minimisers (top fraction),
        # minimap's -f equivalent.
        if len(self.hashes):
            uniq, counts = np.unique(self.hashes, return_counts=True)
            if len(uniq):
                cap = max(10, int(np.percentile(counts, 99.9)))
                bad = uniq[counts > cap]
                keep = ~np.isin(self.hashes, bad)
                self.hashes = self.hashes[keep]
                self.ref_ids = self.ref_ids[keep]
                self.positions = self.positions[keep]
                self.strands = self.strands[keep]

    def lookup(self, read_codes: np.ndarray, cluster_radius: int = 500,
               min_hits: int = 3) -> List[SeedHitCluster]:
        """Find candidate clusters of colinear minimiser hits.

        Hits are binned by diagonal per (ref, relative strand); bins within
        cluster_radius merge (the analog of minimap's radius clustering,
        ref src/minimap/map.cpp, and of the reference's line tracing).
        The native pass of lookup_many over this one read, or its numpy
        fallback (_lookup_numpy).
        """
        got = self._lookup_native([read_codes], cluster_radius, min_hits)
        if got is not None:
            return got[0]
        trace.add('seed.python_reads', 1)
        return self._lookup_numpy(read_codes, cluster_radius, min_hits)

    def lookup_many(self, code_arrays, cluster_radius: int = 500,
                    min_hits: int = 3):
        """lookup() of every sequence, as a list of cluster lists, one per
        input. One native call (native/seedmap.cpp) sketches, probes,
        expands and clusters the whole set, over threads and without the
        GIL, so no sequence pays a Python or ctypes call of its own; the
        index probe is a hash table built once per index, one cache miss
        a minimiser where searchsorted's binary search missed at each
        step. Without the native library, or at k >= 32 (sketch.cpp holds
        a k-mer in one uint64), the numpy formulation runs:
        _lookup_many_numpy, one joined sketch and probe with a clustering
        loop per sequence. Both give the clusters of per-read lookup()
        exactly, in the same order."""
        if not code_arrays:
            return []
        got = self._lookup_native(code_arrays, cluster_radius, min_hits)
        if got is not None:
            return got
        trace.add('seed.python_reads', len(code_arrays))
        return self._lookup_many_numpy(code_arrays, cluster_radius, min_hits)

    def _native_probe(self):
        """(table, bits, ref_ids, positions, strands) for native_seedmap,
        built on the first lookup and kept on the index; None without the
        native library."""
        probe = getattr(self, '_probe', None)
        if probe is None:
            from ..native import native_seed_table
            with _PROBE_LOCK:       # pool threads share a cached index
                probe = getattr(self, '_probe', None)
                if probe is None:
                    table = native_seed_table(self.hashes)
                    if table is None:
                        return None
                    probe = self._probe = table + (
                        np.ascontiguousarray(self.ref_ids, np.int32),
                        np.ascontiguousarray(self.positions, np.int32),
                        np.ascontiguousarray(self.strands, np.int8))
        return probe

    def _lookup_native(self, code_arrays, cluster_radius, min_hits):
        """lookup() of every sequence in one native call, or None where
        the native pass cannot run."""
        if self.k >= 32:
            return None
        probe = self._native_probe()
        if probe is None:
            return None
        from ..native import native_seedmap
        lengths = np.fromiter(map(len, code_arrays), np.int64,
                              len(code_arrays))
        offsets = np.cumsum(lengths) - lengths
        joined = code_arrays[0] if len(code_arrays) == 1 else \
            np.concatenate(code_arrays)
        got = native_seedmap(joined, offsets, lengths, probe, self.k,
                             self.w, cluster_radius, min_hits)
        if got is None:
            return None
        trace.add('seed.native_reads', len(code_arrays))
        rec, anchors_read, anchors_ref = got
        out = [[] for _ in code_arrays]
        for ri, rid, rev, rs, re_, ts, te, n, off in rec.tolist():
            out[ri].append(SeedHitCluster(
                ref_id=rid, rev_comp=rev == 1, read_start=rs, read_end=re_,
                ref_start=ts, ref_end=te, n_hits=n,
                anchors_read=anchors_read[off:off + n],
                anchors_ref=anchors_ref[off:off + n]))
        return out

    def _lookup_numpy(self, read_codes, cluster_radius, min_hits):
        """lookup() in numpy: the fallback of the native pass."""
        read_len = len(read_codes)
        mins = sketch(read_codes, self.k, self.w)
        if len(mins.hashes) == 0:
            return []
        lo = np.searchsorted(self.hashes, mins.hashes, side='left')
        hi = np.searchsorted(self.hashes, mins.hashes, side='right')
        counts = hi - lo
        if counts.sum() == 0:
            return []
        # expand matches
        read_idx = np.repeat(np.arange(len(mins.hashes)), counts)
        flat = _expand_ranges(lo, counts)
        r_pos = mins.pos[read_idx]
        r_str = mins.strand[read_idx]
        t_ids = self.ref_ids[flat]
        t_pos = self.positions[flat]
        t_str = self.strands[flat]
        return self._cluster_hits(read_len, r_pos, r_str, t_ids, t_pos,
                                  t_str, cluster_radius, min_hits)

    def _lookup_many_numpy(self, code_arrays, cluster_radius, min_hits):
        """lookup_many() in numpy, with ONE batched sketch and index
        probe: the sequences join with >= w invalid bases between them
        (each invalid base voids k >= w consecutive k-mers, so no window
        can carry a minimiser across a boundary), minimisers map back to
        their sequence by offset, and only the per-sequence diagonal
        clustering stays in the loop."""
        k, w = self.k, self.w
        out = [[] for _ in code_arrays]
        gap = max(1, w)
        sep = np.full(gap, 4, np.int8)
        parts, offsets, off = [], [], 0
        short = []          # too few k-mers for any full window
        for ri, codes in enumerate(code_arrays):
            offsets.append(off)
            parts.append(codes)
            parts.append(sep)
            off += len(codes) + gap
            if len(codes) - k + 1 < w:
                short.append(ri)
        offsets = np.array(offsets, np.int64)
        joined = np.concatenate(parts)
        mins = _sketch_joined(joined, offsets,
                              np.array([len(c) for c in code_arrays],
                                       np.int64), gap, k, w)
        for ri in short:    # per-read special case (< w k-mers)
            out[ri] = self._lookup_numpy(code_arrays[ri], cluster_radius,
                                         min_hits)
        if len(mins.hashes) == 0:
            return out
        seq_of = np.searchsorted(offsets, mins.pos, side='right') - 1
        local_pos = (mins.pos - offsets[seq_of]).astype(np.int32)
        lo = np.searchsorted(self.hashes, mins.hashes, side='left')
        hi = np.searchsorted(self.hashes, mins.hashes, side='right')
        counts = hi - lo
        if counts.sum() == 0:
            return out
        read_idx = np.repeat(np.arange(len(mins.hashes)), counts)
        flat = _expand_ranges(lo, counts)
        seq_ids = seq_of[read_idx]
        r_pos = local_pos[read_idx]
        r_str = mins.strand[read_idx]
        t_ids = self.ref_ids[flat]
        t_pos = self.positions[flat]
        t_str = self.strands[flat]
        order = np.argsort(seq_ids, kind='stable')
        bounds = np.searchsorted(seq_ids[order], np.arange(
            len(code_arrays) + 1))
        for si in range(len(code_arrays)):
            sl = order[bounds[si]:bounds[si + 1]]
            if len(sl) < min_hits:
                continue
            out[si] = self._cluster_hits(
                len(code_arrays[si]), r_pos[sl], r_str[sl], t_ids[sl],
                t_pos[sl], t_str[sl], cluster_radius, min_hits)
        return out

    def _cluster_hits(self, read_len, r_pos, r_str, t_ids, t_pos, t_str,
                      cluster_radius, min_hits):
        rev = (r_str != t_str)  # relative strand

        clusters = []
        for rid in np.unique(t_ids):
            for is_rev in (False, True):
                m = (t_ids == rid) & (rev == is_rev)
                if np.count_nonzero(m) < min_hits:
                    continue
                rp = r_pos[m].astype(np.int64)
                tp = t_pos[m].astype(np.int64)
                if is_rev:
                    # orient read positions onto the reverse strand so the
                    # alignment is (revcomp read) vs forward ref
                    rp = read_len - (rp + self.k)
                diag = tp - rp
                order = np.argsort(diag, kind='stable')
                rp, tp, diag = rp[order], tp[order], diag[order]
                # split where diagonal jumps exceed the radius
                breaks = np.nonzero(np.diff(diag) > cluster_radius)[0] + 1
                for seg in np.split(np.arange(len(diag)), breaks):
                    if len(seg) < min_hits:
                        continue
                    srp, stp = rp[seg], tp[seg]
                    o2 = np.argsort(srp, kind='stable')
                    srp, stp = srp[o2], stp[o2]
                    # longest nondecreasing subsequence in ref positions ->
                    # colinear chain (replaces SeqAn chainSeedsGlobally)
                    chain = _lis_indices(stp)
                    if len(chain) < min_hits:
                        continue
                    srp, stp = srp[chain], stp[chain]
                    clusters.append(SeedHitCluster(
                        ref_id=int(rid), rev_comp=bool(is_rev),
                        read_start=int(srp[0]), read_end=int(srp[-1]) + self.k,
                        ref_start=int(stp[0]), ref_end=int(stp[-1]) + self.k,
                        n_hits=len(chain),
                        anchors_read=srp.astype(np.int32),
                        anchors_ref=stp.astype(np.int32)))
        clusters.sort(key=lambda c: -c.n_hits)
        return clusters


_FINE_INDEX_CACHE = {}   # (id(codes), k) -> (codes keepalive, ck_sorted)


def get_fine_index(codes: np.ndarray, k: int) -> np.ndarray:
    """Sorted composite-key fine-anchor index of a full reference sequence,
    memoised by array identity. Each entry is (kmer << 32) | position, so
    one sorted uint64 array answers "occurrences of kmer K inside window
    [a, b)" with two searchsorted probes — no per-task re-sort of the
    reference window (the round-1 seeding hot spot). Invalid k-mers
    (non-ACGT bases) sort to the top and can never match a query
    (queries have kmer < 2**(2k) <= 2**32)."""
    key = (id(codes), k)
    ent = _FINE_INDEX_CACHE.get(key)
    if ent is not None and ent[0] is codes:
        return ent[1]
    rk, rv = _kmer_codes(codes, k)
    ck = ((rk << np.uint64(32))
          | np.arange(len(rk), dtype=np.uint64))
    ck = np.where(rv, ck, np.uint64(np.iinfo(np.uint64).max))
    ck.sort()
    if len(_FINE_INDEX_CACHE) > 64:
        _FINE_INDEX_CACHE.clear()
    _FINE_INDEX_CACHE[key] = (codes, ck)
    return ck


_QUERY_KMER_CACHE = {}   # (id(codes), k) -> (codes keepalive, kmers, valid)


def _cached_query_kmers(codes: np.ndarray, k: int):
    key = (id(codes), k)
    ent = _QUERY_KMER_CACHE.get(key)
    if ent is not None and ent[0] is codes:
        return ent[1], ent[2]
    qk, qv = _kmer_codes(codes, k)
    if len(_QUERY_KMER_CACHE) > 16:
        _QUERY_KMER_CACHE.clear()
    _QUERY_KMER_CACHE[key] = (codes, qk, qv)
    return qk, qv


_BASE_RANGE_CACHE = {}


def _get_base_ranges(qk, qck, ck):
    """Full occurrence-list bounds [lo0, hi0) of every query k-mer in
    the composite fine index, computed once per (read, reference) and
    reused by every windowed task of that pair (the repeated full-index
    binary searches dominated collect_common_kmers when one read seeds
    several tasks). hi_add=0xFFFFFFFF bounds the position field, which
    never reaches 2^32-1."""
    key = (id(qk), id(ck))
    ent = _BASE_RANGE_CACHE.get(key)
    if ent is not None and ent[0] is qk and ent[1] is ck:
        return ent[2], ent[3]
    from ..native import native_window_ranges
    ranges = native_window_ranges(ck, qck, 0, 0xFFFFFFFF)
    if ranges is None:
        return None
    if len(_BASE_RANGE_CACHE) > 64:
        _BASE_RANGE_CACHE.clear()
    _BASE_RANGE_CACHE[key] = (qk, ck, ranges[0], ranges[1])
    return ranges


def collect_common_kmers(q_codes: np.ndarray, r_codes: np.ndarray,
                         line_read: np.ndarray, line_ref: np.ndarray,
                         k: int = 10, max_dist: int = 100,
                         max_occ: int = 64,
                         window=None):
    """Fine anchor pass: all common k-mers between read and reference window
    that lie within max_dist of the coarse seed line, colinearised by LIS.

    This is the TPU-pipeline analog of the reference's common-kmer collection
    + trace-line filtering (ref src/semi_global_align.cpp:197-253 with
    TRACE_LINE_COLLECTION_DISTANCE, settings.h:50): dense k=10 anchors make
    the banded corridor hug the true alignment path, where sparse minimisers
    alone would drift. Returns (anchors_read, anchors_ref) int32 arrays.

    When ``window=(start, end)`` is given, ``r_codes`` must be the FULL
    reference array: the windowed occurrences come from the memoised
    composite index (get_fine_index) and returned ref positions are
    window-relative — identical output to slicing, without the per-task
    sort of the window's k-mers.
    """
    qk, qv = _cached_query_kmers(q_codes, k)
    if len(qk) == 0 or len(r_codes) < k:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    if window is not None:
        w0, w1 = window
        ck = get_fine_index(r_codes, k)
        qck = qk << np.uint64(32)
        from ..native import (native_window_ranges,
                              native_window_ranges_bounded)
        base = _get_base_ranges(qk, qck, ck)
        ranges = None
        if base is not None:
            ranges = native_window_ranges_bounded(
                ck, base[0], base[1], qck, max(w0, 0),
                max(w1 - k + 1, 0))
        if ranges is None:
            ranges = native_window_ranges(ck, qck, max(w0, 0),
                                          max(w1 - k + 1, 0))
        if ranges is not None:
            lo, hi = ranges
        else:
            lo = np.searchsorted(ck, qck | np.uint64(max(w0, 0)),
                                 side='left')
            hi = np.searchsorted(ck, qck | np.uint64(max(w1 - k + 1, 0)),
                                 side='left')
        counts = np.where(qv, hi - lo, 0)
        counts = np.minimum(counts, max_occ)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        read_pos = np.repeat(np.arange(len(qk), dtype=np.int64), counts)
        ref_pos = (ck[_expand_ranges(lo, counts)]
                   & np.uint64(0xFFFFFFFF)).astype(np.int64) - w0
    else:
        rk, rv = _kmer_codes(r_codes, k)
        rk = np.where(rv, rk, np.uint64(np.iinfo(np.uint64).max))
        order = np.argsort(rk, kind='stable')
        rk_sorted = rk[order]
        r_pos_sorted = order.astype(np.int64)
        lo = np.searchsorted(rk_sorted, qk, side='left')
        hi = np.searchsorted(rk_sorted, qk, side='right')
        counts = np.where(qv, hi - lo, 0)
        counts = np.minimum(counts, max_occ)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        read_pos = np.repeat(np.arange(len(qk), dtype=np.int64), counts)
        ref_pos = r_pos_sorted[_expand_ranges(lo, counts)]
    # keep hits near the coarse line
    if len(line_read) >= 2:
        expected = np.interp(read_pos, line_read.astype(np.float64),
                             line_ref.astype(np.float64))
        # slope-1 extrapolation beyond the line's span
        below = read_pos < line_read[0]
        above = read_pos > line_read[-1]
        expected[below] = line_ref[0] - (line_read[0] - read_pos[below])
        expected[above] = line_ref[-1] + (read_pos[above] - line_read[-1])
        near = np.abs(ref_pos - expected) <= max_dist
        read_pos, ref_pos = read_pos[near], ref_pos[near]
    if len(read_pos) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    o2 = np.lexsort((ref_pos, read_pos))
    read_pos, ref_pos = read_pos[o2], ref_pos[o2]
    chain = _lis_indices(ref_pos)
    return (read_pos[chain].astype(np.int32), ref_pos[chain].astype(np.int32))


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Vectorised concat of [arange(s, s+c) for s, c in zip(starts,
    counts)] — the hit-expansion hot path (a Python loop of aranges costs
    ~1 ms per thousand entries; this is pure numpy)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = starts.astype(np.int64)
    counts = counts.astype(np.int64)
    offsets = np.cumsum(counts) - counts            # exclusive prefix sum
    return (np.repeat(starts - offsets, counts)
            + np.arange(total, dtype=np.int64))


def _lis_indices(values: np.ndarray) -> np.ndarray:
    """Indices of a longest nondecreasing subsequence (O(n log n));
    native implementation (native/lis.cpp) with a Python fallback."""
    n = len(values)
    if n == 0:
        return np.zeros(0, np.int64)
    from ..native import native_lis
    out = native_lis(values)
    if out is not None:
        return out
    tails = []          # last value of LIS of each length
    tails_idx = []
    parent = np.full(n, -1, np.int64)
    import bisect
    for i in range(n):
        v = values[i]
        j = bisect.bisect_right(tails, v)
        if j == len(tails):
            tails.append(v)
            tails_idx.append(i)
        else:
            tails[j] = v
            tails_idx[j] = i
        parent[i] = tails_idx[j - 1] if j > 0 else -1
    out = []
    i = tails_idx[-1]
    while i >= 0:
        out.append(i)
        i = parent[i]
    return np.array(out[::-1], np.int64)
