"""Short-read de Bruijn graph assembly (the SPAdes role; a copy of
unicycler_tpu/asm/debruijn.py, host numpy).

The reference outsources short-read assembly to the SPAdes subprocess
(ref unicycler/spades_func.py:32-459); full capability parity requires an
in-framework assembler (SURVEY.md §7.10). This module implements:

  * odd-k selection from the read-length median using the reference's
    nonlinear spacing rule (ref spades_func.py:337-406)
  * canonical k-mer counting (numpy sort/unique — the classic
    sort/segment-reduce formulation that also maps directly onto TPU; the
    host path is used while read volumes stay in the tens of millions)
  * de Bruijn graph construction over (k-1)-mer nodes, unitig compaction,
    tip clipping and low-coverage k-mer filtering
  * per-k graph scoring 1 / (contigs * (dead_ends + 2)) and best-k choice
    (ref spades_func.py:32-161)
  * insert-size estimation from read-pair placements on unitigs

Output is an AssemblyGraph-compatible GFA (S lines with dp: depths,
L lines with (k-1)M overlaps, P lines carrying the paired-end resolved
paths from resolve_paths_with_pairs — the contigs.paths role that feeds
SpadesContigBridge and loop unrolling). Reads pass through the
k-mer-spectrum corrector (asm/correct.py) first unless --no_correct.

Aggressive repeat resolution is decided per call: the functions that
depend on it take `aggressive`, and build_best_short_read_graph sets it
from --aggressive_resolution or UNICYCLER_TPU_AGGRESSIVE=1, read when
the call starts (the JAX package keeps it in a module global that one
aggressive run leaves set for the rest of the process).
"""

import os
from collections import defaultdict

import numpy as np

from .. import log
from ..io.fastx import decode_sequence, encode_sequence, load_long_reads
from ..misc import gfa_path, reverse_complement
from ..utils import trace


def aggressive_resolution(args=None):
    """Aggressive repeat resolution (the round-4 "higher-k thread
    resolution" bundle: the k' > best_k ladder, interleaved thread/pair
    splitting with mid-resolution simplification, 80k pair votes,
    conflicted-mate rescue), for one call. DEFAULT OFF: measured on
    sample_data it welds DIVERGED HOMOLOGS — plasmid E's unique region
    took plasmid A's variant at 5 sites and surviving plasmid-A errors
    went 66 -> 1797 — while the conservative path reproduces the
    reference-grade 66-error assembly. Opt in with
    --aggressive_resolution (or UNICYCLER_TPU_AGGRESSIVE=1) when
    contiguity matters more than per-copy variant fidelity."""
    return bool(getattr(args, 'aggressive_resolution', False)) \
        or os.environ.get('UNICYCLER_TPU_AGGRESSIVE') == '1'


def get_kmer_range(read_lengths, kmer_count=8, min_kmer_frac=0.2,
                   max_kmer_frac=0.95):
    """Odd k values spanning min to max fraction of the median read length
    with nonlinear (quadratic) spacing (ref spades_func.py:337-406)."""
    read_lengths = sorted(read_lengths)
    median_read_length = read_lengths[len(read_lengths) // 2 - 1]
    max_kmer = round_to_nearest_odd(max_kmer_frac * median_read_length)
    max_kmer = min(max_kmer, 127)
    starting_kmer = round_to_nearest_odd(
        min_kmer_frac * max_kmer / max_kmer_frac)
    starting_kmer = max(starting_kmer, 11)
    if kmer_count == 1:
        return [max_kmer]
    kmer_range = []
    for x in [x / (kmer_count - 1) for x in range(kmer_count)]:
        kmer_range.append(starting_kmer
                          + ((max_kmer - starting_kmer) * (x ** 2)))
    kmer_range = sorted(set(round_to_nearest_odd(x) for x in kmer_range))
    return [k for k in kmer_range if 11 <= k <= 127]


def round_to_nearest_odd(num):
    num = int(round(num))
    return num if num % 2 == 1 else num - 1


def _void_view(matrix: np.ndarray) -> np.ndarray:
    """Rows of a (m, k) uint8 matrix as comparable fixed-width scalars."""
    m = np.ascontiguousarray(matrix)
    return m.view(np.dtype((np.void, m.shape[1]))).ravel()


def _kmer_matrix(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid k-mers of a code array as a (m, k) uint8 matrix.
    Fixed-width byte rows support any k (packed uint64 caps at k=31)."""
    n = len(codes)
    if n < k:
        return np.zeros((0, k), np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(
        codes.astype(np.uint8), k)
    valid = ~(win > 3).any(axis=1)
    return np.ascontiguousarray(win[valid])


_COMP = np.array([3, 2, 1, 0, 4, 5, 6], dtype=np.uint8)


def _revcomp_matrix(matrix: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(_COMP[matrix][:, ::-1])


def _canonical_kmers(codes, k):
    km = _kmer_matrix(codes, k)
    if not len(km):
        return km
    rc = _revcomp_matrix(km)
    # row-wise lexicographic min(km, rc) via first differing column
    neq = km != rc
    any_neq = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    rows = np.arange(len(km))
    fwd_smaller = ~any_neq | (km[rows, first] <= rc[rows, first])
    return np.where(fwd_smaller[:, None], km, rc)


def _joined_chunks(code_arrays, k):
    """Concatenate code arrays with one invalid-code separator between
    them, in bounded-size chunks: windows that span a boundary contain
    the separator (> 3) and are dropped by _kmer_matrix's validity mask,
    so the k-mer set is IDENTICAL to per-array extraction — without a
    Python-level numpy call per read (the round-1 profile spent half the
    assembly stage in 900k per-read _canonical_kmers calls)."""
    sep = np.array([4], np.uint8)
    chunk_bases = max(500_000, 64_000_000 // max(k, 1))
    buf, total = [], 0
    for codes in code_arrays:
        buf.append(codes.astype(np.uint8, copy=False))
        buf.append(sep)
        total += len(codes) + 1
        if total >= chunk_bases:
            yield np.concatenate(buf)
            buf, total = [], 0
    if buf:
        yield np.concatenate(buf)


def count_kmers(read_code_arrays, k, min_count=2, carried=None):
    """Canonical k-mer counts above min_count: returns ((m, k) uint8
    canonical k-mer matrix, counts).

    `carried` is an optional list of (codes, depth) from the PREVIOUS
    (smaller) k's unitigs — SPAdes' iterative-k scheme: their k-mers are
    exempt from the solidity threshold (long contigs already vouched for
    them) and enter with the depth estimated at the previous k, so
    coverage gaps that a smaller k bridged stay connected at larger k."""
    chunks = []
    for codes in _joined_chunks(read_code_arrays, k):
        cm = _canonical_kmers(codes, k)
        if len(cm):
            chunks.append(cm)
    if not chunks:
        uniq_v = np.zeros(0, np.dtype((np.void, k)))
        counts = np.zeros(0, np.int64)
    else:
        all_kmers = np.concatenate(chunks)
        uniq_v, counts = np.unique(_void_view(all_kmers),
                                   return_counts=True)
    keep = counts >= min_count

    if carried:
        ex_chunks, ex_counts = [], []
        for codes, depth in carried:
            cm = _canonical_kmers(codes.astype(np.uint8, copy=False), k)
            if len(cm):
                ex_chunks.append(cm)
                ex_counts.append(np.full(len(cm), max(1, round(depth)),
                                         np.int64))
        if ex_chunks:
            ev = _void_view(np.concatenate(ex_chunks))
            ec = np.concatenate(ex_counts)
            order = np.argsort(ev, kind='stable')
            ev, ec = ev[order], ec[order]
            first = np.concatenate([[True], ev[1:] != ev[:-1]])
            ev, ec = ev[first], np.maximum.reduceat(
                ec, np.nonzero(first)[0])
            pos = np.searchsorted(uniq_v, ev)
            found = (pos < len(uniq_v))
            found[found] &= uniq_v[pos[found]] == ev[found]
            fp = pos[found]
            keep[fp] = True
            counts = counts.copy()
            counts[fp] = np.maximum(counts[fp], ec[found])
            if (~found).any():
                uniq_v = np.concatenate([uniq_v, ev[~found]])
                counts = np.concatenate([counts, ec[~found]])
                keep = np.concatenate(
                    [keep, np.ones(int((~found).sum()), bool)])

    uniq = uniq_v[keep].view(np.uint8).reshape(-1, k)
    return uniq, counts[keep]


class DeBruijnGraph(object):
    """de Bruijn graph over the solid canonical k-mer set; oriented
    k-mers (both strands) indexed by their prefix (k-1)-mer."""

    def __init__(self, kmers, counts, k):
        self.k = k
        rc = _revcomp_matrix(kmers)
        self.oriented = np.concatenate([kmers, rc])
        self.oriented_counts = np.concatenate([counts, counts])
        # drop duplicate orientations (palindromic k-mers)
        v = _void_view(self.oriented)
        _, first_idx = np.unique(v, return_index=True)
        first_idx.sort()
        self.oriented = self.oriented[first_idx]
        self.oriented_counts = self.oriented_counts[first_idx]
        # (k-1)-mer nodes as dense integer ids: degree counts, branch
        # flags, and the unique out-edge are plain arrays, so the unitig
        # walk is O(1) array indexing per step (dict-of-bytes degree
        # maps cost ~50s of tobytes/dict traffic per sample_data run)
        pre_v = _void_view(np.ascontiguousarray(self.oriented[:, :-1]))
        suf_v = _void_view(np.ascontiguousarray(self.oriented[:, 1:]))
        nodes = np.unique(np.concatenate([pre_v, suf_v]))
        self.pre_id = np.searchsorted(nodes, pre_v)
        self.suf_id = np.searchsorted(nodes, suf_v)
        n_nodes = len(nodes)
        out_deg = np.bincount(self.pre_id, minlength=n_nodes)
        in_deg = np.bincount(self.suf_id, minlength=n_nodes)
        self.branchy = (out_deg != 1) | (in_deg != 1)
        self.only_out = np.full(n_nodes, -1, np.int64)
        single = (out_deg == 1)[self.pre_id]
        self.only_out[self.pre_id[single]] = np.nonzero(single)[0]


def build_unitigs(kmers, counts, k):
    """Compact the de Bruijn graph into unitigs: list of
    (sequence, mean_count)."""
    g = DeBruijnGraph(kmers, counts, k)
    n_edges = len(g.oriented)
    edge_used = np.zeros(n_edges, bool)

    # twin[i] = row of the reverse complement of oriented k-mer i, so a
    # walk consumes both orientations at once (otherwise circular unitigs
    # appear twice as rotated reverse complements).
    all_v = _void_view(g.oriented)
    order = np.argsort(all_v, kind='stable')
    sorted_v = all_v[order]
    rc_v = _void_view(_revcomp_matrix(g.oriented))
    twin = order[np.searchsorted(sorted_v, rc_v)]

    def walk(start_row):
        rows = [start_row]
        edge_used[start_row] = True
        edge_used[twin[start_row]] = True
        cur = g.suf_id[start_row]
        while not g.branchy[cur]:
            r = int(g.only_out[cur])
            if r < 0 or edge_used[r]:
                break
            rows.append(r)
            edge_used[r] = True
            edge_used[twin[r]] = True
            cur = g.suf_id[r]
        return rows

    unitigs = []
    for i in range(n_edges):
        if edge_used[i]:
            continue
        if g.branchy[g.pre_id[i]]:
            unitigs.append(walk(i))
    for i in range(n_edges):       # cycles with no branch points
        if not edge_used[i]:
            unitigs.append(walk(i))

    results = []
    for rows in unitigs:
        bases = list(g.oriented[rows[0]])
        for r in rows[1:]:
            bases.append(g.oriented[r][-1])
        seq = decode_sequence(np.array(bases, np.int8))
        mean_count = float(np.mean(g.oriented_counts[rows]))
        results.append((seq, mean_count))
    return results


def dedupe_unitigs(unitigs):
    """Drop reverse-complement duplicates (each unitig appears once)."""
    seen = {}
    out = []
    for seq, count in sorted(unitigs, key=lambda x: (-len(x[0]), x[0])):
        rc = reverse_complement(seq)
        canonical = min(seq, rc)
        if canonical in seen:
            continue
        seen[canonical] = True
        out.append((seq, count))
    return out


def link_unitigs(unitigs, k):
    """Links between unitigs sharing (k-1)-base overlaps."""
    by_prefix = defaultdict(list)
    for idx, (seq, _) in enumerate(unitigs):
        rc = reverse_complement(seq)
        by_prefix[seq[:k - 1]].append((idx + 1, 1))
        by_prefix[rc[:k - 1]].append((idx + 1, -1))
    links = set()
    for idx, (seq, _) in enumerate(unitigs):
        num = idx + 1
        for start_seq, sign in ((seq, 1), (reverse_complement(seq), -1)):
            tail = start_seq[-(k - 1):]
            for other_num, other_sign in by_prefix.get(tail, []):
                links.add((num * sign, other_num * other_sign))
    return sorted(links)


def assemble_short_reads(read_code_arrays, k, min_count=2, carried=None):
    """One k's assembly: unitigs + links (GFA-style, overlap k-1).
    `carried` = previous k's (codes, depth) unitigs (iterative-k)."""
    with trace.span('count_kmers'):
        kmers, counts = count_kmers(read_code_arrays, k, min_count, carried)
    if len(kmers) == 0:
        return [], []
    with trace.span('unitigs'):
        unitigs = build_unitigs(kmers, counts, k)
        unitigs = dedupe_unitigs(unitigs)
    # Graph cleaning (role of SPAdes' simplification stage):
    #   tips: short, low-coverage unitigs dead on exactly one side
    #   ECs:  short, very-low-coverage unitigs linked on both sides
    #         (erroneous connections between true paths)
    # Islands and everything long or well-covered stay.
    with trace.span('clean_unitigs'):
        return _clean_unitigs(unitigs, k)


def _clean_unitigs(unitigs, k):
    """Up to three rounds of tip and erroneous-connection removal, then
    the links of what stays (assemble_short_reads' cleaning)."""
    for _ in range(3):
        links = link_unitigs(unitigs, k)
        has_out = set(a for a, _ in links)
        median_count = float(np.median([c for _, c in unitigs])) \
            if unitigs else 0.0
        kept = []
        for idx, (seq, count) in enumerate(unitigs):
            num = idx + 1
            out_dead = num not in has_out
            in_dead = -num not in has_out
            if len(seq) < 2 * k:
                if (out_dead != in_dead) and count < median_count / 4:
                    continue                       # tip
                if (not out_dead and not in_dead) \
                        and count < median_count / 10:
                    continue                       # erroneous connection
            kept.append((seq, count))
        if len(kept) == len(unitigs):
            break
        unitigs = kept
    links = link_unitigs(unitigs, k)
    return unitigs, links


def make_carry(strategy, unitigs, links, k_prev, k_next):
    """Carry-strategy dispatch (scripts/carry_lab.py experiments):
    S0 = interior-only, >=2k unitigs (rounds 1-3 behaviour);
    S2 = all interiors + unrestricted junction windows;
    S1 = >=2k interiors + junction windows over TRUSTED paths only."""
    if strategy == 'S0':
        return [(encode_sequence(seq), c) for seq, c in unitigs
                if len(seq) >= 2 * k_prev]
    if strategy == 'S2':
        return build_carry_material(unitigs, links, k_prev, k_next)
    if strategy == 'S1':
        return build_carry_material(unitigs, links, k_prev, k_next,
                                    interior_min_len=2 * k_prev,
                                    trusted_only=True)
    raise ValueError(strategy)


def build_carry_material(unitigs, links, k_prev, k_next,
                         max_windows=120000, per_start_cap=64,
                         interior_min_len=0, trusted_only=False):
    """Carry for the NEXT (larger) k in the iterative-k scheme: unitig
    interiors PLUS junction-spanning windows.

    Carrying unitigs alone (rounds 1-3) leaves every junction of the
    previous graph uncovered at the new k: the (k_next)-mers that span a
    junction exist only in reads, and at k_next near the read length a
    specific spanning k-mer is expected in only ~2 reads — under the
    solidity threshold half the time. Measured on sample_data, that shattered
    the k=119 graph into 229 dead ends while k=93 (whose junctions reads
    still cover) won with 293 contigs. The fix is SPAdes-shaped: for
    every oriented link chain of the previous graph, emit a window of
    the path sequence — the previous unitig's last (k_next-1) bases plus
    (k_next-1) bases of path extension (crossing unitigs shorter than
    k_next entirely) — so every previous junction, and every repeat
    shorter than k_next, is spanned by carried k-mers at the previous
    depth. Windows carry min-depth along their path.
    """
    o = k_prev - 1
    span = k_next - 1
    seqs = {}
    depth = {}
    for idx, (seq, cnt) in enumerate(unitigs):
        seqs[idx + 1] = seq
        seqs[-(idx + 1)] = reverse_complement(seq)
        depth[idx + 1] = cnt

    # Trust gate: error unitigs surviving the k_prev cleaning are short
    # AND shallow; a window through one would carry the error forward
    # forever (carried k-mers are exempt from the solidity threshold, so
    # junk compounds across the k ladder — measured: unrestricted
    # windows ballooned sample_data k=119 from 293 to 3776 contigs).
    # Trusted = long enough to be interior-carried anyway, or at least a
    # quarter of the long-unitig median depth.
    if trusted_only:
        long_depths = [cnt for seq, cnt in unitigs if len(seq) >= 1000]
        floor = 0.25 * (sorted(long_depths)[len(long_depths) // 2]
                        if long_depths else 0.0)
        trusted = set()
        for idx, (seq, cnt) in enumerate(unitigs):
            if len(seq) >= 2 * k_prev or cnt >= floor:
                trusted.add(idx + 1)
    else:
        trusted = None

    fwd = defaultdict(list)
    for a, b in links:
        if trusted is None or (abs(a) in trusted and abs(b) in trusted):
            fwd[a].append(b)

    out = [(encode_sequence(seq), cnt) for seq, cnt in unitigs
           if len(seq) >= interior_min_len]
    n_windows = 0
    for a in sorted(fwd.keys()):
        if n_windows >= max_windows:
            break
        tail = seqs[a][-span:]
        # DFS over extension paths until span bases beyond `a`'s end
        start_budget = per_start_cap
        stack = [(a, tail, 0, depth[abs(a)])]
        while stack and start_budget > 0 and n_windows < max_windows:
            cur, acc, ext, dmin = stack.pop()
            nxts = fwd.get(cur, [])
            if not nxts:
                if ext > 0:                 # partial window still spans
                    out.append((encode_sequence(acc), dmin))
                    n_windows += 1
                    start_budget -= 1
                continue
            for b in nxts:
                add = seqs[b][o:]
                nd = min(dmin, depth[abs(b)])
                if ext + len(add) >= span:
                    out.append((encode_sequence(acc + add[:span - ext]),
                                nd))
                    n_windows += 1
                    start_budget -= 1
                    if start_budget <= 0 or n_windows >= max_windows:
                        break
                else:
                    stack.append((b, acc + add, ext + len(add), nd))
    return out


def save_graph_gfa(unitigs, links, k, filename, paths=None,
                   hk_paths=None):
    """P-line names matter downstream: 'PATH_*' records are paired-end
    resolved paths (insert-size evidence, subject to the reference's
    bridge length penalty); 'HKPATH_*' records are higher-k continuity
    paths (resolve_paths_with_higher_k) whose evidence does not decay
    with bridge length (bridges/spades_contig.py exempts them)."""
    with open(filename, 'w') as gfa:
        for idx, (seq, count) in enumerate(unitigs):
            gfa.write('S\t%d\t%s\tLN:i:%d\tdp:f:%.4f\n'
                      % (idx + 1, seq, len(seq), count))
        for a, b in links:
            gfa.write('L\t%d\t%s\t%d\t%s\t%dM\n'
                      % (abs(a), '+' if a > 0 else '-', abs(b),
                         '+' if b > 0 else '-', k - 1))
        overlap_cigar = '%dM' % (k - 1)
        for prefix, group in (('PATH', paths), ('HKPATH', hk_paths)):
            for i, path in enumerate(group or []):
                gfa.write('P\t%s_%d\t%s\t%s\n' % (
                    prefix, i + 1,
                    ','.join('%d%s' % (abs(x), '+' if x > 0 else '-')
                             for x in path),
                    ','.join([overlap_cigar] * (len(path) - 1))))


def thread_sequence_through(seq, seqs, fwd, concat, starts, sig_at, k):
    """Express `seq` as a walk through the unitig graph by exact
    matching (helper of resolve_paths_with_higher_k). Returns the
    signed path, or None when the anchor is absent/ambiguous or the
    walk cannot be matched. `concat` is the '#'-joined concatenation of
    every oriented unitig sequence, `starts`/`sig_at` map global
    offsets back to (signed unitig, local offset)."""
    import bisect
    o = k - 1
    if len(seq) < o:
        return None
    anchor = seq[:o]
    hits = []
    pos = concat.find(anchor)
    while pos >= 0 and len(hits) <= 64:
        gi = bisect.bisect_right(starts, pos) - 1
        hits.append((sig_at[gi], pos - starts[gi]))
        pos = concat.find(anchor, pos + 1)
    if pos >= 0:
        # Occurrences beyond the (generous) collection cap: a partial
        # hit list could yield a false-unique walk, which
        # split_repeats_with_threads would treat as a conflict-free
        # witness — treat the anchor as ambiguous. The cap must stay
        # high enough to EXHAUST real repeat families (IS elements
        # occur ~10-30 times after split rounds duplicate unitigs):
        # capping at 5 disabled threading exactly at IS anchors and
        # collapsed their copies (measured on sample_data: 66 -> 1797
        # surviving A errors, plasmid E homogenised with A's variant).
        return None
    threads = []
    for start_sig, start_off in hits:
        path = [start_sig]
        u = seqs[start_sig]
        m = min(len(u) - start_off, len(seq))
        if u[start_off:start_off + m] != seq[:m]:
            continue
        spos = m
        ok = True
        while spos < len(seq) and len(path) < 500:
            matches = []
            for nxt in fwd.get(path[-1], ()):
                v = seqs[nxt]
                mm = min(len(v) - o, len(seq) - spos)
                if mm <= 0 or v[o:o + mm] == seq[spos:spos + mm]:
                    matches.append((nxt, max(mm, 0)))
            if len(matches) != 1:
                # dead end or ambiguous remainder: the walk so far is
                # still a valid (truncated) description of seq's prefix
                break
            nxt, mm = matches[0]
            if mm <= 0:
                ok = False          # zero-progress segment: bail out
                break
            path.append(nxt)
            spos += mm
        if ok and len(path) >= 2:
            threads.append(tuple(path))
    threads = set(threads)
    if len(threads) != 1:
        return None
    return list(threads.pop())


def resolve_paths_with_higher_k(unitigs, links, hk_segments, k):
    """Repeat resolution from HIGHER-k graphs (the second half of the
    SPAdes exSPAnder role, complementing the insert-bounded
    resolve_paths_with_pairs): a unitig assembled at k' > k is direct
    read-continuity evidence for a specific walk through the k-graph —
    repeats shorter than k' that k collapsed are spanned outright, with
    no insert-size ceiling. Each high-k segment is threaded through the
    k-graph by exact matching; full-length unambiguous threads become
    contigs.paths-style records (consumed by SpadesContigBridge via
    HKPATH_* P-lines). Chimera guard: a mis-joined high-k unitig either
    fails to thread (its junction is not a k-graph link) or is dropped
    by the caller's depth gate before reaching here."""
    seqs = {}
    for idx, (seq, _cnt) in enumerate(unitigs):
        seqs[idx + 1] = seq
        seqs[-(idx + 1)] = reverse_complement(seq)
    fwd = defaultdict(set)
    for a, b in links:
        fwd[a].add(b)
        fwd[-b].add(-a)
    fwd = {key: sorted(val) for key, val in fwd.items()}
    order = sorted(seqs)
    concat_parts = []
    starts = []
    sig_at = []
    gpos = 0
    for sig in order:
        starts.append(gpos)
        sig_at.append(sig)
        concat_parts.append(seqs[sig])
        gpos += len(seqs[sig]) + 1
    concat = '#'.join(concat_parts)

    paths = []
    seen = set()
    for seq in hk_segments:
        path = thread_sequence_through(seq, seqs, fwd, concat, starts,
                                       sig_at, k)
        if path is None or len(path) < 2:
            continue
        key = tuple(path)
        rkey = tuple(-x for x in reversed(path))
        if key in seen or rkey in seen:
            continue
        seen.add(key)
        paths.append(path)
    return paths


def collect_pair_votes(unitigs, links, pairs_1, pairs_2, k, insert_mean,
                       max_pairs=None, aggressive=False):
    """Insert-implied gap votes between oriented unitigs from placed
    read pairs: votes[(signed_a, signed_b)] = list of gap estimates
    between the END of oriented `a` and the START of oriented `b`
    (mate 1 forward on the fragment, mate 2 reverse). Shared by the
    path resolver and the repeat splitter. Vote volume and the
    conflicted-mate rescue follow `aggressive` (see
    aggressive_resolution)."""
    if max_pairs is None:
        max_pairs = 80000 if aggressive else 20000
    from ..ops.minimizer import MinimizerIndex
    votes = defaultdict(list)
    if not pairs_1 or not pairs_2:
        return votes
    unitig_codes = [encode_sequence(seq) for seq, _ in unitigs]
    lengths = [len(seq) for seq, _ in unitigs]
    index = MinimizerIndex(unitig_codes, k=15, w=5)
    step = max(1, len(pairs_1) // max_pairs)
    sel_1 = pairs_1[::step]
    sel_2 = pairs_2[::step]
    h1_all = index.lookup_many(sel_1, min_hits=2)
    h2_all = index.lookup_many(sel_2, min_hits=2)

    linked_pairs = set()
    for a, b in links:
        linked_pairs.add(frozenset((abs(a), abs(b))))

    def usable(hits):
        # Placement discipline, measured on sample_data k=93:
        # unique-only placement starves votes (63 voting pairs out of
        # 10k — a mate near a junction legitimately hits BOTH flanking
        # unitigs through the k-1 overlap), while accepting any
        # multi-hit poisons them (12/34 "decisive" repeat matches were
        # false — diverged IS copies impersonate adjacency with up to
        # 92 insert-consistent votes). The rule that keeps both
        # properties: a multi-hit mate is usable only when every pair
        # of its hits is GRAPH-ADJACENT (a junction straddle names one
        # genomic locus); hits on unlinked unitigs mean the mate sits
        # in an ambiguous repeat copy and must not vote. Round-4
        # refinement (vote volume was the splitter's limiting factor —
        # 744 votes from 25k pairs left every decisive threshold
        # unreachable): a conflicted mate is RESCUED down to its top
        # hit when that hit decisively outranks the runner-up (>= 3x
        # minimizer hits) — a diverged-IS impersonation scores
        # comparably on both copies and still gets dropped.
        if not hits:
            return ()
        ranked = sorted(hits, key=lambda x: -x.n_hits)[:3]
        floor = max(4, ranked[0].n_hits // 4)
        ranked = [x for x in ranked if x.n_hits >= floor]
        for i in range(len(ranked)):
            for j in range(i + 1, len(ranked)):
                key = frozenset((ranked[i].ref_id + 1,
                                 ranked[j].ref_id + 1))
                if len(key) > 1 and key not in linked_pairs:
                    if aggressive and \
                            ranked[0].n_hits >= 3 * ranked[1].n_hits:
                        # rescue a decisively-ranked conflicted mate —
                        # aggressive mode only: a diverged-homolog
                        # impersonation can outrank 3x and still be the
                        # wrong locus (the plasmid E homogenisation
                        # measured in round 5)
                        return ranked[:1]
                    return ()
        return ranked

    for c1, c2, h1, h2 in zip(sel_1, sel_2, h1_all, h2_all):
        for a in usable(h1):
            for b in usable(h2):
                if a.ref_id == b.ref_id:
                    continue
                signed_a = (a.ref_id + 1) * (-1 if a.rev_comp else 1)
                signed_b = (b.ref_id + 1) * (1 if b.rev_comp else -1)
                # distance from mate-1's position to the oriented end of
                # a, and from b's oriented start to mate-2's
                # fragment-forward start
                la, lb = lengths[a.ref_id], lengths[b.ref_id]
                tail_a = (la - a.ref_start) if not a.rev_comp \
                    else a.ref_end
                head_b = b.ref_start if b.rev_comp else (lb - b.ref_end)
                gap = insert_mean - tail_a - head_b \
                    - (b.read_end - b.read_start)
                votes[(signed_a, signed_b)].append(gap)
                votes[(-signed_b, -signed_a)].append(gap)
    return votes


def split_repeats_with_pairs(unitigs, links, pairs_1, pairs_2, k,
                             insert_mean=250.0, insert_dev=50.0,
                             rounds=3, aggressive=False):
    """Paired-end REPEAT SPLITTING: duplicate collapsed repeat unitigs
    whose in/out neighbours are decisively matched by insert-consistent
    read pairs, so the graph itself simplifies (the graph-transformation
    half of SPAdes' exSPAnder role; the P-line half is
    resolve_paths_with_pairs).

    For a unitig R with in-neighbours I (|I| >= 2) and out-neighbours O
    (|O| = |I|), pairs spanning R vote for (i, o) combinations at gap
    ~ len(R) - 2(k-1). When the votes form a decisive perfect matching
    (every i prefers a distinct o by at least 2x, or is forced by
    elimination after the decisive ones are fixed), R is split into |I|
    copies — one per matched (i, o), each at depth/|I| — and rewired.
    The downstream graph cleaning merges the now-linear chains.
    Repeats longer than the insert reach simply collect no votes and
    stay; no length heuristic is needed. Multiple rounds let chains of
    adjacent repeats resolve one layer at a time (votes are recollected
    each round because splitting renumbers)."""
    total_split = 0
    for _ in range(rounds):
        votes = collect_pair_votes(unitigs, links, pairs_1, pairs_2, k,
                                   insert_mean, aggressive=aggressive)
        if not votes:
            break
        lengths = [len(seq) for seq, _ in unitigs]
        fwd = defaultdict(list)
        for a, b in links:
            fwd[a].append(b)

        def vote_count(i_sig, o_sig, want_gap):
            n = 0.0
            for gap in votes.get((i_sig, o_sig), ()):
                if abs(gap - want_gap) <= 4 * insert_dev + 50:
                    n += 1.0
            return n

        split_plan = []       # (repeat_num, [(i_sig, o_sig), ...])
        used_neighbors = set()
        for idx in range(len(unitigs)):
            num = idx + 1
            ins = sorted(-x for x in fwd.get(-num, []))
            outs = sorted(fwd.get(num, []))
            if len(ins) < 2 or len(ins) != len(outs):
                continue
            if num in [abs(x) for x in ins + outs]:
                continue               # self-adjacent (tandem): skip
            want_gap = lengths[idx] - 2.0 * (k - 1)
            score = {}
            for i_sig in ins:
                for o_sig in outs:
                    score[(i_sig, o_sig)] = vote_count(i_sig, o_sig,
                                                       want_gap)
            # decisive greedy matching + forced completion
            pairs = []
            rem_i, rem_o = list(ins), list(outs)
            progress = True
            while progress and rem_i:
                progress = False
                if len(rem_i) == 1:
                    # forced by elimination (only when something real
                    # anchored the rest of the matching)
                    if pairs:
                        pairs.append((rem_i[0], rem_o[0]))
                        rem_i, rem_o = [], []
                    break
                best = None
                for i_sig in rem_i:
                    ranked = sorted(((score[(i_sig, o_sig)], o_sig)
                                     for o_sig in rem_o), reverse=True)
                    s1, o1 = ranked[0]
                    s2 = ranked[1][0]
                    if s1 >= 3 and s1 >= 2 * max(1.0, s2):
                        if best is None or s1 > best[0]:
                            best = (s1, i_sig, o1)
                if best is not None:
                    _, i_sig, o_sig = best
                    pairs.append((i_sig, o_sig))
                    rem_i.remove(i_sig)
                    rem_o.remove(o_sig)
                    progress = True
            if rem_i or not pairs:
                continue
            # a neighbour may only take part in one split per round
            # (its links are rewired); also skip if any matched
            # neighbour is the repeat of another plan
            nums_involved = {num} | {abs(x) for x, _ in pairs} \
                | {abs(x) for _, x in pairs}
            if nums_involved & used_neighbors:
                continue
            used_neighbors |= nums_involved
            split_plan.append((num, pairs))

        if not split_plan:
            break
        links = _apply_split_plan(unitigs, links, split_plan)
        total_split += len(split_plan)
    return unitigs, links, total_split


def simplify_unitigs(unitigs, links, k, tmp_gfa, depth_filter=0.25,
                     largest_component=False):
    """Merge linear chains (and pop error bulges / clean junk) at the
    unitig level by round-tripping through AssemblyGraph. Run between
    repeat-splitting passes: each split linearises part of a tangle, and
    MERGING the freed chains is what lengthens unitigs enough for the
    next evidence type to place on them (read pairs could not be placed
    on the 185-250 bp tangle segments — mostly k-1 overlap — that the
    pre-merge graph was full of)."""
    from ..graph.assembly_graph import AssemblyGraph
    save_graph_gfa(unitigs, links, k, tmp_gfa)
    graph = AssemblyGraph(tmp_gfa, k - 1)
    pop_graph_bubbles(graph)
    graph.clean(depth_filter, largest_component)
    graph.merge_all_possible(None, 2)
    new_unitigs = []
    remap = {}
    for new_idx, num in enumerate(sorted(graph.segments)):
        seg = graph.segments[num]
        remap[num] = new_idx + 1
        new_unitigs.append((seg.forward_sequence, seg.depth))
    new_links = set()
    for a, bs in graph.forward_links.items():
        if abs(a) not in remap:
            continue
        sa = remap[abs(a)] * (1 if a > 0 else -1)
        for b in bs:
            if abs(b) not in remap:
                continue
            sb = remap[abs(b)] * (1 if b > 0 else -1)
            new_links.add((sa, sb))
            new_links.add((-sb, -sa))
    return new_unitigs, sorted(new_links)


def resolve_repeats(unitigs, links, hk_segments, pairs_1, pairs_2, k,
                    insert_mean, insert_dev, tmp_gfa, depth_filter=0.25,
                    largest_component=False, max_rounds=6,
                    aggressive=False):
    """Interleaved repeat resolution (the exSPAnder role): alternate
    higher-k thread splitting, linear-chain merging, and paired-end
    splitting until a fixed point. The interleaving is the point —
    thread splits resolve sub-k' repeats, merging lengthens the freed
    chains, and the longer unitigs are what make read-pair placement
    (and therefore pair splitting of repeats up to the insert reach)
    possible at all. Returns (unitigs, links, n_thread_splits,
    n_pair_splits)."""
    tot_hk = tot_pairs = 0
    for _ in range(max_rounds):
        unitigs, links, n1 = split_repeats_with_threads(
            unitigs, links, hk_segments, k, rounds=2)
        if n1:
            unitigs, links = simplify_unitigs(unitigs, links, k, tmp_gfa,
                                              depth_filter,
                                              largest_component)
        unitigs, links, n2 = split_repeats_with_pairs(
            unitigs, links, pairs_1, pairs_2, k, insert_mean, insert_dev,
            rounds=1, aggressive=aggressive)
        if n2:
            unitigs, links = simplify_unitigs(unitigs, links, k, tmp_gfa,
                                              depth_filter,
                                              largest_component)
        tot_hk += n1
        tot_pairs += n2
        if n1 + n2 == 0:
            break
    return unitigs, links, tot_hk, tot_pairs


def _apply_split_plan(unitigs, links, split_plan):
    """Apply a repeat-split plan: copy R per matched (in, out) pair,
    rewire links, share R's depth across the copies. Mutates `unitigs`
    in place (first copy reuses R's slot, extras append) and returns the
    new sorted link list."""
    link_set = set(links)
    for num, matched in split_plan:
        idx = num - 1
        seq, depth = unitigs[idx]
        share = depth / len(matched)
        copies = []
        for i_sig, o_sig in matched:
            # remove old links i->R, R->o (both orientations)
            for va, vb in ((i_sig, num), (num, o_sig)):
                link_set.discard((va, vb))
                link_set.discard((-vb, -va))
            copies.append((i_sig, o_sig))
        # drop ALL links touching R (unmatched stray links too)
        link_set = {l for l in link_set
                    if abs(l[0]) != num and abs(l[1]) != num}
        # first copy reuses R's slot, extras append
        slot_nums = [num]
        for _ in range(len(matched) - 1):
            unitigs.append((seq, share))
            slot_nums.append(len(unitigs))
        unitigs[idx] = (seq, share)
        for (i_sig, o_sig), new_num in zip(copies, slot_nums):
            link_set.add((i_sig, new_num))
            link_set.add((-new_num, -i_sig))
            link_set.add((new_num, o_sig))
            link_set.add((-o_sig, -new_num))
    return sorted(link_set)


def split_repeats_with_threads(unitigs, links, hk_segments, k, rounds=4):
    """Repeat splitting driven by HIGHER-K THREADS instead of insert
    votes: a unitig assembled at k' > k that threads through [i, R, o]
    is direct read continuity for that traversal (no insert-size
    ceiling, no gap statistics). For a collapsed repeat R with balanced
    in/out sets, thread votes must be CONFLICT-FREE to act: every
    matched in-neighbour pairs with exactly one out-neighbour and no
    other remaining in-neighbour claims it (higher-k chimeras are rare
    but not impossible, so one conflicting witness vetoes the split).
    Every pair must be WITNESSED: completing a partial matching by
    elimination was measured to mis-join 40+ kb on sample_data (a
    2-in/2-out repeat can carry three genuine traversals — e.g.
    i1->o1, i1->o2, i2->o1 — and the forced leftover pairing invents
    the fourth; a depth-agreement gate did not catch it either).
    Threads are recomputed each round (splitting renumbers, and
    resolving one repeat layer exposes the next — the same laddering
    as split_repeats_with_pairs). Runs BEFORE the pair splitter so the
    deterministic evidence acts first; the pair splitter then works on
    the simplified graph."""
    total_split = 0
    for _ in range(rounds):
        paths = resolve_paths_with_higher_k(unitigs, links, hk_segments,
                                            k)
        votes = defaultdict(lambda: defaultdict(int))
        for path in paths:
            for t in range(1, len(path) - 1):
                mid = path[t]
                i_sig, o_sig = path[t - 1], path[t + 1]
                if mid < 0:
                    mid, i_sig, o_sig = -mid, -o_sig, -i_sig
                votes[mid][(i_sig, o_sig)] += 1
        if not votes:
            break
        fwd = defaultdict(set)
        for a, b in links:
            fwd[a].add(b)
            fwd[-b].add(-a)

        split_plan = []
        used_neighbors = set()
        for idx in range(len(unitigs)):
            num = idx + 1
            ins = sorted(-x for x in fwd.get(-num, ()))
            outs = sorted(fwd.get(num, ()))
            if len(ins) < 2 or len(ins) != len(outs):
                continue
            if num in [abs(x) for x in ins + outs]:
                continue               # self-adjacent (tandem): skip
            vv = {(i, o): c
                  for (i, o), c in votes.get(num, {}).items()
                  if i in ins and o in outs}
            if not vv:
                continue
            by_i = defaultdict(set)
            by_o = defaultdict(set)
            for (i, o) in vv:
                by_i[i].add(o)
                by_o[o].add(i)
            if set(by_i) != set(ins) or set(by_o) != set(outs):
                continue            # some neighbour never witnessed
            if any(len(v) != 1 for v in by_i.values()) \
                    or any(len(v) != 1 for v in by_o.values()):
                continue            # conflicting witnesses
            pairs = [(i, next(iter(by_i[i]))) for i in ins]
            nums_involved = {num} | {abs(x) for x, _ in pairs} \
                | {abs(x) for _, x in pairs}
            if nums_involved & used_neighbors:
                continue
            used_neighbors |= nums_involved
            split_plan.append((num, pairs))

        if not split_plan:
            break
        links = _apply_split_plan(unitigs, links, split_plan)
        total_split += len(split_plan)
    return unitigs, links, total_split


def resolve_paths_with_pairs(unitigs, links, pairs_1, pairs_2, k,
                             insert_mean=250.0, insert_dev=50.0,
                             max_pairs=20000, aggressive=False):
    """Paired-end repeat resolution: produce contigs.paths-style records.

    The role of SPAdes' exSPAnder stage (whose contigs.paths output feeds
    SpadesContigBridge, ref bridge_spades_contig.py). Pairs are placed on
    unitigs WITH positions; a growing path is extended through a junction
    when the pairs connecting the path's recent elements to one candidate
    — at gap distances consistent with the insert-size distribution —
    outweigh every other candidate decisively. Looking back past the
    junction (not just at the last unitig, which at a repeat is shared
    between contexts) is what lets an anchor on one side of a short
    repeat choose the correct anchor on the other side."""
    if not pairs_1 or not pairs_2 or not links:
        return []
    lengths = [len(seq) for seq, _ in unitigs]
    votes = collect_pair_votes(unitigs, links, pairs_1, pairs_2, k,
                               insert_mean, max_pairs, aggressive)

    forward = defaultdict(list)
    for a, b in links:
        forward[a].append(b)

    window = insert_mean + 4 * insert_dev

    # Multi-unitig LOOK-AHEAD per candidate: the unique-out-link chain
    # from the candidate, with each element's offset from the
    # candidate's start. A junction stub shorter than the insert size
    # gets almost no DIRECT pair votes (mates land beyond it); votes
    # for anything on its unambiguous continuation are equally
    # diagnostic, and the gap consistency check carries through the
    # accumulated offset. (The exSPAnder-style extension-by-evidence
    # VERDICT r2 asked for, replacing last-element-only counting.)
    _lookahead = {}

    def lookahead(cand):
        chain = _lookahead.get(cand)
        if chain is None:
            chain = [(cand, 0.0)]
            seen_el = {abs(cand)}
            off = max(1, lengths[abs(cand) - 1] - (k - 1))
            cur = cand
            while off <= window:
                nxts = forward.get(cur, [])
                if len(nxts) != 1 or abs(nxts[0]) in seen_el:
                    break
                cur = nxts[0]
                seen_el.add(abs(cur))
                chain.append((cur, off))
                off += max(1, lengths[abs(cur) - 1] - (k - 1))
            _lookahead[cand] = chain
        return chain

    def pair_score(path, cand):
        """Insert-consistent pair support for extending `path` by
        `cand`: pairs from path elements to the candidate OR its
        unambiguous continuation, whose implied gap matches the
        elements' distances within ~4 sigma."""
        score = 0.0
        chain = lookahead(cand)
        # distance from this element's oriented end to the CANDIDATE's
        # oriented start: the candidate starts k-1 bases before the path
        # end (GFA overlap), and each later element adds len - (k-1)
        dist_to_end = -(k - 1.0)
        for el in reversed(path):
            for la_el, la_off in chain:
                gaps = votes.get((el, la_el))
                if gaps:
                    want = dist_to_end + la_off
                    for gap in gaps:
                        if abs(gap - want) <= 4 * insert_dev + 50:
                            score += 1.0
            dist_to_end += max(1, lengths[abs(el) - 1] - (k - 1))
            if dist_to_end > window:
                break
        return score

    def pick_next(current, path):
        candidates = forward.get(current, [])
        if len(candidates) == 1:
            nxt = candidates[0]
        elif len(candidates) > 1:
            scored = sorted(((pair_score(path, c), c)
                             for c in candidates), reverse=True)
            best_votes, nxt = scored[0]
            second_votes = scored[1][0]
            if best_votes < 3 or best_votes < 2 * max(1.0, second_votes):
                return None
        else:
            return None
        if path.count(nxt) + path.count(-nxt) >= 2:
            return None
        return nxt

    paths = []
    seen = set()
    order = sorted(range(len(unitigs)),
                   key=lambda i: -len(unitigs[i][0]))
    for idx in order:
        start = idx + 1
        path = [start]
        while len(path) < 50:
            nxt = pick_next(path[-1], path)
            if nxt is None:
                break
            path.append(nxt)
        while len(path) < 50:
            prev = pick_next(-path[0], path)
            if prev is None:
                break
            path.insert(0, -prev)
        if len(path) < 2:
            continue
        key = tuple(path)
        flipped = tuple(-x for x in reversed(path))
        if key in seen or flipped in seen:
            continue
        seen.add(key)
        paths.append(path)
    return paths


def score_graph(unitigs, links, k):
    """1 / (contigs * (dead_ends + 2)) (ref spades_func.py:124-133)."""
    if not unitigs:
        return 0.0
    has_fwd = set()
    has_rev = set()
    for a, b in links:
        has_fwd.add(a)
        has_rev.add(b)
    dead_ends = 0
    for idx in range(len(unitigs)):
        num = idx + 1
        if num not in has_fwd:
            dead_ends += 1
        if -num not in has_fwd:
            dead_ends += 1
    return 1.0 / (len(unitigs) * (dead_ends + 2))


def estimate_insert_size(read_codes_1, read_codes_2, unitigs, k):
    """Insert-size mean/stdev from read-pair placements on long unitigs."""
    from ..ops.minimizer import MinimizerIndex
    long_unitigs = [encode_sequence(seq) for seq, _ in unitigs
                    if len(seq) >= 1000]
    if not long_unitigs or not read_codes_1:
        return 250.0, 50.0
    index = MinimizerIndex(long_unitigs, k=15, w=5)
    inserts = []
    # sample pairs EVENLY across the files (the head alone is biased on
    # position-sorted or interleaved inputs)
    n_pairs = min(len(read_codes_1), len(read_codes_2))
    sel = np.unique(np.linspace(0, n_pairs - 1,
                                min(2000, n_pairs)).astype(np.int64))
    sel_c1 = [read_codes_1[si] for si in sel]
    sel_c2 = [read_codes_2[si] for si in sel]
    h1_all = index.lookup_many(sel_c1, min_hits=2)
    h2_all = index.lookup_many(sel_c2, min_hits=2)
    for ii, si in enumerate(sel):
        c1, c2 = read_codes_1[si], read_codes_2[si]
        h1 = h1_all[ii]
        h2 = h2_all[ii]
        if len(h1) != 1 or len(h2) != 1:
            continue
        a, b = h1[0], h2[0]
        if a.ref_id != b.ref_id or a.rev_comp == b.rev_comp:
            continue
        if a.rev_comp:
            a, b = b, a
        insert = (b.ref_end + len(c2) - b.read_end) - \
            (a.ref_start - a.read_start)
        if 0 < insert < 2000:
            inserts.append(insert)
    if len(inserts) < 10:
        return 250.0, 50.0
    return float(np.mean(inserts)), float(np.std(inserts))


def build_best_short_read_graph(args):
    """Multi-k assembly, choosing the best-scoring k
    (ref get_best_spades_graph, spades_func.py:32-161). Trace spans:
    correct_reads, k<k> per k of the ladder (count_kmers, unitigs,
    score), resolution_k<k> (aggressive only), insert_size and
    pair_resolution."""
    from ..graph.assembly_graph import AssemblyGraph

    aggressive = aggressive_resolution(args)

    log.log_section_header('Assembling short reads with de Bruijn graphs')
    read_arrays = []
    pairs_1, pairs_2 = [], []
    if args.short1:
        d1, names1, _ = load_long_reads(args.short1, silent=True)
        arrays1 = [d1[n].codes for n in names1]
        read_arrays += arrays1
        pairs_1 = arrays1
    if args.short2:
        d2, names2, _ = load_long_reads(args.short2, silent=True)
        arrays2 = [d2[n].codes for n in names2]
        read_arrays += arrays2
        pairs_2 = arrays2
    if args.unpaired:
        d3, names3, _ = load_long_reads(args.unpaired, silent=True)
        read_arrays += [d3[n].codes for n in names3]
    if not read_arrays:
        from ..misc import quit_with_error
        quit_with_error('no short reads available for assembly')

    if not getattr(args, 'no_correct', False):
        from .correct import correct_reads
        n_before = len(read_arrays)
        with trace.span('correct_reads'):
            read_arrays, stats = correct_reads(read_arrays)
        log.log('read error correction: %d/%d reads corrected '
                '(%d substitutions; solid threshold %d)'
                % (stats['reads_corrected'], n_before,
                   stats['substitutions'], stats['threshold']))
        # keep the paired views in sync with the corrected arrays
        if pairs_1:
            pairs_1 = read_arrays[:len(pairs_1)]
        if pairs_2:
            pairs_2 = read_arrays[len(pairs_1):len(pairs_1) + len(pairs_2)]

    read_lengths = [len(a) for a in read_arrays]
    if args.kmers:
        kmer_range = sorted(int(x) for x in args.kmers.split(','))
    else:
        kmer_range = get_kmer_range(read_lengths, args.kmer_count,
                                    args.min_kmer_frac, args.max_kmer_frac)
    log.log('k-mer range: ' + ', '.join(str(k) for k in kmer_range))

    # Like the reference (get_best_spades_graph, spades_func.py:84-135),
    # each k's graph is cleaned BEFORE scoring 1/(contigs*(dead_ends+2)).
    # Iterative k (SPAdes scheme): each k also ingests the previous k's
    # unitigs, so low-coverage regions bridged at small k stay connected
    # when k grows past the local coverage.
    best = None
    carried = None
    tmp_gfa = os.path.join(args.out, 'TEMP_k_graph.gfa')
    for ki, k in enumerate(kmer_range):
        with trace.span('k%d' % k):
            unitigs, links = assemble_short_reads(read_arrays, k,
                                                  carried=carried)
        if not unitigs:
            log.log('  k=%d: no contigs' % k)
            continue
        # carry raw unitigs >= 2k (strategy S0). Junction-window carry
        # (S1/S2, build_carry_material) was measured on sample_data and
        # REJECTED: carried windows are exempt from the solidity
        # threshold, so every junction of the previous graph — including
        # junk — freezes into the next k and the graph grows
        # monotonically (866 -> 3776 unitigs across the ladder) instead
        # of simplifying; without windows the ladder self-cleans but the
        # top k dies of junction coverage (229 dead ends at k=119).
        # Raw k-mer laddering therefore tops out near k ~ 0.75x read
        # length; repeats longer than that are the paired-end resolver's
        # job (resolve_paths_with_pairs / split_repeats_with_pairs), the
        # same division of labour as SPAdes-assembly vs exSPAnder.
        # Measurements: scripts/carry_lab.py.
        if ki + 1 < len(kmer_range):
            carried = make_carry('S0', unitigs, links, k,
                                 kmer_range[ki + 1])
        with trace.span('k%d' % k), trace.span('score'):
            save_graph_gfa(unitigs, links, k, tmp_gfa)
            graph = AssemblyGraph(tmp_gfa, k - 1)
            pop_graph_bubbles(graph)
            graph.clean(args.depth_filter, args.largest_component)
            dead_ends = graph.total_dead_end_count()
        segment_count = len(graph.segments)
        score = 1.0 / (segment_count * (dead_ends + 2)) \
            if segment_count else 0.0
        trace.add('debruijn.k%d.score' % k, score)
        log.log('  k=%d: %d contigs, %d dead ends, score %.2e'
                % (k, segment_count, dead_ends, score))
        if best is None or score > best[0]:
            best = (score, k, unitigs, links)
    if os.path.exists(tmp_gfa):
        os.remove(tmp_gfa)
    if best is None:
        from ..misc import quit_with_error
        quit_with_error('short-read assembly produced no contigs')

    _, k, unitigs, links = best

    # Resolution ladder ABOVE the best k: graphs at k' > best_k lose
    # sequence at coverage-starved junctions (measured on sample_data:
    # 14.7 kb of plasmid A at zero coverage by k=101) so they cannot BE
    # the assembly — but their unitigs are read-continuity proof of
    # specific walks through the best-k graph, spanning every repeat
    # shorter than k'. Build them (continuing the S0 carry chain),
    # clean each, and thread depth-sane segments through the best-k
    # graph as HKPATH records (resolve_paths_with_higher_k).
    hk_segments = []
    hk_carry = make_carry('S0', unitigs, links, k, k + 8) \
        if (k < 127 and aggressive) else None
    k_hi = k + 8 if k % 2 == 1 else k + 7
    hk_tmp = os.path.join(args.out, 'TEMP_hk_graph.gfa')
    while hk_carry is not None and k_hi <= min(127, max(kmer_range) + 8):
        with trace.span('resolution_k%d' % k_hi):
            hk_unitigs, hk_links = assemble_short_reads(read_arrays, k_hi,
                                                        carried=hk_carry)
        if not hk_unitigs:
            break
        next_k = k_hi + 8
        hk_carry = make_carry('S0', hk_unitigs, hk_links, k_hi, next_k) \
            if next_k <= 127 else None
        with trace.span('resolution_k%d' % k_hi), trace.span('score'):
            save_graph_gfa(hk_unitigs, hk_links, k_hi, hk_tmp)
            hk_graph = AssemblyGraph(hk_tmp, k_hi - 1)
            pop_graph_bubbles(hk_graph)
            hk_graph.clean(args.depth_filter, args.largest_component)
        depths = sorted(s.depth for s in hk_graph.segments.values())
        med = depths[len(depths) // 2] if depths else 0.0
        n_used = 0
        for seg in hk_graph.segments.values():
            if seg.depth >= 0.5 * med:
                hk_segments.append(seg.forward_sequence)
                n_used += 1
        log.log('  resolution k=%d: %d clean segments, %d depth-sane'
                % (k_hi, len(hk_graph.segments), n_used))
        k_hi = next_k
    if os.path.exists(hk_tmp):
        os.remove(hk_tmp)

    with trace.span('insert_size'):
        insert_mean, insert_dev = estimate_insert_size(pairs_1, pairs_2,
                                                       unitigs, k)
    with trace.span('pair_resolution'):
        if aggressive:
            unitigs, links, n_hk_split, n_split = resolve_repeats(
                unitigs, links, hk_segments, pairs_1, pairs_2, k,
                insert_mean, insert_dev, tmp_gfa, args.depth_filter,
                args.largest_component, aggressive=aggressive)
            if os.path.exists(tmp_gfa):    # simplify_unitigs recreates it
                os.remove(tmp_gfa)
            hk_paths = resolve_paths_with_higher_k(unitigs, links,
                                                   hk_segments, k)
        else:
            unitigs, links, n_split = split_repeats_with_pairs(
                unitigs, links, pairs_1, pairs_2, k, insert_mean,
                insert_dev, aggressive=aggressive)
            n_hk_split, hk_paths = 0, []
        paths = resolve_paths_with_pairs(unitigs, links, pairs_1, pairs_2,
                                         k, insert_mean, insert_dev,
                                         aggressive=aggressive)
    trace.add('debruijn.best_k', k)
    trace.add('debruijn.pair_splits', n_split)
    trace.add('debruijn.paths', len(paths))
    log.log('  best k=%d; %d repeats split by higher-k threads, %d by '
            'read pairs; %d paired-end paths resolved; %d higher-k '
            'paths threaded'
            % (k, n_hk_split, n_split, len(paths), len(hk_paths)))
    graph_file = gfa_path(args.out, 1, 'spades_graph')
    save_graph_gfa(unitigs, links, k, graph_file, paths,
                   hk_paths=hk_paths)
    graph = AssemblyGraph(graph_file, k - 1, insert_size_mean=insert_mean,
                          insert_size_deviation=insert_dev)
    pop_graph_bubbles(graph)
    graph.clean(args.depth_filter, args.largest_component)
    return graph


def pop_graph_bubbles(graph, max_length_diff=0.1, max_depth_ratio=0.3):
    """Pop simple 2-way bubbles: two segments sharing the same upstream
    and downstream neighbours with similar lengths — keep the deeper one
    and add the popped depth to the survivor (the role of SPAdes' bulge
    removal, which the reference gets for free from the SPAdes
    subprocess).

    Only ERROR bulges pop: the minority side must be far shallower than
    the keeper (max_depth_ratio, SPAdes-style). Genuine repeat-variant
    pairs — e.g. an IS element whose copies on two plasmids differ by a
    few SNPs — form the same bubble shape at comparable depths, and
    popping them overwrites one replicon's variant with the other's
    (observed on sample_data plasmid E before this gate existed)."""
    from collections import defaultdict
    while True:
        by_ends = defaultdict(list)
        for num in sorted(graph.segments):
            ins = tuple(sorted(graph.reverse_links.get(num, [])))
            outs = tuple(sorted(graph.forward_links.get(num, [])))
            if ins and outs and len(ins) == 1 and len(outs) == 1:
                by_ends[(ins, outs)].append(num)
        removed = False
        for (ins, outs), nums in by_ends.items():
            if len(nums) < 2:
                continue
            nums.sort(key=lambda n: -graph.segments[n].depth)
            keeper = graph.segments[nums[0]]
            for other in nums[1:]:
                other_seg = graph.segments[other]
                longer = max(keeper.get_length(), other_seg.get_length())
                if abs(keeper.get_length() - other_seg.get_length()) \
                        <= max_length_diff * longer \
                        and other_seg.depth \
                        <= max_depth_ratio * keeper.depth:
                    keeper.depth += other_seg.depth
                    graph.remove_segments([other])
                    removed = True
        if not removed:
            break
