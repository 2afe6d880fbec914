"""Translated protein search with BLOSUM62 (the tblastn role); a copy of
unicycler_tpu/pipeline/protein_search.py.

The reference shells out to makeblastdb/tblastn to find start genes in
completed replicons (ref unicycler/blast_func.py:27-134). This module is
the in-framework equivalent: a seeded, matrix-scored protein aligner —

  * exact 4-mer protein seeds between the gene and each 6-frame
    translation, binned by diagonal (BLAST's word hits, word size 4);
  * for each promising diagonal cluster, a vectorised numpy affine-gap
    DP over the gene x local-window rectangle, scored with the real
    BLOSUM62 matrix (gap open -11 / extend -1, tblastn defaults), glocal
    (whole gene vs anywhere in the window) so hits report full gene
    coverage and a well-defined start position.

Genes are a few hundred residues, so each candidate DP is ~10^5 cells —
host numpy wins over a device round-trip here; the DNA-scale compute
stays on the card.
"""

from typing import List, NamedTuple, Optional

import numpy as np

AA_ORDER = 'ARNDCQEGHILKMFPSTWYV'
_AA_IDX = {aa: i for i, aa in enumerate(AA_ORDER)}

# Standard BLOSUM62, rows/cols in AA_ORDER.
_B62 = np.array([
    [4, -1, -2, -2, 0, -1, -1, 0, -2, -1, -1, -1, -1, -2, -1, 1, 0, -3, -2, 0],
    [-1, 5, 0, -2, -3, 1, 0, -2, 0, -3, -2, 2, -1, -3, -2, -1, -1, -3, -2, -3],
    [-2, 0, 6, 1, -3, 0, 0, 0, 1, -3, -3, 0, -2, -3, -2, 1, 0, -4, -2, -3],
    [-2, -2, 1, 6, -3, 0, 2, -1, -1, -3, -4, -1, -3, -3, -1, 0, -1, -4, -3, -3],
    [0, -3, -3, -3, 9, -3, -4, -3, -3, -1, -1, -3, -1, -2, -3, -1, -1, -2, -2, -1],
    [-1, 1, 0, 0, -3, 5, 2, -2, 0, -3, -2, 1, 0, -3, -1, 0, -1, -2, -1, -2],
    [-1, 0, 0, 2, -4, 2, 5, -2, 0, -3, -3, 1, -2, -3, -1, 0, -1, -3, -2, -2],
    [0, -2, 0, -1, -3, -2, -2, 6, -2, -4, -4, -2, -3, -3, -2, 0, -2, -2, -3, -3],
    [-2, 0, 1, -1, -3, 0, 0, -2, 8, -3, -3, -1, -2, -1, -2, -1, -2, -2, 2, -3],
    [-1, -3, -3, -3, -1, -3, -3, -4, -3, 4, 2, -3, 1, 0, -3, -2, -1, -3, -1, 3],
    [-1, -2, -3, -4, -1, -2, -3, -4, -3, 2, 4, -2, 2, 0, -3, -2, -1, -2, -1, 1],
    [-1, 2, 0, -1, -3, 1, 1, -2, -1, -3, -2, 5, -1, -3, -1, 0, -1, -3, -2, -2],
    [-1, -1, -2, -3, -1, 0, -2, -3, -2, 1, 2, -1, 5, 0, -2, -1, -1, -1, -1, 1],
    [-2, -3, -3, -3, -2, -3, -3, -3, -1, 0, 0, -3, 0, 6, -4, -2, -2, 1, 3, -1],
    [-1, -2, -2, -1, -3, -1, -1, -2, -2, -3, -3, -1, -2, -4, 7, -1, -1, -4, -3, -2],
    [1, -1, 1, 0, -1, 0, 0, 0, -1, -2, -2, 0, -1, -2, -1, 4, 1, -3, -2, -2],
    [0, -1, 0, -1, -1, -1, -1, -2, -2, -1, -1, -1, -1, -2, -1, 1, 5, -2, -2, 0],
    [-3, -3, -4, -4, -2, -2, -3, -2, -2, -3, -2, -3, -1, 1, -4, -3, -2, 11, 2, -3],
    [-2, -2, -2, -3, -2, -1, -2, -3, 2, -1, -1, -2, -1, 3, -3, -2, -2, 2, 7, -1],
    [0, -3, -3, -3, -1, -2, -2, -3, -3, 3, 1, -2, 1, -1, -2, -2, 0, -3, -1, 4],
], np.int32)

# Letter codes: 0-19 = AA_ORDER, 20 = X/unknown, 21 = stop (*). The
# score table is padded so X and * score a flat penalty vs everything
# (BLAST's X ~ -1; stops effectively break alignments at -4).
N_CODES = 22
SCORE_TABLE = np.full((N_CODES, N_CODES), -1, np.int32)
SCORE_TABLE[:20, :20] = _B62
SCORE_TABLE[21, :] = -4
SCORE_TABLE[:, 21] = -4

GAP_OPEN = -11     # tblastn defaults
GAP_EXT = -1

NEG = -10 ** 7


def encode_aa(seq: str) -> np.ndarray:
    out = np.full(len(seq), 20, np.int8)
    for i, ch in enumerate(seq):
        if ch in _AA_IDX:
            out[i] = _AA_IDX[ch]
        elif ch == '*':
            out[i] = 21
    return out


class ProteinHit(NamedTuple):
    score: int
    identity: float          # percent over aligned columns
    coverage: float          # percent of the gene aligned (glocal: 100)
    window_start: int        # hit start, residues into the frame
    window_end: int


def _seed_diagonals(gene: np.ndarray, frame: np.ndarray, word: int = 4,
                    max_diags: int = 8):
    """Candidate diagonal centres via exact protein word matches."""
    if len(gene) < word or len(frame) < word:
        return []
    base = np.int64(N_CODES)

    def words(a):
        w = a[:len(a) - word + 1].astype(np.int64).copy()
        for off in range(1, word):
            w = w * base + a[off:len(a) - word + 1 + off]
        return w

    gw, fw = words(gene), words(frame)
    order = np.argsort(fw, kind='stable')
    fw_sorted = fw[order]
    lo = np.searchsorted(fw_sorted, gw, 'left')
    hi = np.searchsorted(fw_sorted, gw, 'right')
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return []
    gpos = np.repeat(np.arange(len(gw)), counts)
    offsets = np.cumsum(counts) - counts
    flat = (np.repeat(lo - offsets, counts)
            + np.arange(total, dtype=np.int64))
    fpos = order[flat]
    diags = fpos - gpos
    # bin diagonals to +-16 and take the most-hit bins
    bins, bin_counts = np.unique(diags // 16, return_counts=True)
    top = bins[np.argsort(-bin_counts)][:max_diags]
    # merge adjacent bins
    top = np.unique(top)
    merged = []
    for b in top:
        if merged and b - merged[-1][-1] <= 1:
            merged[-1].append(b)
        else:
            merged.append([b])
    return [int((grp[0] * 16 + (grp[-1] + 1) * 16) // 2) for grp in merged]


def _glocal_dp(gene: np.ndarray, window: np.ndarray):
    """Affine-gap DP: the whole gene vs any substring of the window,
    fully vectorised per gene row (the E state uses the prefix-argmax
    trick with the source column packed into the running key, the same
    formulation as the DNA kernels). Alongside the score, (matches,
    aligned columns, start column) payloads ride every cell so identity
    comes out without a traceback. Returns (score, win_start, win_end,
    matches, aligned_cols)."""
    n, m = len(gene), len(window)
    sub_rows = SCORE_TABLE[gene][:, window].astype(np.int64)   # (n, m)
    is_match = gene[:, None] == window[None, :]
    idx = np.arange(m + 1, dtype=np.int64)
    h = np.zeros(m + 1, np.int64)                 # free start in window
    hm = np.zeros(m + 1, np.int64)                # matches payload
    hc = np.zeros(m + 1, np.int64)                # aligned-cols payload
    hs = idx.copy()                               # start-column payload
    f = np.full(m + 1, NEG, np.int64)
    fm = np.zeros(m + 1, np.int64)
    fc = np.zeros(m + 1, np.int64)
    fs = idx.copy()
    MOD = np.int64(m + 2)
    for i in range(n):
        # F (vertical, consumes a gene residue)
        f_open = h + GAP_OPEN
        f_ext = f + GAP_EXT
        take_ext = f_ext >= f_open
        f = np.where(take_ext, f_ext, f_open)
        fm = np.where(take_ext, fm, hm)
        fc = np.where(take_ext, fc, hc) + 1
        fs = np.where(take_ext, fs, hs)
        # H' = diag, then F
        nh = np.full(m + 1, NEG, np.int64)
        nm_ = np.zeros(m + 1, np.int64)
        nc = np.zeros(m + 1, np.int64)
        ns = idx.copy()
        nh[1:] = h[:-1] + sub_rows[i]
        nm_[1:] = hm[:-1] + is_match[i]
        nc[1:] = hc[:-1] + 1
        ns[1:] = hs[:-1]
        better = f > nh
        nh = np.where(better, f, nh)
        nm_ = np.where(better, fm, nm_)
        nc = np.where(better, fc, nc)
        ns = np.where(better, fs, ns)
        # E (horizontal): E[j] = (j-1)*ext + max_{j'<j}(H[j']+open-j'*ext)
        cand = nh + GAP_OPEN - idx * GAP_EXT
        key = cand * MOD + (np.int64(m + 1) - idx)
        kmax = np.maximum.accumulate(key)
        ksrc = kmax[:-1]
        e_val = (ksrc // MOD) + (idx[1:] - 1) * GAP_EXT
        src = np.int64(m + 1) - (ksrc % MOD)
        e_better = e_val > nh[1:]
        src_c = np.clip(src, 0, m)
        nh[1:] = np.where(e_better, e_val, nh[1:])
        nm_[1:] = np.where(e_better, nm_[src_c], nm_[1:])
        nc[1:] = np.where(e_better, nc[src_c] + (idx[1:] - src_c),
                          nc[1:])
        ns[1:] = np.where(e_better, ns[src_c], ns[1:])
        h, hm, hc, hs = nh, nm_, nc, ns
    j_best = int(np.argmax(h))
    return (int(h[j_best]), int(hs[j_best]), j_best,
            int(hm[j_best]), int(hc[j_best]))


def search_protein(gene: np.ndarray, frame: np.ndarray,
                   margin: int = 60) -> Optional[ProteinHit]:
    """Best glocal BLOSUM62 hit of `gene` in `frame` (both encoded)."""
    best = None
    for centre in _seed_diagonals(gene, frame):
        lo = max(0, centre - margin)
        hi = min(len(frame), centre + len(gene) + margin)
        if hi - lo < len(gene) // 2:
            continue
        window = frame[lo:hi]
        score, ws, we, matches, cols = _glocal_dp(gene, window)
        if cols == 0:
            continue
        hit = ProteinHit(score=score,
                         identity=100.0 * matches / cols,
                         coverage=100.0,
                         window_start=lo + ws, window_end=lo + we)
        if best is None or hit.score > best.score:
            best = hit
    return best


def _word_array(a: np.ndarray, word: int) -> np.ndarray:
    """Packed overlapping protein words of `a` (base-N_CODES int64)."""
    n = len(a) - word + 1
    if n <= 0:
        return np.empty(0, np.int64)
    w = a[:n].astype(np.int64).copy()
    for off in range(1, word):
        w = w * np.int64(N_CODES) + a[off:n + off]
    return w


def search_gene_database(gene_codes: List[np.ndarray],
                         frame_codes: List[np.ndarray],
                         word: int = 5, bin_size: int = 16,
                         min_hits: int = 3, max_candidates: int = 40,
                         margin: int = 60, identity_threshold: float = 0.0,
                         coverage_threshold: float = 0.0):
    """Best glocal hit of ANY gene in ANY frame — the whole-database
    search the rotation driver needs (the reference gets this from one
    tblastn call over all 2,631 start genes, ref blast_func.py:65-98).

    Per-gene search does not scale to the bundled database, so this is
    BLAST-shaped: one concatenated word index over every gene, exact
    word-5 lookups against each frame, candidates = (gene, frame,
    diagonal-bin) groups with >= min_hits seeds (the two-hit criterion,
    generalised), ranked by seed count; the full affine DP runs only on
    the top candidates. Like the reference (ref blast_func.py:84-89,
    best bitscore AMONG hits passing the id/cov thresholds), candidates
    failing the thresholds do not compete. Returns
    (ProteinHit, gene_idx, frame_idx) or None.
    """
    # one flat word table over all genes
    gw_parts, gid_parts, gpos_parts = [], [], []
    for gi, g in enumerate(gene_codes):
        w = _word_array(g, word)
        if not len(w):
            continue
        gw_parts.append(w)
        gid_parts.append(np.full(len(w), gi, np.int32))
        gpos_parts.append(np.arange(len(w), dtype=np.int64))
    if not gw_parts:
        return None
    gw = np.concatenate(gw_parts)
    gid = np.concatenate(gid_parts)
    gpos = np.concatenate(gpos_parts)
    order = np.argsort(gw, kind='stable')
    gw_sorted, gid_sorted, gpos_sorted = gw[order], gid[order], gpos[order]

    n_frames = len(frame_codes)
    cand = {}                     # (gene, frame, bin) -> hit count
    for fi, frame in enumerate(frame_codes):
        fw = _word_array(frame, word)
        if not len(fw):
            continue
        lo = np.searchsorted(gw_sorted, fw, 'left')
        hi = np.searchsorted(gw_sorted, fw, 'right')
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            continue
        fpos = np.repeat(np.arange(len(fw), dtype=np.int64), counts)
        offsets = np.cumsum(counts) - counts
        flat = (np.repeat(lo - offsets, counts)
                + np.arange(total, dtype=np.int64))
        hit_gid = gid_sorted[flat]
        hit_diag_bin = (fpos - gpos_sorted[flat]) // bin_size
        key = (hit_gid.astype(np.int64) * np.int64(2 ** 24)
               + (hit_diag_bin + np.int64(2 ** 22)))
        uniq, ucounts = np.unique(key, return_counts=True)
        keep = ucounts >= min_hits
        for k, c in zip(uniq[keep], ucounts[keep]):
            g = int(k >> 24)
            b = int(k & (2 ** 24 - 1)) - 2 ** 22
            cand[(g, fi, b)] = int(c)

    if not cand:
        return None
    # merge adjacent bins of the same (gene, frame): a true hit's seeds
    # straddle bin edges
    merged = {}
    for (g, fi, b), c in sorted(cand.items()):
        prev = (g, fi, b - 1)
        tgt = merged.pop(prev, None)
        if tgt is not None:
            merged[(g, fi, b)] = (tgt[0] + c, tgt[1])
        else:
            merged[(g, fi, b)] = (c, b)
    ranked = sorted(((c, g, fi, (b0 * bin_size + (b + 1) * bin_size) // 2)
                     for (g, fi, b), (c, b0) in merged.items()),
                    key=lambda t: (-t[0], t[1], t[2], t[3]))

    best = None
    for c, g, fi, centre in ranked[:max_candidates]:
        gene, frame = gene_codes[g], frame_codes[fi]
        lo_w = max(0, centre - margin)
        hi_w = min(len(frame), centre + len(gene) + margin)
        if hi_w - lo_w < len(gene) // 2:
            continue
        score, ws, we, matches, cols = _glocal_dp(gene, frame[lo_w:hi_w])
        if cols == 0:
            continue
        hit = ProteinHit(score=score,
                         identity=100.0 * matches / cols,
                         coverage=100.0,
                         window_start=lo_w + ws, window_end=lo_w + we)
        if hit.identity < identity_threshold \
                or hit.coverage < coverage_threshold:
            continue
        if best is None or hit.score > best[0].score:
            best = (hit, g, fi)
    return best
