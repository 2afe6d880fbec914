"""K-mer-spectrum read error correction (the BayesHammer role; a copy of
unicycler_tpu/asm/correct.py, host numpy).

The reference relies on SPAdes' built-in read correction, run by default
before assembly (ref unicycler/spades_func.py:220-252; `--no_correct`
skips it). This module is the in-framework replacement: a spectral
corrector in the SPAdes/Quake family —

  * count canonical k-mers (k=21) across all short reads, packed 2-bit
    into uint64 (vectorised rolling pack, bit-ladder reverse complement);
  * pick the solidity threshold at the valley of the count histogram
    between the error peak (counts 1-2) and the coverage peak;
  * for every read, mark weak (non-solid) k-mers; an isolated
    substitution error at base p makes exactly the k-mers covering p
    weak, so each maximal weak run implicates one base; try the three
    alternative bases and accept the one that turns the run's k-mers
    solid (ties broken by total k-mer count).

Indel errors (rare on Illumina) are left to the assembler's tip/bubble
cleaning. Counting is fully vectorised; the per-read repair loop touches
only reads that contain weak k-mers.
"""

from typing import List, Tuple

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def revcomp_packed(x: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2-bit-packed k-mers (k <= 31)."""
    x = (~x).astype(np.uint64)                       # complement (A<->T)
    x = ((x & _M2) << np.uint64(2)) | ((x >> np.uint64(2)) & _M2)
    x = ((x & _M4) << np.uint64(4)) | ((x >> np.uint64(4)) & _M4)
    x = x.byteswap()
    return x >> np.uint64(64 - 2 * k)


def pack_kmers(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(kmers uint64 (n-k+1,), valid bool) rolling 2-bit pack of one
    sequence; invalid where any base is non-ACGT."""
    n = len(codes)
    if n < k:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    c = codes.astype(np.uint64) & np.uint64(3)
    bad = codes > 3
    out = np.zeros(n - k + 1, np.uint64)
    valid = np.ones(n - k + 1, bool)
    for off in range(k):
        out = (out << np.uint64(2)) | c[off:n - k + 1 + off]
        valid &= ~bad[off:n - k + 1 + off]
    return out, valid


def canonical_packed(kmers: np.ndarray, k: int) -> np.ndarray:
    return np.minimum(kmers, revcomp_packed(kmers, k))


def _joined(read_code_arrays, chunk_bases=8_000_000):
    """Reads concatenated with one invalid-base separator, in bounded
    chunks; also yields the read id of every base. Windows spanning a
    boundary contain the separator and fail pack_kmers' validity mask,
    so k-mer sets equal per-read extraction without a numpy call per
    read (the per-read loop was half the correction stage's time)."""
    sep = np.array([4], np.uint8)
    buf, ids, total = [], [], 0
    for ri, codes in enumerate(read_code_arrays):
        buf.append(codes.astype(np.uint8, copy=False))
        buf.append(sep)
        ids.append(np.full(len(codes) + 1, ri, np.int64))
        total += len(codes) + 1
        if total >= chunk_bases:
            yield np.concatenate(buf), np.concatenate(ids)
            buf, ids, total = [], [], 0
    if buf:
        yield np.concatenate(buf), np.concatenate(ids)


def count_spectrum(read_code_arrays, k: int):
    """(sorted unique canonical k-mers, counts) over all reads."""
    chunks = []
    for joined, _ in _joined(read_code_arrays):
        km, valid = pack_kmers(joined, k)
        if len(km):
            chunks.append(canonical_packed(km[valid], k))
    if not chunks:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    allk = np.concatenate(chunks)
    return np.unique(allk, return_counts=True)


def solid_threshold(counts: np.ndarray, max_t: int = 16) -> int:
    """First valley of the k-mer count histogram: the smallest t >= 2
    where the histogram stops falling (errors dominate low counts, true
    coverage forms a second mode)."""
    if not len(counts):
        return 2
    hist = np.bincount(np.minimum(counts, max_t + 1))
    for t in range(2, max_t + 1):
        if t + 1 >= len(hist):
            break
        if hist[t + 1] >= hist[t]:
            return t
    return 2


class KmerSpectrum(object):
    def __init__(self, read_code_arrays, k: int = 21, threshold=None):
        self.k = k
        kmers, counts = count_spectrum(read_code_arrays, k)
        self.threshold = int(threshold) if threshold \
            else solid_threshold(counts)
        solid = counts >= self.threshold
        self.solid = kmers[solid]          # sorted (np.unique output)
        self.counts = counts[solid]

    def lookup(self, canon: np.ndarray):
        """(is_solid bool, count int64) per canonical k-mer."""
        pos = np.searchsorted(self.solid, canon)
        pos_c = np.minimum(pos, max(len(self.solid) - 1, 0))
        if not len(self.solid):
            return np.zeros(len(canon), bool), np.zeros(len(canon), np.int64)
        hit = self.solid[pos_c] == canon
        return hit, np.where(hit, self.counts[pos_c], 0)


def _weak_runs(weak: np.ndarray):
    """[(start, end)] inclusive index ranges of True runs."""
    idx = np.nonzero(weak)[0]
    if not len(idx):
        return []
    breaks = np.nonzero(np.diff(idx) > 1)[0]
    starts = np.concatenate([[idx[0]], idx[breaks + 1]])
    ends = np.concatenate([idx[breaks], [idx[-1]]])
    return list(zip(starts.tolist(), ends.tolist()))


def correct_read(codes: np.ndarray, spectrum: KmerSpectrum, passes=4):
    """Return (corrected codes, n_substitutions) for one read. The input
    array is not modified unless a correction is accepted (then a copy is
    returned). A second pass retries runs that only become isolated once
    a neighbouring error has been fixed."""
    total = 0
    for _ in range(passes):
        codes, n = _correct_read_once(codes, spectrum)
        total += n
        if n == 0:
            break
    return codes, total


def _correct_read_once(codes: np.ndarray, spectrum: KmerSpectrum):
    k = spectrum.k
    km, valid = pack_kmers(codes, k)
    if not len(km):
        return codes, 0
    solid, _ = spectrum.lookup(canonical_packed(km, k))
    weak = ~(solid | ~valid)              # invalid k-mers are not fixable
    if not weak.any() or weak.all():
        return codes, 0
    nk = len(km)
    out = None
    n_fixed = 0
    for s, e in _weak_runs(weak):
        if s == 0 and e == nk - 1:
            continue                       # everything weak (handled above)
        # The run-edge k-mer pins one error even when several errors
        # merged into one long run (errors < 2k apart): the rightmost
        # error is the last base of the run's last weak k-mer, except for
        # runs touching the read's right edge, where the leftmost error
        # (first weak k-mer's last base) is the only pinned one.
        if e == nk - 1 and s > 0:
            p = s + k - 1
            anchor = s                     # covering k-mer that must heal
        else:
            p = e
            anchor = e
        if p >= len(codes):
            continue
        orig = int(codes[p])
        if orig > 3:
            continue
        lo = max(0, p - k + 1)
        hi = min(len(codes), p + k)        # window of covering k-mers
        window = (out if out is not None else codes)[lo:hi].copy()
        wkm0, wvalid0 = pack_kmers(window, k)
        ws0, _ = spectrum.lookup(canonical_packed(wkm0, k))
        weak_before = int((~(ws0 | ~wvalid0)).sum())
        best = None
        for alt in range(4):
            if alt == orig:
                continue
            window[p - lo] = alt
            wkm, wvalid = pack_kmers(window, k)
            ws, wc = spectrum.lookup(canonical_packed(wkm, k))
            wk = ~(ws | ~wvalid)
            # the anchor k-mer is window k-mer (anchor - lo)
            if not ws[anchor - lo]:
                continue
            n_weak = int(wk.sum())
            if n_weak >= weak_before:
                continue
            n_solid = int(ws.sum())
            total = int(wc.sum())
            if best is None or (n_solid, total) > best[:2]:
                best = (n_solid, total, alt)
        if best is not None:
            if out is None:
                out = codes.copy()
            out[p] = best[2]
            n_fixed += 1
    return (out if out is not None else codes), n_fixed


def correct_reads(read_code_arrays: List[np.ndarray], k: int = 21,
                  threshold=None):
    """Spectral correction over a read set. Returns (corrected list,
    stats dict). Reads without weak k-mers are returned as-is (no copy).

    Replaces the SPAdes read-error-correction stage the reference runs by
    default (ref unicycler/spades_func.py:220-252)."""
    spectrum = KmerSpectrum(read_code_arrays, k, threshold)
    # batched screen: one joined pack + spectrum lookup marks the reads
    # that contain any weak (non-solid, valid) k-mer; only those enter
    # the per-read repair loop (~20% on 1%-error Illumina)
    has_weak = np.zeros(len(read_code_arrays), bool)
    for joined, ids in _joined(read_code_arrays):
        km, valid = pack_kmers(joined, k)
        if not len(km):
            continue
        solid, _ = spectrum.lookup(canonical_packed(km, k))
        weak = ~(solid | ~valid)
        widx = np.nonzero(weak)[0]
        if len(widx):
            has_weak[np.unique(ids[widx])] = True
    n_reads_fixed = 0
    n_subs = 0
    out = []
    for ri, codes in enumerate(read_code_arrays):
        if not has_weak[ri]:
            out.append(codes)
            continue
        fixed, n = correct_read(codes, spectrum)
        out.append(fixed)
        if n:
            n_reads_fixed += 1
            n_subs += n
    stats = {'threshold': spectrum.threshold,
             'solid_kmers': int(len(spectrum.solid)),
             'reads_corrected': n_reads_fixed,
             'substitutions': n_subs}
    return out, stats
