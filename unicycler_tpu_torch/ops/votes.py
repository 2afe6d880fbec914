"""Vectorised per-column vote accumulation over alignment CIGARs (a copy of
unicycler_tpu/ops/votes.py; host numpy, no device work).

Consensus (ops/msa.py) and polishing (asm/polish.py) both walk CIGARs
accumulating per-reference-position votes: base counts, summed base
qualities, deletion votes, coverage, and insertion candidates. Walking
them base-by-base in Python dicts costs tens of millions of dict ops on
a genome-scale polish (the reference does this inside Racon / SeqAn's C
code: ref src/consensus_align.cpp:159-236); here the M/D runs expand to
flat numpy index arrays and accumulate with np.add.at, leaving Python
loops only for the rare insertion runs.
"""

from collections import defaultdict

import numpy as np


def cigar_arrays(cigar):
    """(counts int64, op_codes int8 0=M,1=I,2=D) for a RunCigar or a
    [(count, 'M'|'I'|'D')] tuple list."""
    counts = getattr(cigar, 'counts', None)
    if counts is not None:
        return cigar.counts, cigar.op_codes
    counts = np.array([c for c, _ in cigar], np.int64)
    ops = np.array([{'M': 0, 'I': 1, 'D': 2}[o] for _, o in cigar],
                   np.int8)
    return counts, ops


def _expand(starts, counts):
    """concat of [arange(s, s+c)] — vectorised."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    offsets = np.cumsum(counts) - counts
    return (np.repeat(starts - offsets, counts)
            + np.arange(total, dtype=np.int64))


class ColumnVotes(object):
    """Per-column accumulators along one reference sequence of length n.

    base[j, c]  vote count for base code c at column j
    qual[j, c]  summed quality for base code c at column j
    gap[j]      deletion votes covering column j
    cover[j]    aligned-read coverage of column j
    ins[j]      list of (inserted string, summed quality) before column j
    """

    def __init__(self, n):
        self.n = n
        self.base = np.zeros((n, 4), np.int32)
        self.qual = np.zeros((n, 4), np.int64)
        self._gap_diff = np.zeros(n + 1, np.int64)
        self._cover_diff = np.zeros(n + 1, np.int64)
        self.ins = defaultdict(list)

    def add_alignment(self, cigar, i0, j0, seq_codes, qual_vals, seq=None):
        """Accumulate one read's alignment. seq_codes: int array of the
        aligned read segment (0..3); qual_vals: int array of its
        qualities (same length; pass zeros when absent); i0/j0: read /
        reference start positions; seq: the read string for insertion
        text (optional — falls back to decoding codes)."""
        counts, ops = cigar_arrays(cigar)
        if not len(counts):
            return
        counts = np.asarray(counts, np.int64)
        ops = np.asarray(ops)
        di = np.where(ops != 2, counts, 0)     # M/I advance the read
        dj = np.where(ops != 1, counts, 0)     # M/D advance the reference
        i_starts = i0 + np.cumsum(di) - di
        j_starts = j0 + np.cumsum(dj) - dj

        m = ops == 0
        if m.any():
            jm = _expand(j_starts[m], counts[m])
            im = _expand(i_starts[m], counts[m])
            keep = (jm >= 0) & (jm < self.n) & (im < len(seq_codes))
            jm, im = jm[keep], im[keep]
            codes = seq_codes[im].astype(np.int64)
            ok = (codes >= 0) & (codes <= 3)
            jm, im, codes = jm[ok], im[ok], codes[ok]
            np.add.at(self.base, (jm, codes), 1)
            np.add.at(self.qual, (jm, codes), qual_vals[im])
            # coverage per M run (difference array)
            lo = np.clip(j_starts[m], 0, self.n)
            hi = np.clip(j_starts[m] + counts[m], 0, self.n)
            np.add.at(self._cover_diff, lo, 1)
            np.add.at(self._cover_diff, hi, -1)

        d = ops == 2
        if d.any():
            lo = np.clip(j_starts[d], 0, self.n)
            hi = np.clip(j_starts[d] + counts[d], 0, self.n)
            np.add.at(self._gap_diff, lo, 1)
            np.add.at(self._gap_diff, hi, -1)

        for r in np.nonzero(ops == 1)[0]:
            i, j, c = int(i_starts[r]), int(j_starts[r]), int(counts[r])
            if seq is not None:
                text = seq[i:i + c]
            else:
                from ..io.fastx import decode_sequence
                text = decode_sequence(seq_codes[i:i + c])
            self.ins[j].append((text, int(qual_vals[i:i + c].sum())))

    @property
    def gap(self):
        return np.cumsum(self._gap_diff)[:self.n]

    @property
    def cover(self):
        return np.cumsum(self._cover_diff)[:self.n]

    def best_bases(self, prefer_codes=None):
        """(best_code, best_count, best_qual) per column, argmax by
        (count, qual[, prefer]) — `prefer_codes` (n,) breaks exact ties
        toward a designated base (the consensus backbone's own base,
        matching the dict-insertion-order tie-break of the scalar
        implementation)."""
        key = (self.base.astype(np.int64) << np.int64(32)) \
            + (self.qual << np.int64(1))
        if prefer_codes is not None:
            cols = np.arange(self.n)
            valid = (prefer_codes >= 0) & (prefer_codes <= 3)
            key[cols[valid], prefer_codes[valid]] += 1
        best_code = np.argmax(key, axis=1)
        cols = np.arange(self.n)
        return (best_code.astype(np.int8),
                self.base[cols, best_code],
                self.qual[cols, best_code])


class _Runs(object):
    __slots__ = ('counts', 'op_codes')

    def __init__(self, counts, op_codes):
        self.counts = counts
        self.op_codes = op_codes


def left_align_indels(cigar, q, r, i0, j0):
    """Normalise indel placement: shift every I/D run as far left as
    score-equivalence allows (a deletion of ref[j..j+c) may move to
    ref[j-1..j+c-1) when r[j-1] == r[j+c-1]; insertions likewise over
    the read). Voting consensus needs this: reads whose alignments place
    the same indel at different-but-equivalent positions inside a
    homopolymer/duplication split their gap votes across columns, and no
    single column ever outvotes its base count — measured on a perfect-
    read OLC assembly, 27 junction-insertion bases survived four polish
    rounds untouched until placements were normalised. q/r are code
    arrays in the same coordinate frames as i0 (read) and j0 (ref).
    Returns a runs object accepted by ColumnVotes.add_alignment."""
    counts, ops = cigar_arrays(cigar)
    out = []
    i, j = int(i0), int(j0)
    for c, op in zip(counts.tolist(), np.asarray(ops).tolist()):
        if op == 0:
            if out and out[-1][1] == 0:
                out[-1][0] += c
            else:
                out.append([c, 0])
            i += c
            j += c
            continue
        prev_len = out[-1][0] if (out and out[-1][1] == 0) else 0
        shift = 0
        if op == 2:                    # deletion consumes ref [j, j+c)
            while shift < prev_len and j - 1 - shift >= 0 \
                    and r[j - 1 - shift] == r[j + c - 1 - shift]:
                shift += 1
            j += c
        else:                          # insertion consumes read [i, i+c)
            while shift < prev_len and i - 1 - shift >= 0 \
                    and q[i - 1 - shift] == q[i + c - 1 - shift]:
                shift += 1
            i += c
        if shift:
            out[-1][0] -= shift
            if out[-1][0] == 0:
                out.pop()
        if out and out[-1][1] == op:
            out[-1][0] += c
        else:
            out.append([c, op])
        if shift:
            out.append([shift, 0])
    return _Runs(np.array([c for c, _ in out], np.int64),
                 np.array([o for _, o in out], np.int8))
