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

A polish round votes all its alignments at once through add_batch: two
native passes (native/votes.cpp) that left-align and accumulate every
alignment, with the insertions kept as flat records until read.
"""

from collections import defaultdict

import numpy as np

from .. import native
from ..utils import trace


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

    add_batch leaves its insertions as flat records (self._records: the
    batch's read codes, then each record's column, code span and quality
    sum, in vote order); `ins` turns them into the lists when first read.
    """

    def __init__(self, n):
        self.n = n
        self.base = np.zeros((n, 4), np.int32)
        self.qual = np.zeros((n, 4), np.int64)
        self._gap_diff = np.zeros(n + 1, np.int64)
        self._cover_diff = np.zeros(n + 1, np.int64)
        self._ins = defaultdict(list)
        self._records = None

    @property
    def ins(self):
        if self._records is not None:
            codes, col, lo, hi, qsum = self._records
            self._records = None
            for p, text, q in zip(col.tolist(), _slices(codes, lo, hi),
                                  qsum.tolist()):
                self._ins[p].append((text, q))
        return self._ins

    def ins_counts(self):
        """(n + 1,) number of insertion votes before each column 0..n."""
        if self._records is not None and not self._ins:
            col = self._records[1]
            return np.bincount(col[(col >= 0) & (col <= self.n)],
                               minlength=self.n + 1)
        counts = np.zeros(self.n + 1, np.int64)
        for p, lst in self.ins.items():
            if 0 <= p <= self.n:
                counts[p] = len(lst)
        return counts

    def ins_texts(self, cols):
        """The inserted strings before each of `cols` (ascending), each
        list in vote order: [s for s, _ in ins[p]] without building the
        other columns' lists."""
        if self._records is None or self._ins:
            ins = self.ins
            return [[s for s, _ in ins.get(p, ())] for p in cols]
        codes, col, lo, hi, _ = self._records
        sel = np.nonzero(np.isin(col, cols))[0]
        sel = sel[np.argsort(col[sel], kind='stable')]
        texts = _slices(codes, lo[sel], hi[sel])
        first = np.searchsorted(col[sel], cols, 'left').tolist()
        last = np.searchsorted(col[sel], cols, 'right').tolist()
        return [texts[a:b] for a, b in zip(first, last)]

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

    def _add_records(self, codes, col, lo, hi, qsum):
        if self._records is not None:
            self.ins                   # fold the earlier batch's records
        self._records = (codes, col, lo, hi, qsum)

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


def _slices(codes, lo, hi):
    """[decode_sequence(codes[a:b]) for a, b in zip(lo, hi)], decoded in
    one call (a code decodes to one character)."""
    from ..io.fastx import decode_sequence
    lens = hi - lo
    text = decode_sequence(codes[_expand(lo, lens)])
    ends = np.cumsum(lens)
    return [text[a:b] for a, b in zip((ends - lens).tolist(), ends.tolist())]


def _concat(arrays, dtype):
    out = np.zeros(len(arrays) + 1, np.int64)
    out[1:] = np.cumsum([len(x) for x in arrays])
    flat = np.concatenate(arrays).astype(dtype, copy=False) if arrays \
        else np.zeros(0, dtype)
    return flat, out


def _ptr(a):
    return a.ctypes.data


def _accumulators(v):
    """v's base, qual, gap and cover difference arrays, checked to be laid
    out as native/votes.cpp writes them."""
    out = (v.base, v.qual, v._gap_diff, v._cover_diff)
    layout = ((np.int32, (v.n, 4)), (np.int64, (v.n, 4)),
              (np.int64, (v.n + 1,)), (np.int64, (v.n + 1,)))
    for a, (dtype, shape) in zip(out, layout):
        if a.dtype != dtype or a.shape != shape \
                or not a.flags.c_contiguous or not a.flags.writeable:
            raise ValueError('a ColumnVotes accumulator is not %s %s'
                             % (np.dtype(dtype).name, shape))
    return out


def left_align_batch(lib, counts, ops, run_off, codes, code_off, i0, j0,
                     target, ref_codes, ref_off):
    """left_align_indels over every alignment of a batch in one native
    call (arguments as native/votes.cpp's). Returns the runs as flat
    (counts, ops, run_off)."""
    cap = 2 * len(counts) + 1
    out_counts = np.empty(cap, np.int64)
    out_ops = np.empty(cap, np.int8)
    out_off = np.empty(len(i0) + 1, np.int64)
    total = lib.left_align_batch(
        len(i0), _ptr(counts), _ptr(ops), _ptr(run_off), _ptr(codes),
        _ptr(code_off), _ptr(i0), _ptr(j0), _ptr(target), _ptr(ref_codes),
        _ptr(ref_off), _ptr(out_counts), _ptr(out_ops), _ptr(out_off))
    if total < 0:
        raise IndexError('an indel shift reads past the end of a read '
                         'or a target')
    return out_counts[:total], out_ops[:total], out_off


def add_batch(votes, alignments, refs=None):
    """Accumulate many alignments into `votes` ({name: ColumnVotes}) in two
    native passes: the same votes as, for each alignment in turn,
    votes[name].add_alignment(left_align_indels(cigar, codes, refs[name],
    i0, j0), i0, j0, codes, quals).

    alignments: [(name, cigar, i0, j0, codes, quals)], with the read
    segment's codes and its uint8 qualities of the same length, i0 >= 0;
    refs: {name: codes} of the targets in the frame of j0, or None to
    vote the CIGARs as they are. The left-alignment runs under the span
    `left_align`, the accumulation under `vote_add`. Returns False, having
    added nothing, when the native library is unavailable."""
    lib = native.get_lib()
    if lib is None:
        return False
    names = list(votes)
    index = {name: k for k, name in enumerate(names)}
    cigars = [cigar_arrays(a[1]) for a in alignments]
    counts, run_off = _concat([c for c, _ in cigars], np.int64)
    ops = _concat([o for _, o in cigars], np.int8)[0]
    codes, code_off = _concat([a[4] for a in alignments], np.int8)
    if any(a[5].dtype != np.uint8 for a in alignments):
        raise ValueError('qualities are uint8')
    quals, qual_off = _concat([a[5] for a in alignments], np.uint8)
    if not np.array_equal(code_off, qual_off):
        raise ValueError('each alignment needs one quality a code')
    i0 = np.array([a[2] for a in alignments], np.int64)
    j0 = np.array([a[3] for a in alignments], np.int64)
    if (i0 < 0).any() or (counts < 0).any():
        raise ValueError('alignments start at i0 >= 0 in the read and '
                         'their runs count >= 0')
    target = np.array([index[a[0]] for a in alignments], np.int64)
    if refs is not None:
        ref_codes, ref_off = _concat([refs[name] for name in names],
                                     np.int8)
        with trace.span('left_align'):
            counts, ops, run_off = left_align_batch(
                lib, counts, ops, run_off, codes, code_off, i0, j0, target,
                ref_codes, ref_off)
    with trace.span('vote_add'):
        vs = [votes[name] for name in names]
        col_n = np.array([v.n for v in vs], np.int64)
        arrays = [np.array([_ptr(a) for a in field], np.uintp)
                  for field in zip(*map(_accumulators, vs))]
        cap = int(np.count_nonzero(ops == 1))
        rec = np.empty((5, cap), np.int64)
        n_rec = lib.vote_batch(
            len(i0), _ptr(counts), _ptr(ops), _ptr(run_off), _ptr(codes),
            _ptr(quals), _ptr(code_off), _ptr(i0), _ptr(j0), _ptr(target),
            _ptr(col_n), *[_ptr(a) for a in arrays],
            *[_ptr(r) for r in rec])
        col, aln, off, length, qsum = rec[:, :n_rec]
        # each record's span of the batch's codes, cut at its read's end
        size = np.diff(code_off)[aln]
        lo = code_off[aln] + np.minimum(off, size)
        hi = code_off[aln] + np.minimum(off + length, size)
        # split by target, keeping the vote order within each
        order = np.argsort(target[aln], kind='stable')
        bounds = np.searchsorted(target[aln][order],
                                 np.arange(len(vs) + 1)).tolist()
        for t, v in enumerate(vs):
            mine = order[bounds[t]:bounds[t + 1]]
            if len(mine):
                v._add_records(codes, col[mine], lo[mine], hi[mine],
                               qsum[mine])
    return True
