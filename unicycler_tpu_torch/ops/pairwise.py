"""Host half of the pairwise affine-gap (Gotoh) alignment module.

A copy of the jax-free part of unicycler_tpu/ops/pairwise.py: the NEG
sentinel and move codes shared by every DP kernel, the free-end-gap
AlignConfig, the Scoring tuple, the RunCigar/PairAlignment result types and
the host full-matrix traceback decoder. The device full-matrix DP
(_align_single, align_batch_device, align_pairs) is not ported yet.

Scoring convention (matches SeqAn Score<int,Simple>(match, mismatch, ext,
open) used throughout the reference): a gap of length L costs
open + (L-1)*ext, with scores as (possibly negative) integers.
"""

from typing import NamedTuple

import numpy as np

NEG = -(2 ** 30)
NEG_BAND = 2 ** 28          # 'unbanded' diagonal bound sentinel

# H-source codes in the traceback byte (bits 0-1).
DIAG, E_SRC, F_SRC = 0, 1, 2
E_EXT_BIT = 4
F_EXT_BIT = 8


class AlignConfig(NamedTuple):
    """Free-end-gap flags.

    free_start_s1: s1's prefix may be skipped for free (clip in s1)
    free_start_s2: s2's prefix may be skipped for free
    free_end_s1:   s1's suffix may be skipped for free
    free_end_s2:   s2's suffix may be skipped for free

    SeqAn mapping (s1 horizontal, s2 vertical): TOP=free_start_s1,
    LEFT=free_start_s2, BOTTOM=free_end_s1, RIGHT=free_end_s2.
    """
    free_start_s1: bool
    free_start_s2: bool
    free_end_s1: bool
    free_end_s2: bool


# The reference's aligner variants as configs:
SEMI_GLOBAL = AlignConfig(True, True, True, True)     # AlignConfig<t,t,t,t>
FULLY_GLOBAL = AlignConfig(False, False, False, False)  # <f,f,f,f>
PATH_CONFIG = AlignConfig(False, False, False, True)  # <f,f,t,f>: free s2 tail
OVERLAP_CONFIG = AlignConfig(True, False, False, True)  # <t,f,t,f>
START_CONFIG = AlignConfig(False, False, False, True)  # find s1 at start of s2
END_CONFIG = AlignConfig(False, True, False, False)   # find s1 at end of s2


class Scoring(NamedTuple):
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


DEFAULT_SCORING = Scoring(3, -6, -5, -2)


# ---------------------------------------------------------------------------
# Host-side traceback decode
# ---------------------------------------------------------------------------

_OP_CHARS = np.array(['M', 'I', 'D'])


class RunCigar(object):
    """A CIGAR held as numpy run arrays, duck-compatible with the
    [(count, op)] tuple-list representation used across the package.
    Avoids materialising tens of thousands of Python tuples per
    alignment on the hot decode path; consumers that iterate see
    identical (int, str) pairs, and numpy-aware consumers read
    .counts / .op_codes directly (0=M, 1=I, 2=D)."""
    __slots__ = ('counts', 'op_codes', '_tuples')

    def __init__(self, counts, op_codes):
        self.counts = np.asarray(counts, np.int64)
        self.op_codes = np.asarray(op_codes, np.int8)
        self._tuples = None

    def _as_tuples(self):
        if self._tuples is None:
            ops = _OP_CHARS[self.op_codes]
            self._tuples = list(zip(self.counts.tolist(), ops.tolist()))
        return self._tuples

    def __len__(self):
        return len(self.counts)

    def __bool__(self):
        return len(self.counts) > 0

    def __iter__(self):
        return iter(self._as_tuples())

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._as_tuples()[idx]
        return (int(self.counts[idx]), str(_OP_CHARS[self.op_codes[idx]]))

    def __eq__(self, other):
        if isinstance(other, RunCigar):
            return (np.array_equal(self.counts, other.counts)
                    and np.array_equal(self.op_codes, other.op_codes))
        return self._as_tuples() == other

    def __repr__(self):
        return 'RunCigar(%r)' % (self._as_tuples(),)


class PairAlignment(NamedTuple):
    """Result of one pairwise alignment in local (s1, s2) coordinates."""
    score: int
    s1_start: int
    s1_end: int
    s2_start: int
    s2_end: int
    cigar: list            # [(count, op)] with op in 'MID', excl. clips
    s1_len: int
    s2_len: int

    def cigar_str_with_clips(self):
        """CIGAR with S-clips for unaligned s1 ends (read-style SAM CIGAR)."""
        parts = []
        if self.s1_start > 0:
            parts.append(str(self.s1_start) + 'S')
        parts.extend(str(c) + op for c, op in self.cigar)
        end_clip = self.s1_len - self.s1_end
        if end_clip > 0:
            parts.append(str(end_clip) + 'S')
        return ''.join(parts)


def decode_traceback(moves: np.ndarray, end_i: int, end_j: int,
                     config: AlignConfig):
    """Walk the packed move matrix from (end_i, end_j) back to a start cell.

    Returns (cigar_ops_reversed_fixed, start_i, start_j) where cigar is a
    list of (count, op) in forward order, ops M/I/D (I consumes s1,
    D consumes s2 — read/ref convention of ref alignment.py:176-206).
    Uses the native decoder when available.
    """
    from ..native import native_decode_full
    result = native_decode_full(moves, end_i, end_j,
                                config.free_start_s1, config.free_start_s2)
    if result is not None:
        return result
    i, j = int(end_i), int(end_j)
    ops = []           # appended in reverse order

    def emit(op, count=1):
        if ops and ops[-1][1] == op:
            ops[-1][0] += count
        else:
            ops.append([count, op])

    state = 'H'
    while True:
        if state == 'H':
            if i == 0 and j == 0:
                break
            if i == 0:
                if config.free_start_s2:
                    break
                emit('D', j)
                j = 0
                break
            if j == 0:
                if config.free_start_s1:
                    break
                emit('I', i)
                i = 0
                break
            b = int(moves[i - 1, j])
            src = b & 3
            if src == DIAG:
                emit('M')
                i -= 1
                j -= 1
            elif src == E_SRC:
                state = 'E'
            else:
                state = 'F'
        elif state == 'E':
            b = int(moves[i - 1, j])
            emit('D')
            j -= 1
            if not (b & E_EXT_BIT):
                state = 'H'
            if j == 0:
                state = 'H'
        else:  # state == 'F'
            b = int(moves[i - 1, j])
            emit('I')
            i -= 1
            if not (b & F_EXT_BIT):
                state = 'H'
            if i == 0:
                state = 'H'
    cigar = [(c, op) for c, op in reversed(ops)]
    return cigar, i, j

