"""Host half of the pairwise affine-gap (Gotoh) alignment module.

Counterpart of unicycler_tpu/ops/pairwise.py: the NEG sentinel and move
codes shared by every DP kernel, the free-end-gap AlignConfig, the Scoring
tuple, the RunCigar/PairAlignment result types, the full-matrix DP
(align_batch_device, the batched twin of the JAX _align_single) and its
host API align_pairs with the host traceback decoder. The JAX package runs
this DP as a device program (a lax.scan over rows, vmapped over the
batch); the port runs it as the hand-written kernel csrc/pairwise.cu on a
CUDA tensor (align_batch_cuda) and as its plain PyTorch version on a CPU
tensor (align_batch_plain: the batch vectorised, the rows a Python loop,
E a torch.cummax over columns).

Scoring convention (matches SeqAn Score<int,Simple>(match, mismatch, ext,
open) used throughout the reference): a gap of length L costs
open + (L-1)*ext, with scores as (possibly negative) integers.
"""

from typing import NamedTuple

import numpy as np
import torch

from . import cuda_lib

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


def align_batch_plain(q_batch, q_lens, r_batch, r_lens, scoring: Scoring,
                      config: AlignConfig, need_moves: bool,
                      lower_diags=None, upper_diags=None):
    """Full-matrix Gotoh DP over a padded batch in plain torch ops, on the
    tensors' device. q_batch (B, n_pad), r_batch (B, m_pad) int8; q_lens,
    r_lens (B,). Cells outside the diagonal band lower <= (i - j) <= upper
    are masked out (SeqAn banded-globalAlignment semantics; None =
    unbanded). Returns (score, end_i, end_j) (B,) int32 and moves (B,
    n_pad, m_pad + 1) uint8 (None without need_moves)."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    assert open_ <= ext, 'prefix-scan Gotoh requires gap_open <= gap_extend'
    B, n_pad = q_batch.shape
    m_pad = r_batch.shape[1]
    m1 = m_pad + 1
    dev = q_batch.device
    i32 = torch.int32
    q = q_batch.to(i32)
    r = r_batch.to(i32)
    n_act = q_lens.to(torch.int64)[:, None]
    m_act = r_lens.to(torch.int64)[:, None]
    lower = torch.full((B, 1), -NEG_BAND, dtype=i32, device=dev) \
        if lower_diags is None else lower_diags.to(i32)[:, None]
    upper = torch.full((B, 1), NEG_BAND, dtype=i32, device=dev) \
        if upper_diags is None else upper_diags.to(i32)[:, None]
    js = torch.arange(m1, dtype=i32, device=dev)[None, :]
    neg1 = torch.full((B, 1), NEG, dtype=i32, device=dev)

    # row 0 boundary
    if config.free_start_s2:
        h0 = torch.zeros((B, m1), dtype=i32, device=dev)
    else:
        h0 = torch.where(js > 0, open_ + (js - 1) * ext, 0).to(i32) \
            .expand(B, m1)
    h0 = torch.where((-js >= lower) & (-js <= upper), h0, NEG)
    h = h0
    f = torch.full((B, m1), NEG, dtype=i32, device=dev)
    h_at_n = torch.where(n_act == 0, h0, NEG)
    moves = torch.empty((B, n_pad, m1), dtype=torch.uint8, device=dev) \
        if need_moves else None
    lastcol = torch.empty((B, n_pad), dtype=i32, device=dev)
    for i in range(1, n_pad + 1):
        f_ext = f + ext
        f_new = torch.maximum(h + open_, f_ext)
        f_ext_bit = (f_new == f_ext) & (f > NEG // 2)
        sub = torch.where(q[:, i - 1:i] == r, match_s, mismatch).to(i32)
        hb = 0 if config.free_start_s1 else open_ + (i - 1) * ext
        hb_col = torch.full((B, 1), hb, dtype=i32, device=dev)
        diag_full = torch.cat([hb_col, h[:, :-1] + sub], 1)
        g = torch.cat([hb_col, torch.maximum(diag_full[:, 1:],
                                             f_new[:, 1:])], 1)
        c = g + open_ - (js + 1) * ext
        cmax = torch.cummax(c, 1).values
        e = torch.cat([neg1, cmax[:, :-1]], 1) + js * ext
        e[:, 0] = NEG
        hn = torch.maximum(g, e)
        hn[:, 0] = hb
        d = i - js
        in_band = (d >= lower) & (d <= upper)
        hn = torch.where(in_band, hn, NEG)
        e = torch.where(in_band, e, NEG)
        f_new = torch.where(in_band, f_new, NEG)
        e_prev = torch.cat([neg1, e[:, :-1]], 1)
        e_ext_bit = (e == e_prev + ext) & (e_prev > NEG // 2)
        if need_moves:
            hsrc = torch.where(hn == diag_full, DIAG,
                               torch.where(hn == e, E_SRC, F_SRC))
            moves[:, i - 1] = (hsrc | (e_ext_bit.to(torch.int64) << 2)
                               | (f_ext_bit.to(torch.int64) << 3)).to(
                                   torch.uint8)
        h_at_n = torch.where(n_act == i, hn, h_at_n)
        lastcol[:, i - 1] = torch.gather(hn, 1, m_act)[:, 0]
        h, f = hn, f_new

    # end-cell selection, in the JAX package's tie order
    corner = torch.gather(h_at_n, 1, m_act)[:, 0]
    score = corner
    end_i = n_act[:, 0].to(i32)
    end_j = m_act[:, 0].to(i32)
    if config.free_end_s2:
        row_vals = torch.where(js <= m_act, h_at_n, NEG)
        j_best = torch.argmax(row_vals, 1)
        s = torch.gather(row_vals, 1, j_best[:, None])[:, 0]
        better = s > score
        end_j = torch.where(better, j_best.to(i32), end_j)
        end_i = torch.where(better, n_act[:, 0].to(i32), end_i)
        score = torch.maximum(score, s)
    if config.free_end_s1:
        is_ = torch.arange(1, n_pad + 1, dtype=torch.int64, device=dev)
        col_vals = torch.where(is_[None, :] <= n_act, lastcol, NEG)
        col_vals = torch.cat([torch.gather(h0, 1, m_act), col_vals], 1)
        i_best = torch.argmax(col_vals, 1)
        s = torch.gather(col_vals, 1, i_best[:, None])[:, 0]
        better = s > score
        end_i = torch.where(better, i_best.to(i32), end_i)
        end_j = torch.where(better, m_act[:, 0].to(i32), end_j)
        score = torch.maximum(score, s)
    return score.to(i32), end_i, end_j, moves


# csrc/pairwise.cu keeps the previous row's H and F in shared memory up to
# this many columns (m_pad + 1 rounded up to 4), and in a global scratch
# of (B, 2 * that) int32 above it
SMEM_COLS = 28672


def align_batch_cuda(q_batch, q_lens, r_batch, r_lens, scoring: Scoring,
                     config: AlignConfig, need_moves: bool,
                     lower_diags=None, upper_diags=None):
    """Launch csrc/pairwise.cu: align_batch_plain's contract, with moves
    rows at and past each pair's n_act and columns past its m_act
    unspecified. Bases int8, lengths and diagonals int32, all contiguous
    on one CUDA device; lengths above the padding are clamped to it."""
    B, n_pad = q_batch.shape
    m_pad = r_batch.shape[1]
    dev = q_batch.device
    if dev.type != 'cuda':
        raise ValueError('align_batch_cuda needs CUDA tensors, not %s' % dev)
    checks = [('q_batch', q_batch, torch.int8, 2),
              ('r_batch', r_batch, torch.int8, 2),
              ('q_lens', q_lens, torch.int32, 1),
              ('r_lens', r_lens, torch.int32, 1)]
    for name, x in (('lower_diags', lower_diags),
                    ('upper_diags', upper_diags)):
        if x is not None:
            checks.append((name, x, torch.int32, 1))
    for name, x, dt, dim in checks:
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or x.dim() != dim or x.shape[0] != B:
            raise ValueError('%s must be a contiguous %dD %s tensor of %d '
                             'rows on %s' % (name, dim, dt, B, dev))
    if int(scoring.gap_open) > int(scoring.gap_extend):
        raise ValueError('prefix-scan Gotoh requires gap_open <= gap_extend')
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_i = torch.empty(B, dtype=torch.int32, device=dev)
    end_j = torch.empty(B, dtype=torch.int32, device=dev)
    moves = torch.empty((B, n_pad, m_pad + 1), dtype=torch.uint8,
                        device=dev) if need_moves else None
    if B == 0:
        return score, end_i, end_j, moves
    m1r = (m_pad + 4) // 4 * 4
    scratch = torch.empty((B, 2 * m1r), dtype=torch.int32, device=dev) \
        if m1r > SMEM_COLS else None
    ptr = lambda x: x.data_ptr() if x is not None else None
    lib = cuda_lib.lib()
    with cuda_lib.timed('pairwise', dev, (q_lens, r_lens, n_pad, m_pad,
                                          need_moves)):
        err = lib.pairwise_launch(
            q_batch.data_ptr(), r_batch.data_ptr(), q_lens.data_ptr(),
            r_lens.data_ptr(), ptr(lower_diags), ptr(upper_diags),
            ptr(moves), score.data_ptr(), end_i.data_ptr(), end_j.data_ptr(),
            ptr(scratch), B, n_pad, m_pad, int(scoring.match),
            int(scoring.mismatch), int(scoring.gap_open),
            int(scoring.gap_extend), int(config.free_start_s1),
            int(config.free_start_s2), int(config.free_end_s1),
            int(config.free_end_s2), cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'pairwise')
    cuda_lib.LAUNCHES['pairwise'] += 1
    return score, end_i, end_j, moves


def align_batch_device(q_batch, q_lens, r_batch, r_lens, scoring: Scoring,
                       config: AlignConfig, need_moves: bool,
                       lower_diags=None, upper_diags=None):
    """Full-matrix Gotoh DP over a padded batch on the tensors' device: the
    kernel on a CUDA tensor, the plain version on a CPU tensor (see
    align_batch_plain for the contract)."""
    args = (q_batch, q_lens, r_batch, r_lens, scoring, config, need_moves,
            lower_diags, upper_diags)
    if q_batch.device.type == 'cuda':
        return align_batch_cuda(*args)
    if q_batch.device.type == 'cpu':
        return align_batch_plain(*args)
    raise ValueError('unsupported device %s' % q_batch.device)


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



def align_pairs(q_list, r_list, scoring=DEFAULT_SCORING, config=SEMI_GLOBAL,
                need_cigar=True, band=None, device=None):
    """Host API: align code-array pairs on `device` (default CUDA), return
    PairAlignments.

    All pairs are padded into one rectangular batch (callers should bucket
    by length for efficiency). When `band` is given, the DP is restricted
    to the SeqAn-style diagonal band expanded by the length difference
    (ref global_align.cpp:56-75): lower = -band - max(0, m-n),
    upper = band + max(0, n-m).
    """
    from ..device import resolve_device
    from .encode import pack_pairs
    if not q_list:
        return []
    dev = resolve_device(device)
    # the JAX package pads to length buckets; rows and columns past the
    # longest pair cannot change any output, so the DP stops there
    q_batch, q_lens, r_batch, r_lens = pack_pairs(
        q_list, r_list, max(max(len(q) for q in q_list), 1),
        max(max(len(r) for r in r_list), 1))
    if band is not None:
        diffs = r_lens.astype(np.int64) - q_lens.astype(np.int64)
        lower = (-band - np.maximum(0, diffs)).astype(np.int32)
        upper = (band + np.maximum(0, -diffs)).astype(np.int32)
        lower, upper = (torch.from_numpy(x).to(dev) for x in (lower, upper))
    else:
        lower = upper = None
    score, end_i, end_j, moves = align_batch_device(
        *(torch.from_numpy(x).to(dev)
          for x in (q_batch, q_lens, r_batch, r_lens)),
        scoring, config, need_cigar, lower, upper)
    score = score.cpu().numpy()
    end_i = end_i.cpu().numpy()
    end_j = end_j.cpu().numpy()
    if need_cigar:
        moves = moves.cpu().numpy()
    results = []
    for b in range(len(q_list)):
        if need_cigar:
            cigar, si, sj = decode_traceback(moves[b], end_i[b], end_j[b],
                                             config)
        else:
            cigar, si, sj = [], 0, 0
        results.append(PairAlignment(
            score=int(score[b]), s1_start=si, s1_end=int(end_i[b]),
            s2_start=sj, s2_end=int(end_j[b]), cigar=cigar,
            s1_len=int(q_lens[b]), s2_len=int(r_lens[b])))
    return results
