"""Host half of the pairwise affine-gap (Gotoh) alignment module.

Counterpart of unicycler_tpu/ops/pairwise.py: the NEG sentinel and move
codes shared by every DP kernel, the free-end-gap AlignConfig, the Scoring
tuple, the RunCigar/PairAlignment result types, the full-matrix DP
(align_batch_device, the batched twin of the JAX _align_single) and its
host API align_pairs with the traceback decoder. The JAX package runs
this DP as a device program (a lax.scan over rows, vmapped over the
batch) and decodes the moves on the host; the port runs it as the
hand-written kernel csrc/pairwise.cu on a CUDA tensor (align_batch_cuda)
and as its plain PyTorch version on a CPU tensor (align_batch_plain: the
batch vectorised, the rows a Python loop, E a torch.cummax over columns).
On a CUDA device align_pairs also walks the moves on the card
(csrc/pairwise_walk.cu, walk_full_cuda), so only each pair's runs come
back; on the CPU it decodes them with decode_traceback.

Scoring convention (matches SeqAn Score<int,Simple>(match, mismatch, ext,
open) used throughout the reference): a gap of length L costs
open + (L-1)*ext, with scores as (possibly negative) integers.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils import trace
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


# csrc/pairwise.cu's plan (pairwise_plan): at most MAX_THREADS threads a
# block, MAX_CLUSTER blocks a pair and MAX_ROWS rows a thread, so a stripe
# holds at most MAX_STRIPE_ROWS rows; a taller pair runs in stripes that
# pass their last row through a scratch of (B, 2, 2, m4) int32 (H and F
# by stripe parity, m4 = m_pad + 1 rounded up to 4)
MAX_THREADS, MAX_CLUSTER, MAX_ROWS = 256, 8, 4
MAX_STRIPE_ROWS = MAX_CLUSTER * MAX_THREADS * MAX_ROWS
# the kernel stages the reference in shared memory up to this many bases
# (m_pad + 4 rounded up to 16) and reads it from device memory above
SMEM_COLS = 163840


def moves_stride(m_pad):
    """csrc/pairwise.cu's row stride of the moves (its moves_stride):
    m_pad + 1 bytes rounded up to 16, so that each
    aligned 16-byte group of moves lies in one row; align_batch_cuda
    returns the (B, n_pad, m_pad + 1) view of that buffer."""
    return (int(m_pad) + 16) // 16 * 16


def caps_width(n_pad, m_pad):
    """Row width of csrc/pairwise.cu's end-cell scratch (its caps_width):
    row n_act's H over m_pad + 1 columns rounded up
    to 4, then column m_act's H over rows 0 .. n_pad rounded up to 4."""
    return (int(m_pad) + 4) // 4 * 4 + (int(n_pad) + 4) // 4 * 4


def full_plan(n_pad):
    """(rows a thread R, threads a block, blocks a cluster, stripes) of
    csrc/pairwise.cu for a call whose longest pair has n_pad rows (the
    kernel's pairwise_plan): R = 1 below 256 rows, 2 up to what one
    stripe of R = 2 holds (4,096), 4 beyond; about 128 of the pair's
    threads a block, up to MAX_CLUSTER blocks."""
    n = max(int(n_pad), 1)
    rows = MAX_ROWS if n > 2 * MAX_CLUSTER * MAX_THREADS \
        else (2 if n >= 256 else 1)
    need = -(-n // rows)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * 128 < need:
        cluster *= 2
    threads = min(MAX_THREADS,
                  -(-(-(-n // (cluster * rows))) // 32) * 32)
    return rows, threads, cluster, -(-n // (cluster * threads * rows))


def align_batch_cuda(q_batch, q_lens, r_batch, r_lens, scoring: Scoring,
                     config: AlignConfig, need_moves: bool,
                     lower_diags=None, upper_diags=None, plan=None):
    """Launch csrc/pairwise.cu: align_batch_plain's contract, with moves
    rows at and past each pair's n_act and columns past its m_act
    unspecified; the moves are the (B, n_pad, m_pad + 1) view of a buffer
    whose rows are moves_stride(m_pad) bytes. Bases int8, lengths and
    diagonals int32, all contiguous on one CUDA device; lengths above the
    padding are clamped to it.
    plan = (rows a thread, threads a block, blocks a cluster) overrides
    the kernel's own (full_plan) for measurements."""
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
    moves = torch.empty((B, n_pad, moves_stride(m_pad)), dtype=torch.uint8,
                        device=dev)[:, :, :m_pad + 1] if need_moves else None
    if B == 0:
        return score, end_i, end_j, moves
    rows = MAX_STRIPE_ROWS if plan is None else plan[0] * plan[1] * plan[2]
    scratch = torch.empty((B, 2, 2, (m_pad + 4) // 4 * 4),
                          dtype=torch.int32, device=dev) \
        if n_pad > rows else None
    caps = torch.empty((B, caps_width(n_pad, m_pad)), dtype=torch.int32,
                       device=dev)
    ptr = lambda x: x.data_ptr() if x is not None else None
    lib = cuda_lib.lib()
    args = [q_batch.data_ptr(), r_batch.data_ptr(), q_lens.data_ptr(),
            r_lens.data_ptr(), ptr(lower_diags), ptr(upper_diags),
            ptr(moves), score.data_ptr(), end_i.data_ptr(),
            end_j.data_ptr(), ptr(scratch), caps.data_ptr(), B, n_pad, m_pad,
            int(scoring.match), int(scoring.mismatch),
            int(scoring.gap_open), int(scoring.gap_extend),
            int(config.free_start_s1), int(config.free_start_s2),
            int(config.free_end_s1), int(config.free_end_s2)]
    with cuda_lib.timed('pairwise', dev, (q_lens, r_lens, n_pad, m_pad,
                                          need_moves)):
        if plan is None:
            err = lib.pairwise_launch(*args, cuda_lib.stream_ptr(dev))
        else:
            err = lib.pairwise_launch_plan(*args, *plan,
                                           cuda_lib.stream_ptr(dev))
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


# ---------------------------------------------------------------------------
# The walk on the card
# ---------------------------------------------------------------------------

# a walk's output row: WALK_HEAD header words (score, end_i, end_j, the run
# count, start_i, start_j), then walk_ops(n_pad, m_pad) (count, op) runs in
# walk order (the path's last run first) with op 0 M, 1 I, 2 D
WALK_HEAD = 6
_OP_CODES = {'M': 0, 'I': 1, 'D': 2}


def walk_ops(n_pad, m_pad):
    """Room for runs a pair (the native decoder's max_ops)."""
    return int(n_pad) + int(m_pad) + 17


def _walk_args(moves, score, end_i, end_j):
    B, n_pad, m1 = moves.shape
    return B, n_pad, m1 - 1, WALK_HEAD + 2 * walk_ops(n_pad, m1 - 1)


def walk_full_plain(moves, score, end_i, end_j, config: AlignConfig):
    """decode_traceback pair by pair over the forward's outputs (moves (B,
    n_pad, m_pad + 1) uint8; score, end_i, end_j (B,) int32), packed into
    walk_full_cuda's layout: (B, WALK_HEAD + 2 * walk_ops) int32 on the
    moves' device. Only each pair's header and its first run-count runs
    are defined (compare through walk_records)."""
    B, n_pad, m_pad, width = _walk_args(moves, score, end_i, end_j)
    host_moves = moves.cpu().numpy()
    heads = torch.stack([score, end_i, end_j]).cpu().numpy()
    out = np.zeros((B, width), np.int32)
    for b in range(B):
        cigar, si, sj = decode_traceback(host_moves[b], heads[1, b],
                                         heads[2, b], config)
        runs = [(c, _OP_CODES[op]) for c, op in reversed(cigar)]
        out[b, :WALK_HEAD] = (heads[0, b], heads[1, b], heads[2, b],
                              len(runs), si, sj)
        if runs:
            out[b, WALK_HEAD:WALK_HEAD + 2 * len(runs)] = \
                np.asarray(runs, np.int32).ravel()
    return torch.from_numpy(out).to(moves.device)


def walk_full_cuda(moves, score, end_i, end_j, config: AlignConfig):
    """Launch csrc/pairwise_walk.cu: walk_full_plain's output on the card,
    from align_batch_cuda's outputs on one CUDA device (score and ends
    contiguous; the moves 16-byte aligned with unit column stride, rows
    of any stride, as align_batch_cuda's view or a contiguous tensor).
    Slots past a pair's runs are unspecified."""
    dev = moves.device
    if dev.type != 'cuda':
        raise ValueError('walk_full_cuda needs CUDA tensors, not %s' % dev)
    B = moves.shape[0]
    for name, x, dt, dim in (('score', score, torch.int32, 1),
                             ('end_i', end_i, torch.int32, 1),
                             ('end_j', end_j, torch.int32, 1)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or x.dim() != dim or x.shape[0] != B:
            raise ValueError('%s must be a contiguous %dD %s tensor of %d '
                             'rows on %s' % (name, dim, dt, B, dev))
    if moves.device != dev or moves.dtype != torch.uint8 or moves.dim() != 3 \
            or moves.shape[0] != B or moves.stride(2) != 1 \
            or moves.stride(0) != moves.shape[1] * moves.stride(1) \
            or moves.stride(1) < moves.shape[2] or moves.data_ptr() % 16:
        raise ValueError('moves must be a (B, n_pad, m_pad + 1) uint8 tensor '
                         'of unit column stride and packed rows, 16-byte '
                         'aligned, on %s' % dev)
    B, n_pad, m_pad, width = _walk_args(moves, score, end_i, end_j)
    out = torch.empty((B, width), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    lib = cuda_lib.lib()
    with cuda_lib.timed('pairwise_walk', dev, (out,)):
        err = lib.pairwise_walk_launch(
            moves.data_ptr(), score.data_ptr(), end_i.data_ptr(),
            end_j.data_ptr(), out.data_ptr(), B, n_pad, m_pad,
            moves.stride(1), int(config.free_start_s1),
            int(config.free_start_s2),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'pairwise_walk')
    cuda_lib.LAUNCHES['pairwise_walk'] += 1
    return out


def walk_records(out):
    """Each pair's defined part of a walk output (host numpy or a tensor):
    (header tuple, runs tuple) a pair."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    recs = []
    for row in out:
        n = int(row[3])
        recs.append((tuple(int(x) for x in row[:WALK_HEAD]),
                     tuple(int(x) for x in
                           row[WALK_HEAD:WALK_HEAD + 2 * n])))
    return recs


def pairs_from_walk(host, q_lens, r_lens):
    """PairAlignments from a host walk output: the runs reversed into
    decode_traceback's [(count, op)] lists."""
    results = []
    for b, row in enumerate(host):
        n = int(row[3])
        runs = row[WALK_HEAD:WALK_HEAD + 2 * n].reshape(n, 2)[::-1]
        cigar = list(zip(runs[:, 0].tolist(),
                         _OP_CHARS[runs[:, 1]].tolist()))
        results.append(PairAlignment(
            score=int(row[0]), s1_start=int(row[4]), s1_end=int(row[1]),
            s2_start=int(row[5]), s2_end=int(row[2]), cigar=cigar,
            s1_len=int(q_lens[b]), s2_len=int(r_lens[b])))
    return results


def align_pairs(q_list, r_list, scoring=DEFAULT_SCORING, config=SEMI_GLOBAL,
                need_cigar=True, band=None, device=None):
    """Host API: align code-array pairs on `device` (default CUDA), return
    PairAlignments.

    All pairs are padded into one rectangular batch (callers should bucket
    by length for efficiency). When `band` is given, the DP is restricted
    to the SeqAn-style diagonal band expanded by the length difference
    (ref global_align.cpp:56-75): lower = -band - max(0, m-n),
    upper = band + max(0, n-m).

    On a CUDA device the moves are walked on the card (walk_full_cuda)
    and one copy brings the scores, ends, runs and starts back; the moves
    never leave the card. On the CPU decode_traceback walks them. Spans
    `pack` (padding and upload), `fetch` (the copy to the host; counter
    full_dp.fetch_bytes) and `decode` (PairAlignments from what came back)
    nest under the caller's.
    """
    from ..device import resolve_device
    from .encode import pack_pairs
    if not q_list:
        return []
    dev = resolve_device(device)
    with trace.span('pack'):
        # the JAX package pads to length buckets; rows and columns past the
        # longest pair cannot change any output, so the DP stops there
        q_batch, q_lens, r_batch, r_lens = pack_pairs(
            q_list, r_list, max(max(len(q) for q in q_list), 1),
            max(max(len(r) for r in r_list), 1))
        if band is not None:
            diffs = r_lens.astype(np.int64) - q_lens.astype(np.int64)
            lower = (-band - np.maximum(0, diffs)).astype(np.int32)
            upper = (band + np.maximum(0, -diffs)).astype(np.int32)
            lower, upper = (torch.from_numpy(x).to(dev)
                            for x in (lower, upper))
        else:
            lower = upper = None
        inputs = [torch.from_numpy(x).to(dev)
                  for x in (q_batch, q_lens, r_batch, r_lens)]
    score, end_i, end_j, moves = align_batch_device(
        *inputs, scoring, config, need_cigar, lower, upper)
    if dev.type == 'cuda' and need_cigar:
        out = walk_full_cuda(moves, score, end_i, end_j, config)
        del moves
        with trace.span('fetch'):
            host = out.cpu().numpy()
        trace.add('full_dp.fetch_bytes', host.nbytes)
        with trace.span('decode'):
            return pairs_from_walk(host, q_lens, r_lens)
    with trace.span('fetch'):
        heads = torch.stack([score, end_i, end_j]).cpu().numpy()
        if need_cigar:
            moves = moves.cpu().numpy()
    if dev.type != 'cpu':
        trace.add('full_dp.fetch_bytes', heads.nbytes)
    score, end_i, end_j = heads
    results = []
    with trace.span('decode'):
        for b in range(len(q_list)):
            if need_cigar:
                cigar, si, sj = decode_traceback(moves[b], end_i[b],
                                                 end_j[b], config)
            else:
                cigar, si, sj = [], 0, 0
            results.append(PairAlignment(
                score=int(score[b]), s1_start=si, s1_end=int(end_i[b]),
                s2_start=sj, s2_end=int(end_j[b]), cigar=cigar,
                s1_len=int(q_lens[b]), s2_len=int(r_lens[b])))
    return results
