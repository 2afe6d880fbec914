"""Bucketed per-task banded Gotoh DP: the CUDA kernel and its plain
PyTorch version.

Counterpart of unicycler_tpu/ops/pallas_banded.py (pallas_banded_batch)
and of the XLA scan it is the twin of, unicycler_tpu/ops/banded.py
(_banded_single / banded_batch_device). Each task is one padded query of
n_pad rows, its reference window padded with W sentinel bases on each
side, and a per-row band offset c[i] (row i covers reference columns
[c[i], c[i] + W)). The outputs are the AlignConfig-selected (score,
end_i, end_j) and, with need_moves, the 4-bit moves of every row in
nibble-plane layout ((B, n_pad, W/8) int32: word w holds lanes
{w, w + W/8, ..., w + 7W/8}), which native/cigar_decode.cpp walks.

The corridor's rows drift right by 0..MAX_SHIFT columns (c[i] - c[i - 1];
ops/banded.build_corridor caps them so), as the TPU kernel requires.
Moves rows at and past a task's n_act are unspecified: the CUDA kernel
stops each task after its row n_act (score and ends do not depend on
later rows, and every walk starts at end_i <= n_act), so compare moves
over rows [0, n_act) (moves_rows_real). The plain version still computes
every row.

banded_batch launches csrc/banded.cu for tensors on a CUDA device and
runs banded_batch_plain, the row-by-row twin of _banded_single, only for
tensors on the CPU: that twin is the CPU route's DP.
"""

import torch

from . import cuda_lib
from .pairwise import (DIAG, E_EXT_BIT, E_SRC, F_EXT_BIT, F_SRC, NEG,
                       AlignConfig, Scoring)
from .tape import MAX_SHIFT

BT = 32          # retry batches are padded to a multiple of this
# the widest band of csrc/banded.cu's fast kernel; wider bands take its
# wide kernel, which needs WIDE_SCRATCH ints of scratch a lane and task
FAST_MAX_W = 4096
WIDE_SCRATCH = 10
# lanes x tasks of one slice of the CPU route's plain DP
PLAIN_SLICE_CELLS = 1 << 17


def moves_rows_real(moves, n_acts):
    """moves with every row at or past its task's n_act zeroed: the rows
    the CUDA kernel defines."""
    rows = torch.arange(moves.shape[1], device=moves.device)[None, :]
    keep = rows < n_acts.to(moves.device).to(torch.int64)[:, None]
    return torch.where(keep[:, :, None], moves, 0)


def banded_batch_plain(q, r_ext, c, n_acts, m_acts, scoring: Scoring,
                       config: AlignConfig, W: int, need_moves: bool):
    """Plain PyTorch twin of the XLA _banded_single, batched over tasks.
    q: (B, n_pad) int8; r_ext: (B, m_pad + 2W) int8; c: (B, n_pad + 1)
    int32; n_acts, m_acts: (B,). Returns (score, end_i, end_j) (B,) int32
    and moves (B, n_pad, W/8) int32 (None without need_moves). Scores are
    int32 as in _banded_single (NEG = -2^30 leaves room for every
    addition); each row reads its up and diagonal cells from h and f
    padded with NEG on both sides (a row drifts 0..MAX_SHIFT columns)."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    B, n_pad = q.shape
    dev = q.device
    i32, i64 = torch.int32, torch.int64
    ks = torch.arange(W, device=dev, dtype=i32)[None, :]
    ks64 = ks.to(i64)
    c64 = c.to(i64)
    c = c.to(i32)
    n_act = n_acts.to(i32)[:, None]
    m_act = m_acts.to(i32)[:, None]
    q8 = q.to(torch.int8)
    r8 = r_ext.to(torch.int8)
    neg1 = torch.full((B, 1), NEG, dtype=i32, device=dev)
    neg_right = torch.full((B, MAX_SHIFT + 1), NEG, dtype=i32, device=dev)
    ext_ks = ks * ext
    e_start = open_ - (ks + 1) * ext

    j0 = c[:, :1] + ks
    if config.free_start_s2:
        h0 = torch.where(j0 >= 0, 0, NEG)
    else:
        h0 = torch.where(j0 > 0, open_ + (j0 - 1) * ext,
                         torch.where(j0 == 0, 0, NEG))
    h0 = torch.where(j0 > m_act, NEG, h0).to(i32)
    h = h0
    f = torch.full((B, W), NEG, dtype=i32, device=dev)
    h_at_n = torch.where(n_act == 0, h0, NEG)
    lastcol = torch.empty((B, n_pad), dtype=i32, device=dev)
    moves = torch.empty((B, n_pad, W // 8), dtype=torch.int32, device=dev) \
        if need_moves else None
    w8 = W // 8

    for i in range(1, n_pad + 1):
        ci = c[:, i:i + 1]
        qi = q8[:, i - 1:i]
        rwin = torch.gather(r8, 1, c64[:, i:i + 1] + (W - 1) + ks64)
        j = ci + ks
        valid = (j >= 0) & (j <= m_act)
        # lane k's up cell is lane k + si of the previous row, its
        # diagonal lane k + si - 1 (NEG outside the band)
        up = ks64 + (c64[:, i:i + 1] - c64[:, i - 1:i]) + 1
        h_pad = torch.cat([neg1, h, neg_right], 1)
        h_up = torch.gather(h_pad, 1, up)
        h_diag = torch.gather(h_pad, 1, up - 1)
        f_up = torch.gather(torch.cat([neg1, f, neg_right], 1), 1, up)

        f_ext_v = f_up + ext
        f = torch.maximum(h_up + open_, f_ext_v)
        f_ext_bit = (f == f_ext_v) & (f_up > NEG // 2)

        sub = torch.where(qi == rwin, match_s, mismatch).to(i32)
        j_pos = j >= 1
        diag = torch.where(j_pos & (j <= m_act), h_diag + sub, NEG)
        hb = 0 if config.free_start_s1 else open_ + (i - 1) * ext
        diag = torch.where(j == 0, hb, diag)
        g = torch.maximum(diag, torch.where(j_pos, f, NEG))

        cmax = torch.cummax(g + e_start, 1).values
        e = torch.cat([neg1, cmax[:, :-1]], 1) + ext_ks
        e = torch.where(j_pos & (e >= NEG // 2), e, NEG)

        h = torch.where(valid, torch.maximum(g, e), NEG)

        if need_moves:
            e_prev = torch.cat([neg1, e[:, :-1]], 1)
            e_ext_bit = (e == e_prev + ext) & (e_prev > NEG // 2)
            m4 = torch.where(h == diag, DIAG,
                             torch.where(h == e, E_SRC, F_SRC)).to(i32)
            m4 = m4 | (e_ext_bit.to(i32) * E_EXT_BIT) \
                | (f_ext_bit.to(i32) * F_EXT_BIT)
            # nibble planes: word w holds lanes w, w + W/8, ..., w + 7W/8
            packed = m4[:, :w8]
            for g8 in range(1, 8):
                packed = packed | (m4[:, g8 * w8:(g8 + 1) * w8] << (4 * g8))
            moves[:, i - 1, :] = packed

        h_at_n = torch.where(n_act == i, h, h_at_n)
        k_last = m_act - ci
        in_band = (k_last >= 0) & (k_last < W)
        lastcol[:, i - 1:i] = torch.where(
            in_band & (i <= n_act),
            torch.gather(h, 1, k_last.clamp(0, W - 1).to(i64)), NEG)

    # end selection, in _banded_single's order and tie rules
    h_at_n, lastcol, h0 = h_at_n.to(i64), lastcol.to(i64), h0.to(i64)
    n_act, m_act = n_act.to(i64), m_act.to(i64)
    bidx = torch.arange(B, device=dev)
    c_n = c64[bidx, n_act[:, 0]][:, None]
    k_corner = m_act - c_n
    corner = torch.where((k_corner >= 0) & (k_corner < W),
                         torch.gather(h_at_n, 1, k_corner.clamp(0, W - 1)),
                         NEG)[:, 0]
    best = corner
    end_i = n_act[:, 0]
    end_j = m_act[:, 0]
    if config.free_end_s2:
        row_vals = torch.where(c_n + ks64 <= m_act, h_at_n, NEG)
        s, k_best = _first_argmax(row_vals)
        better = s > best
        end_j = torch.where(better, c_n[:, 0] + k_best, end_j)
        best = torch.maximum(best, s)
    if config.free_end_s1:
        rows = torch.arange(1, n_pad + 1, device=dev, dtype=i64)[None, :]
        col_vals = torch.where(rows <= n_act, lastcol, NEG)
        k0 = m_act - c64[:, :1]
        row0 = torch.where((k0 >= 0) & (k0 < W),
                           torch.gather(h0, 1, k0.clamp(0, W - 1)), NEG)
        s, i_best = _first_argmax(torch.cat([row0, col_vals], 1))
        better = s > best
        end_i = torch.where(better, i_best, end_i)
        end_j = torch.where(better, m_act[:, 0], end_j)
        best = torch.maximum(best, s)
    return (best.to(torch.int32), end_i.to(torch.int32),
            end_j.to(torch.int32), moves)


def _first_argmax(x):
    """(max, index of its FIRST occurrence) along dim 1 (jnp.argmax's tie
    rule, which torch.argmax does not promise)."""
    v = x.amax(1, keepdim=True)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    first = torch.where(x == v, idx, x.shape[1]).amin(1)
    return v[:, 0], first


def banded_batch_cuda(q, r_ext, c, n_acts, m_acts, scoring: Scoring,
                      config: AlignConfig, W: int, need_moves: bool,
                      lanes=0):
    """Launch csrc/banded.cu; banded_batch_plain's contract, with moves
    rows at and past each task's n_act unspecified. `lanes` forces the
    fast kernel's lanes a thread (2, 4 or 8; 0: its default), for
    measuring."""
    B, n_pad = q.shape
    dev = q.device
    for name, x, dt in (('q', q, torch.int8), ('r_ext', r_ext, torch.int8),
                        ('c', c, torch.int32), ('n_acts', n_acts, torch.int32),
                        ('m_acts', m_acts, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError('%s must be a contiguous %s tensor on %s'
                             % (name, dt, dev))
    if c.shape != (B, n_pad + 1) or r_ext.shape[0] != B \
            or r_ext.shape[1] < 2 * W or W % 128 or W < 128:
        raise ValueError('inconsistent banded batch shapes')
    drift = c[:, 1:] - c[:, :-1]
    if bool(((drift < 0) | (drift > MAX_SHIFT)).any()):
        raise ValueError('corridor rows must drift right by 0..%d columns'
                         % MAX_SHIFT)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    end_i = torch.empty(B, dtype=torch.int32, device=dev)
    end_j = torch.empty(B, dtype=torch.int32, device=dev)
    moves = torch.empty((B, n_pad, W // 8), dtype=torch.int32, device=dev) \
        if need_moves else None
    scratch = torch.empty((B, WIDE_SCRATCH * W), dtype=torch.int32,
                          device=dev) if W > FAST_MAX_W else None
    lib = cuda_lib.lib()
    with cuda_lib.timed('banded', dev, (q, r_ext, c, n_acts,
                                           cuda_lib.shape_only(moves))):
        err = lib.banded_launch(
            q.data_ptr(), n_pad, r_ext.data_ptr(), r_ext.shape[1],
            c.data_ptr(), n_acts.data_ptr(), m_acts.data_ptr(),
            moves.data_ptr() if need_moves else None, score.data_ptr(),
            end_i.data_ptr(), end_j.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, B, W,
            int(scoring.match), int(scoring.mismatch),
            int(scoring.gap_open), int(scoring.gap_extend),
            int(config.free_start_s1), int(config.free_start_s2),
            int(config.free_end_s1), int(config.free_end_s2), int(lanes),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'banded')
    cuda_lib.LAUNCHES['banded'] += 1
    return score, end_i, end_j, moves


def banded_batch(q, r_ext, c, n_acts, m_acts, scoring: Scoring,
                 config: AlignConfig, W: int, need_moves: bool):
    """Banded DP over a padded batch on the tensors' device."""
    args = (q.to(torch.int8).contiguous(), r_ext.to(torch.int8).contiguous(),
            c.to(torch.int32).contiguous(),
            n_acts.to(torch.int32).contiguous(),
            m_acts.to(torch.int32).contiguous())
    if q.device.type == 'cuda':
        return banded_batch_cuda(*args, scoring, config, W, need_moves)
    if q.device.type == 'cpu':
        # tasks are independent: the CPU route runs them in slices whose
        # row tensors stay in cache (~5x faster than one wide slice)
        step = max(1, PLAIN_SLICE_CELLS // W)
        if q.shape[0] <= step:
            return banded_batch_plain(*args, scoring, config, W, need_moves)
        parts = [banded_batch_plain(*(a[s:s + step] for a in args), scoring,
                                    config, W, need_moves)
                 for s in range(0, q.shape[0], step)]
        return tuple(torch.cat(p) if p[0] is not None else None
                     for p in zip(*parts))
    raise ValueError('unsupported device %s' % q.device)


def banded_with_traceback(q, r_ext, c, n_acts, m_acts, scoring: Scoring,
                          config: AlignConfig, W: int):
    """Forward DP and the traceback walk on the tensors' device (the JAX
    package's pallas_banded_with_traceback): the moves stay on the device
    and 4-byte row records come back. Returns (score, end_i, end_j,
    records (B, n_pad), final (B, 3), moves); the moves are returned for
    the caller to fetch the rows of band-escaped walks only."""
    from .traceback_kernels import banded_traceback
    score, end_i, end_j, moves = banded_batch(q, r_ext, c, n_acts, m_acts,
                                              scoring, config, W, True)
    records, final = banded_traceback(moves, c[:, 1:], end_i, end_j, W)
    return score, end_i, end_j, records, final, moves
