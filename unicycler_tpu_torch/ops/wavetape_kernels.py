"""Wavefront-tape forward DP and traceback walker: CUDA kernels, their
plain PyTorch versions, and the host decode of the walker's records.

Counterpart of unicycler_tpu/ops/pallas_wavetape.py. The forward kernel
(csrc/wavetape_fwd.cu) is an anti-diagonal affine-gap (Gotoh) banded DP
over a tape of tasks: lanes are diagonals, each group of G = 32
wavefronts has a fixed diagonal window [dbase_g, dbase_g + W), and the
carries realign between groups by the group's advance. Per task it keeps
the corner cell, the best row-n value (smallest j wins ties) and the best
column-m value (smallest i wins ties); end selection by AlignConfig
happens here, after the kernel. The walker (csrc/wavetape_walk.cu) walks
the forward kernel's 4-bit moves back from each task's end cell and emits
per-wavefront path records, decoded on the host by wave_records_to_cigar.

The wrappers (wavetape_forward, wavetape_traceback) launch the CUDA
kernels for tensors on a CUDA device and run the plain versions only for
tensors on the CPU. The plain versions repeat the kernels' arithmetic lane
for lane (shadow lanes and masked lanes included), so kernel and plain
version agree bit for bit; the tests hold the plain versions against the
JAX package's interpret-mode kernels.
"""

import numpy as np
import torch

from . import cuda_lib
from .pairwise import NEG, AlignConfig, RunCigar, Scoring
from .wavetape import G

_BIG = 1 << 30
NEG_HALF = NEG // 2
# band widths the wave kernels take: every ops/banded.band_width up to
# ops/banded.WAVE_MAX_W
WAVE_WIDTHS = (128, 256, 384, 512, 1024, 2048)

# fields of the per-(track, group) plane handed to the forward kernel
(P_DB, P_ADV, P_RST, P_HIT, P_A0, P_N2, P_M2, P_SQ, P_SR) = range(9)
N_FIELDS = 9


def _region_width(W):
    return (W + G + 127) // 128 * 128


def group_plane(adv8, gflags, n_t, m_t, r_base, rowbase, dbase0, a0, seg_g,
                LR, M, W):
    """Per-(track, group) scalars of one launch, (B, NG, 9) int32, plus the
    window base of every group (B, NG) int64.

    Fields: window base diagonal dbase_g, carry advance at group entry,
    reset flag, capture flag (set when some wavefront of this track's
    group crosses its task's row n or column m; the TPU kernel gated on
    the OR over all tracks, which changes no output: a group of the track
    that crosses neither captures only NEG, so its merge is a no-op), the
    task-local wavefront of the group's first step, 2*n and 2*m of the
    owning task, and the start offsets sq / sr of the group's query and
    reference windows in half-base units (the TPU kernel's repeat-2 lane
    tapes: lane k of step t reads q_tape[(sq + G-1-t + k) >> 1] and
    r_flat[(sr + t + k) >> 1]), clipped exactly as the TPU kernel clipped
    them."""
    B, NG = adv8.shape
    dev = adv8.device
    gfl = gflags.to(torch.int64)
    rst = gfl & 1
    hit = (gfl >> 1) & 1
    seg = (torch.cumsum(rst, 1) - 1).clamp(min=0)

    def take(x):
        return torch.gather(x.to(torch.int64), 1, seg)

    dbase_g = torch.cumsum(adv8.to(torch.int64), 1) + take(dbase0)
    g_idx = torch.arange(NG, device=dev, dtype=torch.int64)[None, :]
    a_g0 = take(a0) + (g_idx - take(seg_g)) * G
    n_g = take(n_t)
    rowb = take(rowbase)
    rb = take(r_base) + W
    GWp = _region_width(W)
    kq = a_g0 + G - 1 - dbase_g
    sq = (2 * (rowb + n_g) + 1 - kq).clamp(0, 2 * LR - GWp - 128)
    kr = a_g0 + dbase_g
    sr = (2 * (rb - 1) + kr).clamp(0, 2 * M - GWp - 128)
    plane = torch.stack([dbase_g, adv8.to(torch.int64), rst, hit, a_g0,
                         2 * n_g, 2 * take(m_t), sq, sr], -1)
    return plane.to(torch.int32).contiguous(), dbase_g


def track_groups(lastg):
    """Real groups of each track, (B,) int32: its last task's lastg + 1
    (0 for a track with no task). The forward kernel stops there."""
    return (lastg.to(torch.int64).amax(1) + 1).clamp(min=0).to(torch.int32)


def real_groups(moves, best, ngt):
    """moves and best with every group at or past its track's real group
    count zeroed: what the forward kernel defines (it skips the padding)
    and its plain version computes too."""
    B, NG = best.shape[:2]
    keep = torch.arange(NG, device=best.device)[None, :] \
        < ngt.to(best.device).to(torch.int64)[:, None]
    best = torch.where(keep[:, :, None], best, 0)
    if moves is not None:
        keep_rows = keep.repeat_interleave(G // 8, dim=1)
        moves = torch.where(keep_rows[:, :, None], moves, 0)
    return moves, best


def _to_int32_bits(x):
    """int64 words holding 32-bit patterns -> int32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def wavetape_forward_plain(q_tape, r_flat, plane, scoring: Scoring,
                           config: AlignConfig, W: int, need_moves: bool):
    """Plain PyTorch version of the forward kernel. Returns (moves
    (B, NG*G/8, W) int32 or None, best (B, NG, 5) int32): best holds each
    group's running (corner, row-n value, its j, column-m value, its i).
    It computes every group, a track's padding past its last task
    included, so on the JAX package's layout it equals the Pallas kernel
    in full; the CUDA kernel stops at each track's last real group."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    B, NG, _ = plane.shape
    dev = q_tape.device
    i64 = torch.int64
    pl = plane.to(i64)
    q = q_tape.to(i64)
    r = r_flat.to(i64)
    lane = torch.arange(W, device=dev, dtype=i64)[None, :]
    negw = torch.full((B, W), NEG, dtype=i64, device=dev)
    neg1 = torch.full((B, 1), NEG, dtype=i64, device=dev)
    h1, h2, e, f = negw, negw, negw, negw
    cor, rnv, lcv = neg1, neg1, neg1
    rnj = torch.zeros((B, 1), dtype=i64, device=dev)
    lci = rnj
    best = torch.empty((B, NG, 5), dtype=i64, device=dev)
    moves = torch.empty((B, NG * (G // 8), W), dtype=i64, device=dev) \
        if need_moves else None

    def shift_left(x):        # out[k] = x[k + 1], NEG at the top lane
        return torch.cat([x[:, 1:], neg1], 1)

    def shift_right(x):       # out[k] = x[k - 1], NEG at lane 0
        return torch.cat([neg1, x[:, :-1]], 1)

    for g in range(NG):
        p = pl[:, g, :]
        c0w, adv, rst = p[:, P_DB:P_DB + 1], p[:, P_ADV:P_ADV + 1], \
            p[:, P_RST:P_RST + 1]
        hit_t = p[:, P_HIT:P_HIT + 1] == 1       # each track's own gate
        hit = bool(hit_t.any())
        ag0, n2, m2 = p[:, P_A0:P_A0 + 1], p[:, P_N2:P_N2 + 1], \
            p[:, P_M2:P_M2 + 1]
        sq, sr = p[:, P_SQ:P_SQ + 1], p[:, P_SR:P_SR + 1]
        mm, nn = m2 >> 1, n2 >> 1

        if bool((adv != 0).any()):
            src = lane + adv
            ok = (src >= 0) & (src < W)
            idx = src.clamp(0, W - 1)
            h1, h2, e, f = (torch.where(ok, torch.gather(x, 1, idx), NEG)
                            for x in (h1, h2, e, f))
        rst_b = rst == 1
        h1, h2, e, f = (torch.where(rst_b, NEG, x) for x in (h1, h2, e, f))
        cor = torch.where(rst_b, NEG, cor)
        rnv = torch.where(rst_b, NEG, rnv)
        rnj = torch.where(rst_b, 0, rnj)
        lcv = torch.where(rst_b, NEG, lcv)
        lci = torch.where(rst_b, 0, lci)

        hat_l, cor_l, lcv_l = negw, negw, negw
        lci_l = torch.zeros((B, W), dtype=i64, device=dev)
        mv_acc = None
        for t in range(G):
            a = ag0 + t
            u = a - c0w
            jv = a + c0w
            qv = torch.gather(q, 1, (sq + (G - 1 - t) + lane) >> 1)
            rv = torch.gather(r, 1, (sr + t + lane) >> 1)

            fl = shift_left(f)
            er = shift_right(e)
            f_new = torch.maximum(shift_left(h1) + open_, fl + ext)
            f_ext_bit = (f_new == fl + ext) & (fl > NEG_HALF)
            e_new = torch.maximum(shift_right(h1) + open_, er + ext)
            e_ext_bit = (e_new == er + ext) & (er > NEG_HALF)
            e_new = torch.where(e_new > NEG_HALF, e_new, NEG)

            sub = torch.where(qv == rv, match_s, mismatch)
            i1n = (lane <= u - 2) & (lane >= u - n2)
            jge1 = lane >= 2 - jv
            jge0 = lane >= -jv
            jlem = lane <= m2 - jv
            diag = torch.where(i1n & jge1 & jlem, h2 + sub, NEG)
            if config.free_start_s1:
                col0 = torch.zeros_like(a)
            else:
                col0 = open_ + (a - 1) * ext
            diag = torch.where(i1n & (lane == -jv), col0, diag)
            e_m = torch.where(jge1, e_new, NEG)
            gg = torch.maximum(diag, torch.where(jge1, f_new, NEG))
            h = torch.maximum(gg, e_m)
            h = torch.where(i1n & jge0 & jlem, h, NEG)

            if need_moves:
                hsrc = torch.where(h == diag, 0, torch.where(h == e_m, 1, 2))
                m4 = hsrc | (e_ext_bit.to(i64) << 2) | (f_ext_bit.to(i64) << 3)
                sh = 4 * (t % 8)
                mv_acc = m4 if sh == 0 else mv_acc | (m4 << sh)
                if t % 8 == 7:
                    moves[:, g * (G // 8) + t // 8, :] = mv_acc

            if config.free_start_s2:
                h0v = torch.where(a >= 0, 0, NEG)
            else:
                h0v = torch.where(a > 0, open_ + (a - 1) * ext,
                                  torch.where(a == 0, 0, NEG))
            h0v = torch.where(a <= mm, h0v, NEG)
            h = torch.where(lane == u, h0v, h)

            if hit:
                rowm = (lane == u - n2) & hit_t
                hat_l = torch.where(rowm, h, hat_l)
                colm = (lane == m2 - jv) & hit_t
                cor_l = torch.where(rowm & colm, h, cor_l)
                lcm = colm & (u - lane >= 0) & (u - lane <= n2)
                hlc = torch.where(lcm, h, NEG)
                better = hlc > lcv_l
                lcv_l = torch.where(better, hlc, lcv_l)
                lci_l = torch.where(better, (u - lane) >> 1, lci_l)

            h2, h1, e, f = h1, h, e_new, f_new

        if hit:
            cor = torch.maximum(cor, cor_l.amax(1, keepdim=True))
            gv = hat_l.amax(1, keepdim=True)
            jlane = c0w + lane + nn
            gj = torch.where((hat_l == gv) & (gv > NEG_HALF), jlane,
                             _BIG).amin(1, keepdim=True)
            take = gv > rnv
            rnv = torch.where(take, gv, rnv)
            rnj = torch.where(take, gj, rnj)
            lgv = lcv_l.amax(1, keepdim=True)
            lgi = torch.where((lcv_l == lgv) & (lgv > NEG_HALF), lci_l,
                              _BIG).amin(1, keepdim=True)
            take2 = lgv > lcv
            lcv = torch.where(take2, lgv, lcv)
            lci = torch.where(take2, lgi, lci)
        best[:, g, :] = torch.cat([cor, rnv, rnj, lcv, lci], 1)

    return (_to_int32_bits(moves) if need_moves else None,
            best.to(torch.int32))


def wavetape_forward_cuda(q_tape, r_flat, plane, ngt, scoring: Scoring,
                          config: AlignConfig, W: int, need_moves: bool):
    """Launch csrc/wavetape_fwd.cu: the plain version's contract over each
    track's first ngt[b] groups (ngt: (B,) int32, track_groups); moves and
    best of the groups past them are left unwritten."""
    B, NG, nf = plane.shape
    dev = q_tape.device
    for name, x, dt in (('q_tape', q_tape, torch.uint8),
                        ('r_flat', r_flat, torch.int8),
                        ('plane', plane, torch.int32),
                        ('ngt', ngt, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError('%s must be a contiguous %s tensor on %s'
                             % (name, dt, dev))
    if nf != N_FIELDS or q_tape.shape[0] != B or r_flat.shape[0] != B \
            or tuple(ngt.shape) != (B,):
        raise ValueError('inconsistent launch shapes')
    if W not in WAVE_WIDTHS:
        raise ValueError('W = %d: the wave kernels take W in %s'
                         % (W, WAVE_WIDTHS))
    # the kernel copies 16-byte chunks of the tapes into shared memory
    for name, x in (('q_tape', q_tape), ('r_flat', r_flat)):
        if x.data_ptr() % 16 or x.shape[1] % 16:
            raise ValueError('%s rows must start on 16-byte boundaries'
                             % name)
    moves = torch.empty((B, NG * (G // 8), W), dtype=torch.int32,
                        device=dev) if need_moves else None
    best = torch.empty((B, NG, 5), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    shape = cuda_lib.shape_only
    with cuda_lib.timed('wavetape_fwd', dev, (
            shape(q_tape), shape(r_flat), shape(plane), ngt, shape(moves),
            shape(best))):
        err = lib.wavetape_fwd_launch(
            q_tape.data_ptr(), q_tape.shape[1], r_flat.data_ptr(),
            r_flat.shape[1], plane.data_ptr(), ngt.data_ptr(), B, NG,
            moves.data_ptr() if need_moves else None, best.data_ptr(), W,
            int(scoring.match), int(scoring.mismatch),
            int(scoring.gap_open), int(scoring.gap_extend),
            int(config.free_start_s1), int(config.free_start_s2),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'wavetape_fwd')
    cuda_lib.LAUNCHES['wavetape_fwd'] += 1
    return moves, best


def wavetape_forward(q_tape, r_flat, adv8, gflags, n_t, m_t, r_base,
                     rowbase, dbase0, a0, seg_g, lastg, scoring: Scoring,
                     config: AlignConfig, W: int, need_moves: bool):
    """Run the wavefront tape DP on the tensors' device. Returns (score,
    end_i, end_j) each (B, TT) int32, plus moves (B, LA/8, W) int32 (None
    without need_moves) and db_rows (B, LA) int32 for the walker."""
    B, NG = adv8.shape
    plane, dbase_g = group_plane(adv8, gflags, n_t, m_t, r_base, rowbase,
                                 dbase0, a0, seg_g, q_tape.shape[1],
                                 r_flat.shape[1], W)
    if q_tape.device.type == 'cuda':
        moves, best = wavetape_forward_cuda(q_tape, r_flat, plane,
                                            track_groups(lastg), scoring,
                                            config, W, need_moves)
    elif q_tape.device.type == 'cpu':
        moves, best = wavetape_forward_plain(q_tape, r_flat, plane, scoring,
                                             config, W, need_moves)
    else:
        raise ValueError('unsupported device %s' % q_tape.device)

    # end selection from each task's last-group scalars
    TT = n_t.shape[1]
    last = lastg.to(torch.int64).clamp(0, NG - 1)
    best_t = torch.gather(best, 1, last[:, :, None].expand(B, TT, 5))
    corner, rnv, rnj, lcv, lci = best_t.unbind(-1)
    n_t = n_t.to(torch.int32)
    m_t = m_t.to(torch.int32)
    score, end_i, end_j = corner, n_t, m_t
    if config.free_end_s2:
        better = rnv > score
        end_j = torch.where(better, rnj, end_j)
        end_i = torch.where(better, n_t, end_i)
        score = torch.maximum(score, rnv)
    if config.free_end_s1:
        better = lcv > score
        end_i = torch.where(better, lci, end_i)
        end_j = torch.where(better, m_t, end_j)
        score = torch.maximum(score, lcv)
    db_rows = dbase_g.repeat_interleave(G, dim=1).to(torch.int32)
    return score, end_i, end_j, moves, db_rows


def wavetape_traceback_plain(moves, db_rows, n_tasks, end_i, end_j, abase,
                             W: int):
    """Plain PyTorch version of the walker: every track steps at once, one
    loop iteration per path step. Returns (records (B, LA), fin
    (B, TT, 3)) int32; fin rows of tasks never walked stay 0."""
    B, LA = db_rows.shape
    TT = end_i.shape[1]
    dev = moves.device
    i64 = torch.int64
    mv = moves.to(i64)
    db = db_rows.to(i64)
    ei_t, ej_t, ab_t = end_i.to(i64), end_j.to(i64), abase.to(i64)
    rec = torch.zeros((B, LA), dtype=i64, device=dev)
    fin = torch.zeros((B, TT, 3), dtype=i64, device=dev)
    bidx = torch.arange(B, device=dev)
    task_k = n_tasks.to(i64) - 1
    kc = task_k.clamp(0, TT - 1)
    has = task_k >= 0
    i = torch.where(has, ei_t[bidx, kc], 0)
    j = torch.where(has, ej_t[bidx, kc], 0)
    ab = torch.where(has, ab_t[bidx, kc], 0)
    s = torch.zeros(B, dtype=i64, device=dev)
    cnt = torch.zeros(B, dtype=i64, device=dev)
    while True:
        addr = ab + i + j
        active = (task_k >= 0) & ((addr >= 0) | (i == 0)
                                  | ((j == 0) & (s == 0)))
        if not bool(active.any()):
            break
        row0 = i == 0
        col0 = ~row0 & (s == 0) & (j == 0)
        t = addr.clamp(0, LA - 1)
        lane = (j - i) - db[bidx, t]
        cell = (mv[bidx, t // 8, lane.clamp(0, W - 1)] >> (4 * (t % 8))) & 0xF
        escape = ~row0 & ~col0 & ((lane < 0) | (lane >= W))
        stopping = row0 | col0 | escape
        code = torch.where(row0, 0, torch.where(col0, 1, 2))
        act = torch.where(s == 1, 1, torch.where(s == 2, 2, cell & 3))
        is_m, is_d, is_i = act == 0, act == 1, act == 2
        e_ext = ((cell >> 2) & 1) == 1
        f_ext = ((cell >> 3) & 1) == 1
        ni = torch.where(is_m | is_i, i - 1, i)
        nj = torch.where(is_m | is_d, j - 1, j)
        ns = torch.where(is_d & e_ext & (nj > 0), 1,
                         torch.where(is_i & f_ext & (ni > 0), 2, 0))
        gap = is_d | is_i
        chain_end = gap & ((ns == 0) | (cnt >= 62))
        run_val = torch.where(is_d, 2, 3) | ((cnt + 1) << 2)
        write = active & ~(stopping | (gap & ~chain_end))
        val = torch.where(is_m, 1, run_val)
        rec[bidx[write], t[write]] = val[write]
        pub = active & stopping
        fin[bidx[pub], kc[pub]] = torch.stack([i, j, code], 1)[pub]
        ncnt = torch.where(stopping | (ns == 0) | (cnt >= 62), 0,
                           torch.where(gap, cnt + 1, 0))
        nk = task_k - 1
        nkc = nk.clamp(0, TT - 1)
        stop_a = active & stopping
        step_a = active & ~stopping
        i = torch.where(stop_a, ei_t[bidx, nkc], torch.where(step_a, ni, i))
        j = torch.where(stop_a, ej_t[bidx, nkc], torch.where(step_a, nj, j))
        ab = torch.where(stop_a, ab_t[bidx, nkc], ab)
        s = torch.where(stop_a, 0, torch.where(step_a, ns, s))
        cnt = torch.where(active, ncnt, cnt)
        task_k = torch.where(stop_a, nk, task_k)
        kc = torch.where(stop_a, nkc, kc)
    return rec.to(torch.int32), fin.to(torch.int32)


def wavetape_traceback_cuda(moves, db_rows, n_tasks, end_i, end_j, abase,
                            W: int):
    """Launch csrc/wavetape_walk.cu; same contract as the plain version."""
    B, LA = db_rows.shape
    TT = end_i.shape[1]
    dev = moves.device
    args = [moves, db_rows, n_tasks, end_i, end_j, abase]
    for x in args:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError('walker inputs must be contiguous int32 on %s'
                             % dev)
    if moves.shape != (B, LA // 8, W):
        raise ValueError('moves shape %s does not match (B, LA/8, W)'
                         % (tuple(moves.shape),))
    records = torch.zeros((B, LA), dtype=torch.int32, device=dev)
    fin = torch.zeros((B, TT, 3), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    with cuda_lib.timed('wavetape_walk', dev, (records, fin)):
        err = lib.wavetape_walk_launch(
            *(x.data_ptr() for x in args), records.data_ptr(),
            fin.data_ptr(), B, LA, W, TT, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'wavetape_walk')
    cuda_lib.LAUNCHES['wavetape_walk'] += 1
    return records, fin


def wavetape_traceback(moves, db_rows, n_tasks, end_i, end_j, abase, W: int):
    """On-device traceback over a wavefront tape. end_i/end_j: (B, TT)
    per-task end cells (i=0, j=0 for tasks to skip). Returns (records
    (B, LA) int32, fin (B, TT, 3) = (final i, final j, stop code))."""
    args = [x.to(torch.int32).contiguous()
            for x in (moves, db_rows, n_tasks, end_i, end_j, abase)]
    if moves.device.type == 'cuda':
        return wavetape_traceback_cuda(*args, W)
    if moves.device.type == 'cpu':
        return wavetape_traceback_plain(*args, W)
    raise ValueError('unsupported device %s' % moves.device)


def wave_records_to_cigar(records_row, abase, end_i, end_j, final_i,
                          final_j, stop_code, config: AlignConfig):
    """Rebuild (cigar, start_i, start_j) from per-wavefront path records
    — vectorised numpy (a copy of the JAX package's decoder).

    The record of the path cell at task-local wavefront a = i + j lives at
    address abase + a. 1 = a single M step; op | (L << 2) (op 2 = D, 3 = I)
    = an indel run of length L covering addresses [a, a + L). Only run
    entries are read: the decode walks event to event with M strides of 2
    filling the gaps. Returns None on a band escape or inconsistent
    records (the caller retries the task on the banded kernel)."""
    end_i = int(end_i)
    end_j = int(end_j)
    final_i = int(final_i)
    final_j = int(final_j)
    stop_code = int(stop_code)
    if stop_code == 2:
        return None                      # band escape: caller falls back

    prefix_counts = []
    prefix_types = []
    if stop_code == 0:
        if config.free_start_s2 or final_j == 0:
            start_i, start_j = 0, final_j
        else:
            prefix_counts.append(final_j)
            prefix_types.append(2)
            start_i, start_j = 0, 0
    else:                                # stop_code == 1: column 0 in H
        if config.free_start_s1:
            start_i, start_j = final_i, 0
        else:
            prefix_counts.append(final_i)
            prefix_types.append(1)
            start_i, start_j = 0, 0

    a_end = end_i + end_j
    a_fin = final_i + final_j
    abase = int(abase)
    span = records_row[abase + a_fin + 1:abase + a_end + 1] \
        if a_end > a_fin else np.zeros(0, np.int32)
    ev_rel = np.nonzero(span >= 6)[0]                # run records
    ev_addr = ev_rel + a_fin + 1                     # ascending
    ev_vals = span[ev_rel]
    ev_ops = ev_vals & 3                             # 2 = D, 3 = I
    ev_cnts = ev_vals >> 2
    if np.any((ev_ops < 2) | (ev_cnts < 1)):
        return None                      # corrupt records: retry

    # descending events; each covers addresses [addr, addr + cnt); M
    # strides of 2 fill the gaps between run spans
    ev_addr_d = ev_addr[::-1]
    ev_ops_d = ev_ops[::-1]
    ev_cnts_d = ev_cnts[::-1].astype(np.int64)
    K = len(ev_addr_d)
    uppers = np.concatenate([[a_end], ev_addr_d - 1])
    lowers = np.concatenate([ev_addr_d + ev_cnts_d - 1, [a_fin]])
    m_gaps = uppers - lowers                          # K+1 entries
    if np.any(m_gaps < 0) or np.any(m_gaps & 1):
        return None                      # inconsistent records: retry
    m_counts = m_gaps >> 1

    # reverse-chronological op list: [M x m0] run1 [M x m1] run2 ... ;
    # forward order is its reverse
    n_ops = K + K + 1
    op_types = np.empty(n_ops, np.int8)   # 0 M, 1 I, 2 D
    op_counts = np.empty(n_ops, np.int64)
    op_types[0::2] = 0
    op_counts[0::2] = m_counts
    op_types[1::2] = np.where(ev_ops_d == 2, 2, 1)
    op_counts[1::2] = ev_cnts_d
    op_types = op_types[::-1]
    op_counts = op_counts[::-1]
    if prefix_types:
        op_types = np.concatenate(
            [np.asarray(prefix_types, np.int8), op_types])
        op_counts = np.concatenate(
            [np.asarray(prefix_counts, np.int64), op_counts])
    keep = op_counts > 0
    op_types = op_types[keep]
    op_counts = op_counts[keep]

    # consistency: M+I runs consume s1 rows start_i..end_i, M+D runs
    # consume s2 columns start_j..end_j; a mismatch means corrupt records
    tot_m = int(op_counts[op_types == 0].sum())
    tot_i = int(op_counts[op_types == 1].sum())
    tot_d = int(op_counts[op_types == 2].sum())
    if tot_m + tot_i != end_i - start_i \
            or tot_m + tot_d != end_j - start_j:
        return None
    if len(op_types):
        boundaries = np.nonzero(np.concatenate(
            [[True], op_types[1:] != op_types[:-1]]))[0]
        merged_counts = np.add.reduceat(op_counts, boundaries)
        merged_types = op_types[boundaries]
    else:
        merged_counts = np.zeros(0, np.int64)
        merged_types = np.zeros(0, np.int8)
    return RunCigar(merged_counts, merged_types), start_i, start_j
