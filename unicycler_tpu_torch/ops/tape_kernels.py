"""Row-tape forward DP and traceback walker for wide bands: CUDA kernels,
their plain PyTorch versions, and the host decode of the walker's records.

Counterpart of unicycler_tpu/ops/pallas_tape.py. The forward kernel
(csrc/tape_fwd.cu) is a row-by-row affine-gap (Gotoh) banded DP over a
tape of tasks (ops/tape.py): rows come in groups of G = 32, each group
works in a fixed region frame of GWp lanes (lane k = reference column
jr + k) in which row i's band is the window [d_i, d_i + W), and the
carries realign between groups by the group's advance. E comes from a
prefix maximum across the row. The kernel writes every row's 4-bit moves
(8 rows to an int32 word), the H row at each task's capture row and each
group's best last-column value; end selection by AlignConfig happens here,
after the kernel, in the order of the JAX package. The walker
(csrc/tape_walk.cu) walks the moves back from each task's end cell and
writes one record per row, decoded on the host by records_to_cigar.

The wrappers (tape_forward, tape_traceback) launch the CUDA kernels for
tensors on a CUDA device and run the plain versions only for tensors on
the CPU. The plain versions repeat the kernels' arithmetic lane for lane,
so kernel and plain version agree bit for bit; the tests hold the plain
versions against the JAX package's interpret-mode kernels. The forward
kernel runs each track on a thread block cluster (cluster_size) and
stops at the track's last real group (track_groups), so it is compared
with its plain version over real groups (real_rows).
"""

import numpy as np
import torch

from . import cuda_lib
from .encode import Q_PAD
from .pairwise import NEG, AlignConfig, RunCigar, Scoring
from .tape import MAX_SHIFT, SEG_ALIGN

G = SEG_ALIGN
NEG_HALF = NEG // 2

# fields of the per-(track, group) plane handed to the forward kernel:
# region base column jr, task m_act, local DP row of the group's first row,
# carry advance at group entry, reset flag, the task's row-0 band offset
# c[0], and the start of the group's region in r_flat
(GP_JR, GP_M, GP_LB, GP_ADV, GP_RST, GP_C0, GP_RSTART) = range(7)
GP_N = 8


def region_width(W):
    """Region lanes: band width + max in-group drift, lane-padded."""
    return (W + G * MAX_SHIFT + 127) // 128 * 128


def tape_prolog(qf, r_flat, cbase, c0m, m_t, r_base, seg_start, W):
    """Per-row and per-group quantities of one launch, from the tape bytes
    and the per-task arrays (the JAX prolog, pallas_tape.py:465-521).
    Returns (rowinfo (B, L) int32 = d | capture << 8 | active << 9 |
    q << 16, gplane (B, L/32, GP_N) int32, jr_g (B, L/32) and d_off (B, L)
    int64 for the walker's sidecars)."""
    B, L = qf.shape
    M = r_flat.shape[1]
    GWp = region_width(W)
    i64 = torch.int64
    fl = qf.to(i64)
    q_codes = fl & 7
    is_reset = (fl >> 3) & 1
    is_capture = (fl >> 4) & 1
    si = (fl >> 5) & 7
    active = (q_codes != Q_PAD).to(i64)

    S = torch.cumsum(si, 1)
    Sg = S[:, ::G]
    d_off = S - Sg.repeat_interleave(G, dim=1)

    rst_g = is_reset[:, ::G]
    seg_id_g = (torch.cumsum(rst_g, 1) - 1).clamp(min=0)

    def takeg(a):
        return torch.gather(a.to(i64), 1, seg_id_g)

    u_grp = (Sg + takeg(cbase.to(i64) + r_base.to(i64)) + (W - 1)).clamp(
        min=0)
    jr_g = u_grp - takeg(r_base) - (W - 1)
    adv = torch.cat([torch.zeros_like(u_grp[:, :1]),
                     u_grp[:, 1:] - u_grp[:, :-1]], 1)
    n_groups = L // G
    pos_g = torch.arange(n_groups, device=qf.device, dtype=i64)[None, :] * G
    lb_g = pos_g - takeg(seg_start) + 1
    # the JAX prolog slices GWp bytes at u_grp (lax.dynamic_slice clamps
    # the start into the array)
    rstart = u_grp.clamp(0, M - GWp)
    rowinfo = d_off | (is_capture << 8) | (active << 9) | (q_codes << 16)
    gplane = torch.stack([jr_g, takeg(m_t), lb_g, adv, rst_g, takeg(c0m),
                          rstart, torch.zeros_like(jr_g)], -1)
    return (rowinfo.to(torch.int32).contiguous(),
            gplane.to(torch.int32).contiguous(), jr_g, d_off)


def track_groups(last_slot):
    """Real groups of each track, (B,) int32: its last task's last_slot +
    1 (0 for a track with no task). The forward kernel stops there."""
    return (last_slot.to(torch.int64).amax(1) + 1).clamp(min=0).to(
        torch.int32)


def real_rows(moves, hatn, best, ngt):
    """The forward outputs with every group at or past its track's real
    group count zeroed: what the kernel defines (it stops there) and its
    plain version computes too."""
    n_groups = best.shape[0]
    keep = torch.arange(n_groups, device=best.device)[:, None] \
        < ngt.to(best.device).to(torch.int64)[None, :]          # (NG, B)
    hatn = torch.where(keep[:, :, None], hatn, 0)
    best = torch.where(keep[:, :, None], best, 0)
    if moves is not None:
        keep_rows = keep.t().repeat_interleave(G // 8, dim=1)   # (B, L/8)
        moves = torch.where(keep_rows[:, :, None], moves, 0)
    return moves, hatn, best


# cluster sizes the forward kernel takes (blocks a track), and the fewest
# region lanes a block of a cluster owns
CLUSTER_SIZES = (8, 4, 2, 1)
MIN_BLOCK_LANES = 128
# csrc/tape_fwd.cu's templates (lanes a thread) and its threads a block
# at most; the most region lanes one block of a cluster takes
LANE_TEMPLATES = (2, 3, 5, 9, 17)
MAX_THREADS = 512
MAX_BLOCK_LANES = LANE_TEMPLATES[-1] * MAX_THREADS
# ints of scratch a region lane of the tiled kernel
TILED_SCRATCH = 8


def tiled(W):
    """True when band W is too wide for every cluster size: csrc/tape_fwd.cu
    then runs its tiled kernel, one block a track (C = 1)."""
    return region_width(W) // max(CLUSTER_SIZES) > MAX_BLOCK_LANES


def block_plan(W, C):
    """The kernel csrc/tape_fwd.cu runs at band W with C blocks a track,
    by its own rule (lanes_per_thread, valid_shape, tiled_shape):
    ('cluster', lanes a thread) or ('tiled', 0); None where it refuses
    the launch."""
    GWp = region_width(W)
    if C not in CLUSTER_SIZES or GWp % C or GWp // C < MIN_BLOCK_LANES:
        return None
    per = next((p for p in LANE_TEMPLATES if GWp // C <= p * MAX_THREADS),
               0)
    if per:
        return ('cluster', per)
    return ('tiled', 0) if C == 1 else None


def cluster_size(tracks, W, sms, resident):
    """Blocks a track for a launch of `tracks` tracks at band W: the
    largest C in CLUSTER_SIZES with tracks x C <= sms (the card's SMs),
    at least MIN_BLOCK_LANES region lanes a block and every cluster
    resident at once (tracks <= resident(C), the card's
    cudaOccupancyMaxActiveClusters), but never so few that a block would
    own more than MAX_BLOCK_LANES lanes. A band too wide for every C
    takes 1, the tiled kernel's one block a track."""
    GWp = region_width(W)
    fits = [C for C in CLUSTER_SIZES if GWp // C <= MAX_BLOCK_LANES]
    if not fits:
        return 1
    for C in fits:
        if tracks * C <= sms and GWp // C >= MIN_BLOCK_LANES \
                and tracks <= resident(C):
            return C
    return fits[-1]


def _shift_right(x, d):
    """x shifted right by d lanes, NEG in the vacated lanes."""
    fill = torch.full((x.shape[0], d), NEG, dtype=x.dtype, device=x.device)
    return torch.cat([fill, x[:, :x.shape[1] - d]], 1)


def _prefix_cummax(x, max_dist):
    """Inclusive prefix max along lanes via the TPU kernel's ladder of
    shifts, windowed as there: it propagates at most the smallest power
    of two >= max_dist + 1 lanes."""
    span = min(x.shape[1], max_dist + 1)
    d = 1
    while d < span:
        x = torch.maximum(x, _shift_right(x, d))
        d *= 2
    return x


def tape_forward_plain(rowinfo, gplane, r_flat, scoring: Scoring,
                       config: AlignConfig, W: int, need_moves: bool,
                       ngt=None):
    """Plain PyTorch version of the forward kernel (the rolled Pallas body,
    all tracks at once). Returns (moves (B, L/8, GWp) int32 or None, hatn
    (L/32, B, GWp) int32 holding H at each capture row (zero elsewhere),
    best (L/32, B, 2) int32 = each group's running best last-column value
    and its local row). It computes every group, a track's padding
    included, so it equals the Pallas kernel in full. With ngt ((B,)
    int32, track_groups) it stops as the CUDA kernel does, at each
    track's last real group, and zeroes the groups past it (real_rows)."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    B, L = rowinfo.shape
    n_groups = L // G
    n_run = n_groups if ngt is None else min(n_groups, int(ngt.max()))
    GWp = region_width(W)
    dev = rowinfo.device
    i32 = torch.int32
    lane = torch.arange(GWp, device=dev, dtype=i32)[None, :]
    bidx = torch.arange(B, device=dev)
    h = torch.full((B, GWp), NEG, dtype=i32, device=dev)
    f = h.clone()
    mv = torch.zeros((B, GWp), dtype=torch.int64, device=dev)
    bv = torch.full((B, 1), NEG, dtype=i32, device=dev)
    bi = torch.zeros((B, 1), dtype=i32, device=dev)
    moves = torch.zeros((B, L // 8, GWp), dtype=i32, device=dev) \
        if need_moves else None
    hatn = torch.zeros((n_groups, B, GWp), dtype=i32, device=dev)
    best = torch.zeros((n_groups, B, 2), dtype=i32, device=dev)
    gp = gplane.to(i32)
    rv = rowinfo.to(i32)

    def boundary(j, m_g, c0):
        if config.free_start_s2:
            h0 = torch.where(j >= 0, 0, NEG)
        else:
            h0 = torch.where(j > 0, open_ + (j - 1) * ext,
                             torch.where(j == 0, 0, NEG))
        return torch.where((j <= m_g) & (j >= c0) & (j < c0 + W), h0,
                           NEG).to(i32)

    for g in range(n_run):
        p = gp[:, g, :]
        jr, m_g, lb = p[:, GP_JR:GP_JR + 1], p[:, GP_M:GP_M + 1], \
            p[:, GP_LB:GP_LB + 1]
        adv, rst, c0 = p[:, GP_ADV:GP_ADV + 1], p[:, GP_RST:GP_RST + 1] == 1, \
            p[:, GP_C0:GP_C0 + 1]
        rstart = p[:, GP_RSTART:GP_RSTART + 1].to(torch.int64)
        # realign the carries left by adv lanes, NEG in the tail
        src = (lane + adv).to(torch.int64)
        shift = ~rst & (adv > 0)
        ok = shift & (src < GWp)
        idx = src.clamp(0, GWp - 1)
        h = torch.where(shift, torch.where(ok, torch.gather(h, 1, idx), NEG),
                        h)
        f = torch.where(shift, torch.where(ok, torch.gather(f, 1, idx), NEG),
                        f)
        h = torch.where(rst, boundary(jr + lane, m_g, c0), h)
        f = torch.where(rst, NEG, f)
        bv = torch.where(rst, NEG, bv)
        bi = torch.where(rst, 0, bi)
        h0m1 = boundary(jr - 1, m_g, c0)
        reg = torch.gather(r_flat, 1, rstart + lane.to(torch.int64)).to(i32)
        j = jr + lane

        for r in range(G):
            t = g * G + r
            row = rv[:, t:t + 1]
            d = row & 255
            cap = ((row >> 8) & 1) == 1
            act = ((row >> 9) & 1) == 1
            qv = (row >> 16) & 255
            local_i = lb + r
            m_col = torch.where(act, m_g, -1)
            vb = (lane >= d) & (lane < d + W)
            valid_ef = vb & (j >= 1) & (j <= m_col)
            is_col0 = vb & (j == 0) & (m_col >= 0)
            valid_h = vb & (j >= 0) & (j <= m_col)
            is_lastcol = vb & (j == m_col)

            f_ext_v = f + ext
            f_new = torch.maximum(h + open_, f_ext_v)
            f_ext_bit = (f_new == f_ext_v) & (f > NEG_HALF)
            sub = torch.where(reg == qv, match_s, mismatch).to(i32)
            h_diag = _shift_right(h, 1)
            if r == 0:
                h_diag = torch.where(rst & (lane == 0), h0m1, h_diag)
            diag = torch.where(valid_ef, h_diag + sub, NEG)
            if config.free_start_s1:
                col0_val = torch.zeros_like(local_i)
            else:
                col0_val = open_ + (local_i - 1) * ext
            diag = torch.where(is_col0, col0_val, diag).to(i32)
            gg = torch.maximum(diag, torch.where(valid_ef, f_new, NEG))
            cvec = gg + open_ - (lane + 1) * ext
            cmax = _prefix_cummax(cvec, W - 1)
            e = _shift_right(cmax, 1) + lane * ext
            e = torch.where(valid_ef & (e > NEG_HALF), e, NEG)
            hn = torch.where(valid_h, torch.maximum(gg, e), NEG)
            e_prev = _shift_right(e, 1)
            e_ext_bit = (e == e_prev + ext) & (e_prev > NEG_HALF)

            if need_moves:
                hsrc = torch.where(hn == diag, 0, torch.where(hn == e, 1, 2))
                m4 = (hsrc | (e_ext_bit.to(torch.int64) << 2)
                      | (f_ext_bit.to(torch.int64) << 3))
                sh = 4 * (t % 8)
                mv = m4 if sh == 0 else mv | (m4 << sh)
                if t % 8 == 7:
                    # 32-bit pattern of the word, as the kernels store it
                    moves[:, t // 8, :] = torch.where(
                        mv >= 2 ** 31, mv - 2 ** 32, mv).to(i32)

            lc_val = torch.where(is_lastcol, hn, NEG).amax(1, keepdim=True)
            better = lc_val > bv
            bv = torch.where(better, lc_val, bv)
            bi = torch.where(better, local_i, bi)
            capb = cap[:, 0]
            if bool(capb.any()):
                hatn[g, bidx[capb]] = hn[capb]
            h, f = hn, f_new
        best[g] = torch.cat([bv, bi], 1)
    if ngt is not None:
        moves, hatn, best = real_rows(moves, hatn, best, ngt)
    return moves, hatn, best


_RESIDENT = {}


def resident_clusters(C, W, device=None):
    """Clusters of C blocks of the forward kernel at band W that `device`
    (None: the current one) holds at once
    (cudaOccupancyMaxActiveClusters), cached."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (C, region_width(W), index)
    if key not in _RESIDENT:
        import ctypes
        n = ctypes.c_int()
        with torch.cuda.device(index):
            cuda_lib.check(cuda_lib.lib().tape_fwd_clusters(
                C, key[1], ctypes.byref(n)), 'tape_fwd_clusters')
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def launch_cluster(tracks, W, device):
    """The cluster size tape_forward_cuda takes for a launch of `tracks`
    tracks at band W on `device` (cluster_size on the card's SM count and
    resident clusters)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cluster_size(tracks, W, sms,
                        lambda C: resident_clusters(C, W, device))


def tape_forward_cuda(rowinfo, gplane, r_flat, ngt, scoring: Scoring,
                      config: AlignConfig, W: int, need_moves: bool,
                      cluster=None):
    """Launch csrc/tape_fwd.cu: the plain version's contract over each
    track's first ngt[b] groups (ngt: (B,) int32, track_groups); moves and
    best of the groups past them are left unwritten, hatn zero. Each
    track runs on a cluster of `cluster` blocks (by default
    launch_cluster's choice); a band too wide for every cluster size
    (tiled) runs the tiled kernel, one block a track."""
    B, L = rowinfo.shape
    dev = rowinfo.device
    GWp = region_width(W)
    for name, x, dt in (('rowinfo', rowinfo, torch.int32),
                        ('gplane', gplane, torch.int32),
                        ('r_flat', r_flat, torch.int8),
                        ('ngt', ngt, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError('%s must be a contiguous %s tensor on %s'
                             % (name, dt, dev))
    if L % G or gplane.shape != (B, L // G, GP_N) \
            or r_flat.shape[0] != B or r_flat.shape[1] < GWp \
            or tuple(ngt.shape) != (B,):
        raise ValueError('inconsistent launch shapes')
    # the kernel copies 16-byte chunks of its inputs into shared memory
    if r_flat.shape[1] % 16 or any(x.data_ptr() % 16 for x in
                                   (rowinfo, gplane, r_flat)):
        raise ValueError('rowinfo, gplane and r_flat rows must start on '
                         '16-byte boundaries')
    wide = tiled(W)
    C = 1 if wide else (launch_cluster(B, W, dev) if cluster is None
                        else int(cluster))
    if block_plan(W, C) is None:
        raise ValueError('cluster size %d does not fit W = %d' % (C, W))
    moves = torch.empty((B, L // 8, GWp), dtype=torch.int32, device=dev) \
        if need_moves else None
    scratch = torch.empty((B, TILED_SCRATCH * GWp), dtype=torch.int32,
                          device=dev) if wide else None
    hatn = torch.zeros((L // G, B, GWp), dtype=torch.int32, device=dev)
    # each block's running best last column and its row
    parts = torch.empty((L // G, B, C, 2), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    shape = cuda_lib.shape_only
    with cuda_lib.timed('tape_fwd', dev, (rowinfo, shape(gplane),
                                          shape(r_flat), ngt, shape(moves),
                                          shape(hatn), shape(parts), C)):
        err = lib.tape_fwd_launch(
            rowinfo.data_ptr(), gplane.data_ptr(), r_flat.data_ptr(),
            r_flat.shape[1], ngt.data_ptr(),
            moves.data_ptr() if need_moves else None,
            hatn.data_ptr(), parts.data_ptr(),
            scratch.data_ptr() if wide else None, B, L, W, GWp, C,
            int(scoring.match), int(scoring.mismatch),
            int(scoring.gap_open), int(scoring.gap_extend),
            int(config.free_start_s1), int(config.free_start_s2),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'tape_fwd')
    cuda_lib.LAUNCHES['tape_fwd'] += 1
    # merged over the cluster as the one-lane running update would: the
    # largest value, then its earliest row
    val, row = parts[..., 0], parts[..., 1]
    top = val.amax(-1)
    first = torch.where(val == top[..., None], row,
                        torch.iinfo(torch.int32).max).amin(-1)
    return moves, hatn, torch.stack([top, first], -1)


def _boundary_vals(j, m, scoring, config):
    """H(0, j) boundary values, NEG outside [0, m]."""
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    if config.free_start_s2:
        h0 = torch.where(j >= 0, 0, NEG)
    else:
        h0 = torch.where(j > 0, open_ + (j - 1) * ext,
                         torch.where(j == 0, 0, NEG))
    return torch.where(j > m, NEG, h0)


def tape_forward(qf, r_flat, cbase, c0m, c_n, m_t, n_t, r_base,
                 seg_start, reset_slot, cap_slot, last_slot,
                 scoring: Scoring, config: AlignConfig, W: int,
                 need_moves: bool):
    """Run the row-tape DP on the tensors' device. Returns (score, end_i,
    end_j) each (B, TT) int32, moves (B, L/8, GWp) int32 (None without
    need_moves) and the walker's sidecars (c_rel, jr_rows) (B, L) int32."""
    B, L = qf.shape
    GWp = region_width(W)
    rowinfo, gplane, jr_g, d_off = tape_prolog(qf, r_flat, cbase, c0m, m_t,
                                               r_base, seg_start, W)
    if qf.device.type == 'cuda':
        moves, hatn, best = tape_forward_cuda(rowinfo, gplane, r_flat,
                                              track_groups(last_slot),
                                              scoring, config, W, need_moves)
    elif qf.device.type == 'cpu':
        moves, hatn, best = tape_forward_plain(rowinfo, gplane, r_flat,
                                               scoring, config, W,
                                               need_moves)
    else:
        raise ValueError('unsupported device %s' % qf.device)

    # end selection, vectorised over (B, TT) task slots (pallas_tape.py:
    # 603-647)
    i64 = torch.int64
    n_slots = L // G
    bidx = torch.arange(B, device=qf.device)[:, None]
    cap = cap_slot.to(i64).clamp(0, n_slots - 1)
    last = last_slot.to(i64).clamp(0, n_slots - 1)
    hatn_t = hatn[cap, bidx].to(i64)                       # (B, TT, GWp)
    best_t = best[last, bidx].to(i64)                      # (B, TT, 2)
    jr_cap = torch.gather(jr_g, 1, cap)
    m_t, n_t, c_n, c0m = (x.to(i64) for x in (m_t, n_t, c_n, c0m))
    ks = torch.arange(GWp, device=qf.device, dtype=i64)
    j_at_n = jr_cap[:, :, None] + ks[None, None, :]
    k_corner = (m_t - jr_cap).clamp(0, GWp - 1)
    corner_ok = (m_t - c_n >= 0) & (m_t - c_n < W) \
        & (m_t - jr_cap >= 0) & (m_t - jr_cap < GWp)
    corner = torch.where(
        corner_ok, torch.gather(hatn_t, 2, k_corner[:, :, None])[:, :, 0],
        NEG)
    score, end_i, end_j = corner, n_t, m_t
    if config.free_end_s2:
        row_vals = torch.where(j_at_n <= m_t[:, :, None], hatn_t, NEG)
        k_best = torch.argmax(row_vals, 2)
        s = torch.gather(row_vals, 2, k_best[:, :, None])[:, :, 0]
        better = s > score
        end_j = torch.where(better, jr_cap + k_best, end_j)
        end_i = torch.where(better, n_t, end_i)
        score = torch.maximum(score, s)
    if config.free_end_s1:
        # row-0 candidate straight from the boundary formula, gated by the
        # row-0 band (j = m must lie in [c0, c0 + W))
        row0_ok = (m_t - c0m >= 0) & (m_t - c0m < W)
        row0 = torch.where(row0_ok, _boundary_vals(m_t, m_t, scoring,
                                                   config), NEG)
        kern_val, kern_i = best_t[:, :, 0], best_t[:, :, 1]
        col_val = torch.where(kern_val > row0, kern_val, row0)
        col_i = torch.where(kern_val > row0, kern_i, 0)
        better = col_val > score
        end_i = torch.where(better, col_i, end_i)
        end_j = torch.where(better, m_t, end_j)
        score = torch.maximum(score, col_val)
    jr_rows = jr_g.repeat_interleave(G, dim=1)
    c_rel = jr_rows + d_off
    return (score.to(torch.int32), end_i.to(torch.int32),
            end_j.to(torch.int32), moves,
            (c_rel.to(torch.int32), jr_rows.to(torch.int32)))


def tape_traceback_plain(moves, c_rel, jr_rows, n_tasks, end_abs, end_j,
                         seg_start, W: int):
    """Plain PyTorch version of the walker: every track steps at once, one
    loop iteration per path step. Returns (records (B, L), fin (B, TT, 3))
    int32; fin rows of tasks never walked stay 0."""
    B, Lw, GWp = moves.shape
    L = c_rel.shape[1]
    TT = end_abs.shape[1]
    dev = moves.device
    i64 = torch.int64
    mv = moves.to(i64)
    crow = c_rel.to(i64)
    jrow = jr_rows.to(i64)
    ea, ej, ss = (x.to(i64) for x in (end_abs, end_j, seg_start))
    rec = torch.zeros((B, L), dtype=i64, device=dev)
    fin = torch.zeros((B, TT, 3), dtype=i64, device=dev)
    bidx = torch.arange(B, device=dev)
    task_k = n_tasks.to(i64) - 1
    kc = task_k.clamp(0, TT - 1)
    has = task_k >= 0
    i_abs = torch.where(has, ea[bidx, kc], 0)
    j = torch.where(has, ej[bidx, kc], 0)
    seg0 = torch.where(has, ss[bidx, kc], 0)
    s = torch.zeros(B, dtype=i64, device=dev)
    while True:
        i_rel = i_abs - seg0
        active = (task_k >= 0) & ((i_abs > 0) | (i_rel == 0)
                                  | ((j == 0) & (s == 0)))
        if not bool(active.any()):
            break
        row0 = i_rel == 0
        col0 = ~row0 & (s == 0) & (j == 0)
        t = (i_abs - 1).clamp(0, L - 1)
        band = j - crow[bidx, t]
        lane_r = (j - jrow[bidx, t]).clamp(0, GWp - 1)
        cell = (mv[bidx, t // 8, lane_r] >> (4 * (t % 8))) & 0xF
        escape = ~row0 & ~col0 & ((band < 0) | (band >= W))
        stopping = row0 | col0 | escape
        code = torch.where(row0, 0, torch.where(col0, 1, 2))
        act = torch.where(s == 1, 1, torch.where(s == 2, 2, cell & 3))
        is_m, is_d, is_i = act == 0, act == 1, act == 2
        step = active & ~stopping
        inc = torch.where(is_m, 1, torch.where(is_i, 2, 8))
        rec[bidx[step], t[step]] += inc[step]
        pub = active & stopping
        fin[bidx[pub], kc[pub]] = torch.stack([i_rel, j, code], 1)[pub]
        e_ext = ((cell >> 2) & 1) == 1
        f_ext = ((cell >> 3) & 1) == 1
        ni = torch.where(is_m | is_i, i_abs - 1, i_abs)
        nj = torch.where(is_m | is_d, j - 1, j)
        ns = torch.where(is_d & e_ext & (nj > 0), 1,
                         torch.where(is_i & f_ext & (ni - seg0 > 0), 2, 0))
        nk = task_k - 1
        nkc = nk.clamp(0, TT - 1)
        i_abs = torch.where(pub, ea[bidx, nkc], torch.where(step, ni, i_abs))
        j = torch.where(pub, ej[bidx, nkc], torch.where(step, nj, j))
        seg0 = torch.where(pub, ss[bidx, nkc], seg0)
        s = torch.where(pub, 0, torch.where(step, ns, s))
        task_k = torch.where(pub, nk, task_k)
        kc = torch.where(pub, nkc, kc)
    return rec.to(torch.int32), fin.to(torch.int32)


def tape_traceback_cuda(moves, c_rel, jr_rows, n_tasks, end_abs, end_j,
                        seg_start, W: int):
    """Launch csrc/tape_walk.cu; same contract as the plain version."""
    B, Lw, GWp = moves.shape
    L = c_rel.shape[1]
    TT = end_abs.shape[1]
    dev = moves.device
    args = [moves, c_rel, jr_rows, n_tasks, end_abs, end_j, seg_start]
    for x in args:
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError('walker inputs must be contiguous int32 on %s'
                             % dev)
    if Lw * 8 != L or L % G or jr_rows.shape != (B, L) \
            or c_rel.shape != (B, L):
        raise ValueError('moves shape %s does not match (B, L/8, GWp)'
                         % (tuple(moves.shape),))
    records = torch.zeros((B, L), dtype=torch.int32, device=dev)
    fin = torch.zeros((B, TT, 3), dtype=torch.int32, device=dev)
    lib = cuda_lib.lib()
    with cuda_lib.timed('tape_walk', dev, (records, fin)):
        err = lib.tape_walk_launch(
            *(x.data_ptr() for x in args), records.data_ptr(),
            fin.data_ptr(), B, L, GWp, W, TT, cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'tape_walk')
    cuda_lib.LAUNCHES['tape_walk'] += 1
    return records, fin


def tape_traceback(moves, c_rel, jr_rows, n_tasks, end_abs, end_j,
                   seg_start, W: int):
    """On-device traceback over a whole row tape. end_abs/end_j: (B, TT)
    per-task end cells (tape row, column; 0 for task slots to skip).
    Returns (records (B, L) int32, fin (B, TT, 3) = (final local i,
    final j, stop code))."""
    args = [x.to(torch.int32).contiguous()
            for x in (moves, c_rel, jr_rows, n_tasks, end_abs, end_j,
                      seg_start)]
    if moves.device.type == 'cuda':
        return tape_traceback_cuda(*args, W)
    if moves.device.type == 'cpu':
        return tape_traceback_plain(*args, W)
    raise ValueError('unsupported device %s' % moves.device)


def records_to_cigar(records, end_i, final_i, final_j, stop_code,
                     config: AlignConfig):
    """Rebuild (cigar, start_i, start_j) from per-row path records —
    vectorised numpy, no per-cell work (a copy of the JAX package's
    decoder, pallas_traceback.py:180).

    Forward order: [terminal prefix ops] then, for each visited row
    ascending, the M/I step that entered the row followed by its D run.
    Returns None on a band escape (the caller retries the task)."""
    end_i = int(end_i)
    final_i = int(final_i)
    final_j = int(final_j)
    stop_code = int(stop_code)
    if stop_code == 2:
        return None                       # band escape: caller falls back

    prefix_counts = []
    prefix_types = []
    if stop_code == 0 and final_i == 0:
        # walked to row 0
        if config.free_start_s2 or final_j == 0:
            start_i, start_j = 0, final_j
        else:
            prefix_counts.append(final_j)
            prefix_types.append(2)
            start_i, start_j = 0, 0
    elif stop_code == 1:
        # stopped at column 0 in H state
        if config.free_start_s1:
            start_i, start_j = final_i, 0
        else:
            prefix_counts.append(final_i)
            prefix_types.append(1)
            start_i, start_j = 0, 0
    else:
        start_i, start_j = final_i, final_j
    # D moves taken on the stop row itself (its record has no move bits)
    if final_i >= 1:
        d_stop = int(records[final_i - 1]) >> 3
        if d_stop:
            prefix_counts.append(d_stop)
            prefix_types.append(2)

    first_row = final_i + 1               # rows visited: first_row..end_i
    if first_row > end_i:
        rows = np.zeros(0, np.int32)
    else:
        rows = records[first_row - 1:end_i]

    moves = rows & 7
    d_counts = rows >> 3
    # interleave per row: move op then D run
    n = len(rows)
    op_types = np.empty(2 * n + len(prefix_types), np.int8)  # 0 M, 1 I, 2 D
    op_counts = np.empty(2 * n + len(prefix_types), np.int64)
    np_ = len(prefix_types)
    op_types[:np_] = prefix_types
    op_counts[:np_] = prefix_counts
    op_types[np_::2] = np.where(moves == 1, 0, 1)
    op_counts[np_::2] = 1
    op_types[np_ + 1::2] = 2
    op_counts[np_ + 1::2] = d_counts
    keep = op_counts > 0
    # drop move slots for rows with no move bits (shouldn't happen on a
    # valid path, but row records of value 0 would otherwise emit junk)
    keep[np_::2] &= moves != 0
    op_types = op_types[keep]
    op_counts = op_counts[keep]
    if len(op_types):
        boundaries = np.nonzero(np.concatenate(
            [[True], op_types[1:] != op_types[:-1]]))[0]
        merged_counts = np.add.reduceat(op_counts, boundaries)
        merged_types = op_types[boundaries]
    else:
        merged_counts = np.zeros(0, np.int64)
        merged_types = np.zeros(0, np.int8)
    return RunCigar(merged_counts, merged_types), start_i, start_j
