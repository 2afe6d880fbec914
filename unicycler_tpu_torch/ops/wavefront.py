"""Per-task anti-diagonal wavefront banded DP, score only: the CUDA kernel
and its plain PyTorch version.

Counterpart of unicycler_tpu/ops/pallas_wavefront.py, the prototype whose
group-window semantics the wave tape kernels reproduce. Cells are
processed in wavefronts a = i + j with lanes as diagonals; within a group
of G wavefronts the diagonal window [dbase_g, dbase_g + W) is fixed, and
drifting corridors are group-quantized (_group_windows): the carries
realign by the group's advance at group entry. The row-n and column-m
captures merge at group exit into absolute-frame arrays of width Wcap
(lane = diagonal - dmin), from which the host selects the ends with
ops.banded._banded_single's tie rules.

    cell (i, j), lane k = (j - i) - dbase_g, wavefront a = i + j:
      H(a, k) = max(H(a-2, k) + sub(q[i-1], r[j-1]), E(a, k), F(a, k))
      E(a, k) = max(H(a-1, k-1) + open, E(a-1, k-1) + ext)
      F(a, k) = max(H(a-1, k+1) + open, F(a-1, k+1) + ext)

The host staging (_prepare, _group_windows, _base_planes) and the end
selection are copies of the JAX package's. wavefront_forward launches
csrc/wavefront_fwd.cu (any W, at launch_plan's cluster shape) for tensors
on a CUDA device and runs wavefront_forward_plain only for tensors on the
CPU. wavefront_forward_pairs is the kernel's own algorithm in plain
PyTorch (real lanes only, segments with halos, a per-task stop), which
the CPU tests hold to wavefront_forward_plain. No pipeline stage
calls this module: its entry is the ops API (wavefront_batch_corridor,
wavefront_batch) that the JAX package's tests and microbenchmark call.
"""

import numpy as np
import torch

from ..device import resolve_device
from . import cuda_lib
from .pairwise import NEG, AlignConfig, Scoring

G = 32          # wavefronts per group
ADV_BIAS = 128  # per-group corridor drift limit (the TPU realign's range)


def _region_width(W):
    return (W + G + 127) // 128 * 128


def _base_planes(q, r, dbase, a_lo, n_groups, GWp):
    """ZQ/ZR group region planes (n_groups, B, GWp) int8 (numpy).
    dbase: (n_groups, B) per-group window base diagonals."""
    B, n_pad = q.shape
    m_pad = r.shape[1]
    gs = a_lo + np.arange(n_groups, dtype=np.int64)[:, None, None] * G
    x = np.arange(GWp, dtype=np.int64)[None, None, :]
    c0b = dbase.astype(np.int64)[:, :, None]
    # ZQ[g, b, x] = q[b, s], s = ((a_g + G - 1 - dbase) - x) // 2 - 1
    sq = ((gs + G - 1 - c0b) - x) // 2 - 1
    sr = ((gs + c0b) + x) // 2 - 1
    qi = np.clip(sq, 0, n_pad - 1)
    ri = np.clip(sr, 0, m_pad - 1)
    bidx = np.arange(B, dtype=np.int64)[None, :, None]
    zq = q[bidx, qi].astype(np.int8)
    zr = r[bidx, ri].astype(np.int8)
    zq[(sq < 0) | (sq >= n_pad)] = 4          # sentinel: never matches
    zr[(sr < 0) | (sr >= m_pad)] = 5
    return zq, zr


def _group_windows(c_rows, n_acts, W, a_lo, n_groups):
    """Per-group window base diagonals (n_groups, B) int32: the corridor's
    diagonal offset c[i] - i at the row whose band midpoint crosses the
    group's mid wavefront (the group-quantization of the corridor)."""
    B = len(c_rows)
    dbase = np.zeros((n_groups, B), np.int32)
    a_mids = a_lo + np.arange(n_groups, dtype=np.int64) * G + G // 2
    for b in range(B):
        n = int(n_acts[b])
        c = np.asarray(c_rows[b], np.int64)[:n + 1]
        rows = np.arange(n + 1, dtype=np.int64)
        wmid = rows + c + W // 2              # monotone in i
        ii = np.clip(np.searchsorted(wmid, a_mids), 0, n)
        dbase[:, b] = (c[ii] - ii).astype(np.int32)
    return dbase


def _prepare(q, r, c_rows, n_acts, m_acts, W):
    """Host staging: wavefront range, per-group windows, metadata planes
    and base planes."""
    B = q.shape[0]
    c_rows = [np.asarray(c, np.int64) for c in c_rows]
    a_lo = min(max(0, int(c_rows[b][0])) for b in range(B))
    a_hi = max(int(n_acts[b])
               + min(int(m_acts[b]),
                     int(c_rows[b][int(n_acts[b])]) + W - 1)
               for b in range(B))
    n_groups = max(1, -(-(a_hi - a_lo + 1) // G))
    dbase = _group_windows(c_rows, n_acts, W, a_lo, n_groups)
    adv = np.diff(dbase, axis=0, prepend=dbase[:1]).astype(np.int32)
    dmin = dbase.min(axis=0).astype(np.int32)
    span = int((dbase.max(axis=0) - dmin).max())
    Wcap = -(-(W + span) // 128) * 128
    par = np.zeros((B, 128), np.int32)
    par[:, 0] = n_acts
    par[:, 1] = m_acts
    par[:, 2] = dmin
    if int(np.abs(adv).max()) >= ADV_BIAS:
        gi, bi = np.unravel_index(int(np.abs(adv).argmax()), adv.shape)
        raise ValueError(
            'per-group corridor drift too large for the wavefront kernel: '
            'task %d advances %d diagonals entering group %d (limit %d). '
            'Corridors must drift < %d diagonals per %d-row group — '
            'production build_corridor output (MAX_SHIFT-capped) always '
            'satisfies this.' % (bi, int(adv[gi, bi]), gi, ADV_BIAS,
                                 ADV_BIAS, G))
    db = np.zeros((n_groups, B, 128), np.int32)
    db[:, :, 0] = dbase
    db[:, :, 1] = adv
    # capture flag (col 2): does any task cross row n or column m in this
    # group's wavefront range? Row n of task b is crossed at wavefronts
    # [2n + dbase_g, 2n + dbase_g + W), column m at
    # (2m - dbase_g - W, 2m - dbase_g].
    a0s = a_lo + np.arange(n_groups, dtype=np.int64)[:, None] * G
    a1s = a0s + G - 1
    n2b = 2 * n_acts.astype(np.int64)[None, :]
    m2b = 2 * m_acts.astype(np.int64)[None, :]
    rn_lo = n2b + dbase
    rn_hi = rn_lo + W - 1
    cm_hi = m2b - dbase
    cm_lo = cm_hi - W + 1
    hit = ((rn_lo <= a1s) & (rn_hi >= a0s)) | \
        ((cm_lo <= a1s) & (cm_hi >= a0s))
    db[:, :, 2] = hit.any(axis=1)[:, None]
    GWp = _region_width(W)
    zq, zr = _base_planes(q, r, dbase, a_lo, n_groups, GWp)
    return par, db, zq, zr, a_lo, n_groups, Wcap, GWp, dmin


def _shift(x, d):
    """x shifted by d lanes along dim 1 (d > 0: right, d < 0: left), NEG
    fill."""
    fill = torch.full((x.shape[0], abs(d)), NEG, dtype=x.dtype,
                      device=x.device)
    if d > 0:
        return torch.cat([fill, x[:, :-d]], 1)
    return torch.cat([x[:, -d:], fill], 1)


def _take(x, src, width, fill):
    """out[:, k] = x[:, src[:, k]] where 0 <= src < width, else fill."""
    ok = (src >= 0) & (src < width)
    return torch.where(ok, torch.gather(x, 1, src.clamp(0, width - 1)),
                       fill)


def wavefront_forward_plain(par, db, zq, zr, W: int, Wcap: int, a_lo: int,
                            scoring: Scoring, config: AlignConfig):
    """Plain PyTorch version of the kernel: the Pallas body step by step,
    batched over tasks. par (B, 128) int32 [n, m, dmin]; db (n_groups, B,
    128) int32 [dbase, adv, capture flag]; zq / zr (n_groups, B, GWp) int8.
    Returns hatn, lcv, lci (B, Wcap) int32."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    n_groups, B = db.shape[:2]
    dev = par.device
    i64 = torch.int64
    lane = torch.arange(W, device=dev, dtype=i64)[None, :]
    lane_c = torch.arange(Wcap, device=dev, dtype=i64)[None, :]
    par = par.to(i64)
    db = db.to(i64)
    nn, mm, dmin = par[:, 0:1], par[:, 1:2], par[:, 2:3]
    n2, m2 = 2 * nn, 2 * mm
    neg = torch.full((B, W), NEG, dtype=i64, device=dev)
    h1, h2, e, f = neg, neg, neg, neg
    hatn = torch.full((B, Wcap), NEG, dtype=i64, device=dev)
    lcv = hatn.clone()
    lci = torch.zeros((B, Wcap), dtype=i64, device=dev)
    for g in range(n_groups):
        c0, adv = db[g, :, 0:1], db[g, :, 1:2]
        zqg, zrg = zq[g].to(i64), zr[g].to(i64)
        if bool((adv != 0).any()):
            h1, h2, e, f = (_take(x, lane + adv, W, NEG)
                            for x in (h1, h2, e, f))
        hat_l = neg
        lcv_l = neg
        lci_l = torch.zeros((B, W), dtype=i64, device=dev)
        a0 = a_lo + g * G
        for t in range(G):
            a = a0 + t
            u = a - c0
            jv = a + c0
            qv = zqg[:, G - 1 - t:G - 1 - t + W]
            rv = zrg[:, t:t + W]
            f_new = torch.maximum(_shift(h1, -1) + open_,
                                  _shift(f, -1) + ext)
            e_new = torch.maximum(_shift(h1, 1) + open_, _shift(e, 1) + ext)
            e_new = torch.where(e_new > NEG // 2, e_new, NEG)
            sub = torch.where(qv == rv, match_s, mismatch)
            i1n = (lane <= u - 2) & (lane >= u - n2)
            jge1 = lane >= 2 - jv
            jge0 = lane >= -jv
            jlem = lane <= m2 - jv
            diag = torch.where(i1n & jge1 & jlem, h2 + sub, NEG)
            col0 = 0 if config.free_start_s1 else open_ + (a - 1) * ext
            diag = torch.where(i1n & (lane == -jv), col0, diag)
            gg = torch.maximum(diag, torch.where(jge1, f_new, NEG))
            h = torch.maximum(gg, torch.where(jge1, e_new, NEG))
            h = torch.where(i1n & jge0 & jlem, h, NEG)
            if config.free_start_s2:
                h0v = 0 if a >= 0 else NEG
            else:
                h0v = open_ + (a - 1) * ext if a > 0 else \
                    (0 if a == 0 else NEG)
            h0v = torch.where(a <= mm, h0v, NEG)
            h = torch.where(lane == u, h0v, h)
            hat_l = torch.where(lane == u - n2, h, hat_l)
            lcm = (lane == m2 - jv) & (u - lane >= 0) & (u - lane <= n2)
            hlc = torch.where(lcm, h, NEG)
            better = hlc > lcv_l
            lcv_l = torch.where(better, hlc, lcv_l)
            lci_l = torch.where(better, (u - lane) >> 1, lci_l)
            h2, h1, e, f = h1, h, e_new, f_new
        if int(db[g, 0, 2]) > 0:
            src = lane_c - (c0 - dmin)
            hat_a = _take(hat_l, src, W, NEG)
            lcv_a = _take(lcv_l, src, W, NEG)
            lci_a = _take(lci_l, src, W, 0)
            hatn = torch.where(hat_a > NEG, hat_a, hatn)
            take = lcv_a > lcv
            lcv = torch.where(take, lcv_a, lcv)
            lci = torch.where(take, lci_a, lci)
    return hatn.to(torch.int32), lcv.to(torch.int32), lci.to(torch.int32)


# The kernel's layout (csrc/wavefront_fwd.cu). Only the lanes with
# a - dbase_g - k even hold real cells at wavefront a, and a real lane
# reads only real lanes (E from k - 1 and F from k + 1 at a - 1, the
# diagonal from k at a - 2), so the kernel computes one cell per lane
# PAIR (2p, 2p + 1) per wavefront, the pair's active lane alternating.
# A warp holds WINDOW pairs, PAIRS a thread, and owns the SEG in the
# middle: a step passes values one pair along, so the HALO pairs at each
# edge absorb a group's G steps and the warps of a task exchange their
# carries once a group, through a per-lane buffer, at the realign.
PAIRS = 4                       # pairs a thread
WINDOW = 32 * PAIRS             # pairs a warp computes
HALO = G // 2                   # pairs each side of the owned ones
SEG = WINDOW - 2 * HALO         # pairs a warp owns (a segment)
CLUSTER_SIZES = (1, 2, 4, 8)
WARPS_AIM = 4                   # warps a block the cluster size aims for
MAX_WARPS = 16                  # warps a block at most
SMEM_LIMIT = 232448             # bytes of shared memory a block may use
SMS = 132


def task_groups(par, n_groups: int, a_lo: int):
    """Groups each task runs (B,) int64: through the one holding
    wavefront n + m, its last cell with a value. Every capture with a
    value is a cell (n, j <= m) or (i <= n, m), so later groups leave the
    outputs as they are."""
    nm = par[:, 0].to(torch.int64) + par[:, 1].to(torch.int64)
    return ((nm - a_lo) // G + 1).clamp(0, n_groups)


def launch_plan(B: int, W: int):
    """(C, NW, L, global_state) of a launch of B tasks at band W: a
    cluster of C blocks a task, NW warps a block, L segments a warp,
    and whether the carries exchange through a global scratch instead
    of the blocks' shared memory. C is the smallest cluster size with
    at most WARPS_AIM warps a block, cut while B x C exceeds the card's
    SMs (tasks then fill the card); NW covers the segments at C (at
    most MAX_WARPS), and a warp loops over L segments beyond that. The
    carries sit in shared memory (read across the cluster) while they
    fit; csrc/wavefront_fwd.cu checks the same rule."""
    nseg = -(-(W // 2) // SEG)
    C = next((c for c in CLUSTER_SIZES if -(-nseg // c) <= WARPS_AIM),
             CLUSTER_SIZES[-1])
    while C > 1 and B * C > SMS:
        C //= 2
    NW = min(MAX_WARPS, -(-nseg // C))
    L = -(-nseg // (C * NW))
    return C, NW, L, smem_bytes(NW, L, False) > SMEM_LIMIT


def smem_bytes(NW: int, L: int, global_state: bool):
    """Shared memory of a block: each warp's two staged base windows (q
    and r planes), and unless the carries go through global memory, two
    buffers of (H, E, F) for the block's NW x L segments of 2 SEG lanes."""
    stage = NW * 2 * 2 * (2 * WINDOW + G)
    return stage + (0 if global_state else 2 * 3 * 4 * NW * L * 2 * SEG)


def wavefront_forward_pairs(par, db, zq, zr, W: int, Wcap: int, a_lo: int,
                            scoring: Scoring, config: AlignConfig, seg=SEG):
    """The kernel's algorithm in plain PyTorch: real lanes only, one cell
    per lane pair and wavefront, segments of `seg` owned pairs computed
    over windows HALO pairs wider on each side, carries exchanged per
    lane once a group, captures written as they happen, each task
    stopped after task_groups. Same contract and outputs as
    wavefront_forward_plain (which computes every lane, as the TPU
    kernel does)."""
    match_s, mismatch = int(scoring.match), int(scoring.mismatch)
    open_, ext = int(scoring.gap_open), int(scoring.gap_extend)
    n_groups, B = db.shape[:2]
    GWp = zq.shape[2]
    dev = par.device
    i64 = torch.int64
    Wh = W // 2
    Wn = seg + 2 * HALO
    nseg = -(-Wh // seg)
    w = torch.arange(Wn, device=dev, dtype=i64)
    pp = (torch.arange(nseg, device=dev, dtype=i64)[:, None] * seg - HALO
          + w[None, :])[None]                                 # (1, nseg, Wn)
    valid = (pp >= 0) & (pp < Wh)
    owned = valid & (w >= HALO) & (w < HALO + seg)
    par = par.to(i64)
    nn = par[:, 0].view(B, 1, 1)
    mm = par[:, 1].view(B, 1, 1)
    dmin = par[:, 2].view(B, 1, 1)
    ngt = task_groups(par, n_groups, a_lo).view(B, 1, 1)
    buf = torch.full((3, B, W), NEG, dtype=i64, device=dev)   # H, E, F
    hatn = torch.full((B, Wcap), NEG, dtype=i64, device=dev)
    lcv = hatn.clone()
    lci = torch.zeros((B, Wcap), dtype=i64, device=dev)
    negcol = torch.full((B, nseg, 1), NEG, dtype=i64, device=dev)

    def lanes_of(x, lanes, width, fill):
        ok = (lanes >= 0) & (lanes < width)
        idx = lanes.clamp(0, width - 1).expand(B, nseg, Wn).reshape(B, -1)
        got = torch.gather(x, 1, idx).view(B, nseg, Wn)
        return torch.where(ok, got, fill)

    def store(x, lanes, vals, mask):
        bi, si, wi = torch.nonzero(mask.expand(B, nseg, Wn), as_tuple=True)
        x[bi, lanes.expand(B, nseg, Wn)[bi, si, wi]] = vals[bi, si, wi]

    for g in range(int(ngt.max()) if B else 0):
        act = ngt > g
        d = db[g].to(i64)
        c0, adv = d[:, 0].view(B, 1, 1), d[:, 1].view(B, 1, 1)
        hit = int(d[0, 2]) > 0
        a0 = a_lo + g * G
        u0 = a0 - c0
        lane_a = 2 * pp + ((u0 - 1) & 1)      # active at a0 - 1
        lane_b = 2 * pp + (u0 & 1)            # active at a0 - 2
        ok_a = valid & (lane_a + adv >= 0) & (lane_a + adv < W)
        ok_b = valid & (lane_b + adv >= 0) & (lane_b + adv < W)
        hp, ep, fp = (torch.where(ok_a, lanes_of(x, lane_a + adv, W, NEG),
                                  NEG) for x in buf)
        h2 = torch.where(ok_b, lanes_of(buf[0], lane_b + adv, W, NEG), NEG)
        zqg, zrg = zq[g].to(i64), zr[g].to(i64)
        for t in range(G):
            a = a0 + t
            u = a - c0
            jv = a + c0
            odd = (u & 1) == 1
            k = 2 * pp + (u & 1)
            left_h = torch.cat([negcol, hp[..., :-1]], 2)
            left_e = torch.cat([negcol, ep[..., :-1]], 2)
            right_h = torch.cat([hp[..., 1:], negcol], 2)
            right_f = torch.cat([fp[..., 1:], negcol], 2)
            hl = torch.where(odd, hp, left_h)
            el = torch.where(odd, ep, left_e)
            hr = torch.where(odd, right_h, hp)
            fr = torch.where(odd, right_f, fp)
            f_new = torch.maximum(hr + open_, fr + ext)
            e_new = torch.maximum(hl + open_, el + ext)
            e_new = torch.where(e_new > NEG // 2, e_new, NEG)
            qv = lanes_of(zqg, G - 1 - t + k, GWp, 4)
            rv = lanes_of(zrg, t + k, GWp, 5)
            sub = torch.where(qv == rv, match_s, mismatch)
            i = (u - k) >> 1
            j = (jv + k) >> 1
            i1n = (i >= 1) & (i <= nn)
            jge1 = j >= 1
            jin0 = (j >= 0) & (j <= mm)
            diag = torch.where(i1n & jge1 & (j <= mm), h2 + sub, NEG)
            col0 = 0 if config.free_start_s1 else open_ + (a - 1) * ext
            diag = torch.where(i1n & (j == 0), col0, diag)
            gg = torch.maximum(diag, torch.where(jge1, f_new, NEG))
            h = torch.maximum(gg, torch.where(jge1, e_new, NEG))
            h = torch.where(i1n & jin0, h, NEG)
            if config.free_start_s2:
                h0v = 0 if a >= 0 else NEG
            else:
                h0v = open_ + (a - 1) * ext if a > 0 else \
                    (0 if a == 0 else NEG)
            h0v = torch.where(a <= mm, h0v, NEG)
            h = torch.where(i == 0, h0v, h)
            h, e_new, f_new = (torch.where(valid, x, NEG)
                               for x in (h, e_new, f_new))
            if hit:
                cap = owned & act & (h > NEG)
                xa = k + c0 - dmin
                store(hatn, xa, h, cap & (i == nn))
                at_m = cap & (j == mm) & (i >= 0) & (i <= nn)
                store(lcv, xa, h, at_m)
                store(lci, xa, i, at_m)
            h2, hp, ep, fp = hp, h, e_new, f_new
        done = owned & act
        lane_a = 2 * pp + ((u0 + 1) & 1)      # active at a0 + G - 1
        for x, v in zip(buf, (hp, ep, fp)):
            store(x, lane_a, v, done)
        store(buf[0], lane_b, h2, done)
    return hatn.to(torch.int32), lcv.to(torch.int32), lci.to(torch.int32)


def wavefront_forward_cuda(par, db, zq, zr, W: int, Wcap: int, a_lo: int,
                           scoring: Scoring, config: AlignConfig, plan=None):
    """Launch csrc/wavefront_fwd.cu; same contract as the plain version.
    `plan` (C, NW, L, global_state) forces a launch shape (default
    launch_plan(B, W))."""
    n_groups, B, GWp = zq.shape
    dev = par.device
    for name, x, dt in (('par', par, torch.int32), ('db', db, torch.int32),
                        ('zq', zq, torch.int8), ('zr', zr, torch.int8)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError('%s must be a contiguous %s tensor on %s'
                             % (name, dt, dev))
    if par.shape != (B, 128) or db.shape != (n_groups, B, 128) \
            or zr.shape != zq.shape:
        raise ValueError('inconsistent wavefront input shapes')
    C, NW, L, glob = plan or launch_plan(B, W)
    hatn = torch.empty((B, Wcap), dtype=torch.int32, device=dev)
    lcv = torch.empty((B, Wcap), dtype=torch.int32, device=dev)
    lci = torch.empty((B, Wcap), dtype=torch.int32, device=dev)
    scratch = torch.empty((B * 6 * W if glob else 1,), dtype=torch.int32,
                          device=dev)
    lib = cuda_lib.lib()
    with cuda_lib.timed('wavefront_fwd', dev, (par, db, zq, zr, hatn, lcv,
                                               lci)):
        err = lib.wavefront_fwd_launch(
            par.data_ptr(), db.data_ptr(), zq.data_ptr(), zr.data_ptr(),
            hatn.data_ptr(), lcv.data_ptr(), lci.data_ptr(),
            scratch.data_ptr(), B, W, Wcap, GWp, n_groups, a_lo, C, NW, L,
            int(glob), int(scoring.match), int(scoring.mismatch),
            int(scoring.gap_open), int(scoring.gap_extend),
            int(config.free_start_s1), int(config.free_start_s2),
            cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, 'wavefront_fwd')
    cuda_lib.LAUNCHES['wavefront_fwd'] += 1
    return hatn, lcv, lci


def wavefront_forward(par, db, zq, zr, W: int, Wcap: int, a_lo: int,
                      scoring: Scoring, config: AlignConfig):
    """The forward on the tensors' device: (hatn, lcv, lci) (B, Wcap)."""
    args = (par.to(torch.int32).contiguous(), db.to(torch.int32).contiguous(),
            zq.to(torch.int8).contiguous(), zr.to(torch.int8).contiguous())
    if par.device.type == 'cuda':
        return wavefront_forward_cuda(*args, W, Wcap, a_lo, scoring, config)
    if par.device.type == 'cpu':
        return wavefront_forward_plain(*args, W, Wcap, a_lo, scoring, config)
    raise ValueError('unsupported device %s' % par.device)


def wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, scoring: Scoring,
                             config: AlignConfig, W: int, device=None):
    """Batched banded DP over per-row corridors, anti-diagonal wavefront,
    on `device` (CUDA by default; 'cpu' runs the plain version).

    q: (B, n_pad) int8, r: (B, m_pad) int8; c_rows[b] is task b's
    nondecreasing per-row band-start array (length >= n_acts[b] + 1, the
    ops.banded corridor convention: row i covers columns
    [c[i], c[i] + W)), group-quantized to per-group diagonal windows.
    Returns (score, end_i, end_j) numpy arrays with the end selection of
    ops.banded._banded_single (corner, then the free_end_s2 argmax, then
    free_end_s1 with the smallest row winning ties).

    Precondition: each corridor may drift < ADV_BIAS (= 128) diagonals
    per G-row group (ValueError otherwise); build_corridor's per-row drift
    cap (MAX_SHIFT = 4) bounds group drift at 4 * G."""
    dev = resolve_device(device)
    q = np.ascontiguousarray(q, np.int8)
    r = np.ascontiguousarray(r, np.int8)
    n_acts = np.asarray(n_acts, np.int32)
    m_acts = np.asarray(m_acts, np.int32)
    B = q.shape[0]
    assert W % 128 == 0
    assert np.all(n_acts >= 1), 'wavefront prototype requires n_act >= 1'

    par, db, zq, zr, a_lo, n_groups, Wcap, GWp, dmin = _prepare(
        q, r, c_rows, n_acts, m_acts, W)
    outs = wavefront_forward(*(torch.from_numpy(x).to(dev)
                               for x in (par, db, zq, zr)),
                             W=W, Wcap=Wcap, a_lo=a_lo, scoring=scoring,
                             config=config)
    hatn, lcv, lci = (x.cpu().numpy() for x in outs)

    # ---- end selection (mirrors _banded_single) -------------------------
    ks = np.arange(Wcap, dtype=np.int64)
    score = np.empty(B, np.int32)
    end_i = np.empty(B, np.int32)
    end_j = np.empty(B, np.int32)
    for b in range(B):
        n, m, c = int(n_acts[b]), int(m_acts[b]), int(dmin[b])
        best, ei, ej = NEG, n, m
        kc = m - n - c
        if 0 <= kc < Wcap:
            best = int(hatn[b, kc])
        if config.free_end_s2:
            row_vals = np.where(c + n + ks <= m, hatn[b], NEG)
            kb = int(np.argmax(row_vals))
            s = int(row_vals[kb])
            if s > best:
                best, ej = s, c + n + kb
        if config.free_end_s1:
            s = int(lcv[b].max())
            if s > best:
                cand = lcv[b] == s
                best, ei, ej = s, int(lci[b][cand].min()), m
        score[b] = best
        end_i[b] = ei
        end_j[b] = ej
    return score, end_i, end_j


def wavefront_batch(q, r, c0, n_acts, m_acts, scoring: Scoring,
                    config: AlignConfig, W: int, device=None):
    """Straight-corridor convenience wrapper: band of task b is
    [c0[b] + i, c0[b] + i + W) at row i, the zero-drift case of
    wavefront_batch_corridor."""
    c0 = np.asarray(c0, np.int64)
    n_acts = np.asarray(n_acts, np.int32)
    c_rows = [c0[b] + np.arange(int(n_acts[b]) + 1, dtype=np.int64)
              for b in range(len(c0))]
    return wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, scoring,
                                    config, W, device=device)
