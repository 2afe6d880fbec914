"""Host-side tape builder for the anti-diagonal WAVEFRONT banded DP.

A copy of unicycler_tpu/ops/wavetape.py without its two-buffer launch
packer (this package uploads the WaveLaunch arrays directly). Companion to
ops/wavetape_kernels.py: every task of an align_banded call is laid out
back-to-back along the WAVEFRONT axis of one launch (bt tracks). Every
Gotoh predecessor lives on wavefront a-1 or a-2, so one wavefront step
is a handful of shifted elementwise ops.

Layout facts the device side relies on:

  * A task with corridor c (ops/banded.build_corridor, n+1 rows) spans
    task-local wavefronts a in [a0, a_hi], a0 = max(0, c[0]),
    a_hi = n + min(m, c[n] + W - 1); its tape extent is that span padded
    to a multiple of G. Each G-wavefront GROUP belongs to exactly one
    task; task starts are group-aligned.
  * Per group the diagonal window [dbase_g, dbase_g + W) is fixed
    (group-quantized from the corridor at the group's mid wavefront,
    exactly unicycler_tpu/ops/pallas_wavefront._group_windows); carries
    realign by the inter-group advance (int8, |adv| < 128 by the
    corridor's MAX_SHIFT row-drift cap).
  * q bases take 1 byte per DP ROW per track (q_tape, each task's bases
    stored reversed); the reference windows go once into r_flat (W
    sentinel pad around each window). The forward kernel reads each
    lane's bases straight from these two arrays.
  * Windows the kernel reads from q_tape/r_flat may bleed into a
    NEIGHBOUring task's bytes: those lanes are always masked dead in the
    kernel (their cells have i outside [1, n] or j outside [1, m]), so
    only the global head/tail pads matter for bounds.

Replaces the role of SeqAn's bandedChainAlignment driving loop at batch
scale (ref src/semi_global_align.cpp:293-311).
"""

from typing import List, NamedTuple

import numpy as np

from .encode import Q_PAD, R_PAD
from .tape import _bucket_geom, _bucket_pow2, choose_bt

G = 32                  # wavefronts per group (kernel unroll unit)
G_CAP_FACTOR = 2        # per-launch group budget multiplier (see g_cap)

# global pads so device window loads never leave the arrays: q windows
# reach ~(W + G)/2 rows past either task edge, r windows ~W/2 + G
# columns past the per-task W sentinel pad (see module docstring on
# bleed) — W-dependent so wide-band tapes (W up to 2048) keep their
# lane-domain starts un-clipped (a clipped start silently SHIFTS the
# whole window: caught as an end-of-task base mismatch at W=2048).
def _pad_head(W):
    return max(512, W)


class WaveLaunch(NamedTuple):
    """One wavefront-tape kernel launch. All arrays host numpy."""
    q_tape: np.ndarray      # (BT, LR) uint8 q codes (Q_PAD elsewhere)
    r_flat: np.ndarray      # (BT, M) int8
    adv8: np.ndarray        # (BT, NG) int8 window advance at group entry
    gflags: np.ndarray      # (BT, NG) uint8: bit0 reset, bit1 capture-hit
    # per-(track, task) int32 arrays, shape (BT, TT); -1/0 padded
    n_t: np.ndarray         # n_act
    m_t: np.ndarray         # m_act
    r_base: np.ndarray      # task's region start in r_flat (r at +W... see tape)
    rowbase: np.ndarray     # task's first q row in q_tape
    dbase0: np.ndarray      # first-group window base MINUS the track's
                            # adv-cumsum at the task's first group (so
                            # dbase_g = cumsum(adv8)[g] + dbase0[task])
    a0: np.ndarray          # task-local wavefront of the task's first
                            # tape wavefront (= max(0, c[0]))
    seg_g: np.ndarray       # task's first group index on the track
    lastg: np.ndarray       # task's last group index
    abase: np.ndarray       # seg_g*G - a0: tape addr of cell (i,j) is
                            # abase + i + j
    n_tasks: np.ndarray     # (BT,)
    task_ids: np.ndarray    # (BT, TT); -1 pad
    NG: int                 # padded group count (LA = NG * G)
    NG_real: int
    TT: int
    LR: int                 # q_tape row length


# WaveLaunch fields in the argument order of
# ops/wavetape_kernels.wavetape_forward
FORWARD_INPUTS = ('q_tape', 'r_flat', 'adv8', 'gflags', 'n_t', 'm_t',
                  'r_base', 'rowbase', 'dbase0', 'a0', 'seg_g', 'lastg')


def forward_inputs(tp):
    """A launch's arrays in wavetape_forward's argument order."""
    return [getattr(tp, f) for f in FORWARD_INPUTS]


def _task_span(c, n, m, W):
    """(a0, a_hi, n_groups) for one task's corridor."""
    a0 = max(0, int(c[0]))
    a_hi = n + min(m, int(c[n]) + W - 1)
    ng = max(1, -(-(a_hi - a0 + 1) // G))
    return a0, a_hi, ng


def _task_windows(c, n, W, a0, ng):
    """Per-group window base diagonals (ng,) int64 for one task
    (the corridor's diagonal offset c[i] - i at the row whose band
    midpoint crosses the group's mid wavefront — identical semantics to
    ops/pallas_wavefront._group_windows)."""
    c = np.asarray(c, np.int64)[:n + 1]
    rows = np.arange(n + 1, dtype=np.int64)
    wmid = rows + c + W // 2
    a_mids = a0 + np.arange(ng, dtype=np.int64) * G + G // 2
    ii = np.clip(np.searchsorted(wmid, a_mids), 0, n)
    return c[ii] - ii


def build_wavetapes(tasks, W, build_corridor, bt=None) -> List[WaveLaunch]:
    """Lay out tasks into wavefront-tape launches. Tasks with empty q or
    r must be filtered by the caller. `bt` forces the track count (by
    default tape.choose_bt picks it)."""
    # per-task staging: corridor, span, per-group windows
    metas = []
    for ti, t in enumerate(tasks):
        n, m = len(t.q), len(t.r)
        c = build_corridor(t.corridor_read, t.corridor_ref, n, m, W)
        a0, a_hi, ng = _task_span(c, n, m, W)
        dbase = _task_windows(c, n, W, a0, ng)
        metas.append((ti, n, m, a0, ng, dbase))

    order = sorted(range(len(tasks)), key=lambda i: -metas[i][4])
    # group cap per launch: bounds the (bt, LA/8, W) moves intermediate
    # in device memory and the per-launch records copy.
    if bt is None:
        bt = choose_bt([metas[i][4] * G for i in order])
    from .tape import L_CAP
    g_cap = max(64, (G_CAP_FACTOR * L_CAP) * 256 * 8
                // (W * bt) // G // 16 * 16)

    launches = []
    remaining = order
    while remaining:
        loads = [0] * bt
        assign: List[List[int]] = [[] for _ in range(bt)]
        overflow = []
        for ti in remaining:
            ng = metas[ti][4]
            k = loads.index(min(loads))
            if loads[k] and loads[k] + ng > g_cap:
                overflow.append(ti)
            else:
                assign[k].append(ti)
                loads[k] += ng
        launches.append(_build_one(tasks, metas, assign, max(loads), W, bt))
        remaining = overflow
    return launches


def _build_one(tasks, metas, assign, NG_real, W, bt) -> WaveLaunch:
    NG = _bucket_geom(max(NG_real, 16), 16, 8)
    TT = _bucket_pow2(max(max((len(a) for a in assign), default=1), 8), 8)

    # per-track q rows / r sizes
    q_loads = np.zeros(bt, np.int64)
    r_sizes = np.zeros(bt, np.int64)
    for tr in range(bt):
        for ti in assign[tr]:
            q_loads[tr] += metas[ti][1]
            r_sizes[tr] += metas[ti][2] + 2 * W
    pad = _pad_head(W)
    LR = _bucket_geom(int(q_loads.max()) + 2 * pad, 1024, 512)
    M = _bucket_geom(int(r_sizes.max()) + 2 * pad, 1024, 512)

    q_tape = np.full((bt, LR), Q_PAD, np.uint8)
    r_flat = np.full((bt, M), R_PAD, np.int8)
    adv8 = np.zeros((bt, NG), np.int8)
    gflags = np.zeros((bt, NG), np.uint8)
    per = {name: np.full((bt, TT), -1, np.int32)
           for name in ('n_t', 'm_t', 'r_base', 'rowbase', 'dbase0', 'a0',
                        'seg_g', 'lastg', 'abase', 'task_ids')}
    n_tasks = np.zeros(bt, np.int32)

    for tr in range(bt):
        row_cursor = pad
        r_cursor = pad
        g_cursor = 0
        for ti in assign[tr]:
            t = tasks[ti]
            _, n, m, a0, ng, dbase = metas[ti]
            # q is stored REVERSED per task (the layout the TPU kernel
            # needed for one ascending slice per group; kept so both
            # packages build identical launches)
            q_tape[tr, row_cursor:row_cursor + n] = t.q[::-1]
            r_flat[tr, r_cursor + W:r_cursor + W + m] = t.r

            # group windows: advance deltas within the task; 0 at reset
            adv = np.diff(dbase, prepend=dbase[:1])
            assert np.abs(adv).max(initial=0) < 128, \
                'inter-group drift exceeds int8 (corridor not MAX_SHIFT-capped?)'
            adv8[tr, g_cursor:g_cursor + ng] = adv.astype(np.int8)
            gflags[tr, g_cursor] |= 1
            # capture-hit flag: does any wavefront of group k cross row n
            # or column m? (unicycler_tpu/ops/pallas_wavefront._prepare)
            a0s = a0 + np.arange(ng, dtype=np.int64) * G
            a1s = a0s + G - 1
            rn_lo = 2 * n + dbase
            rn_hi = rn_lo + W - 1
            cm_hi = 2 * m - dbase
            cm_lo = cm_hi - W + 1
            hit = ((rn_lo <= a1s) & (rn_hi >= a0s)) | \
                ((cm_lo <= a1s) & (cm_hi >= a0s))
            gflags[tr, g_cursor:g_cursor + ng] |= (hit << 1).astype(np.uint8)

            kk = n_tasks[tr]
            per['n_t'][tr, kk] = n
            per['m_t'][tr, kk] = m
            per['r_base'][tr, kk] = r_cursor
            per['rowbase'][tr, kk] = row_cursor
            per['dbase0'][tr, kk] = int(dbase[0])   # adjusted below
            per['a0'][tr, kk] = a0
            per['seg_g'][tr, kk] = g_cursor
            per['lastg'][tr, kk] = g_cursor + ng - 1
            per['abase'][tr, kk] = g_cursor * G - a0
            per['task_ids'][tr, kk] = ti
            n_tasks[tr] += 1

            row_cursor += n
            r_cursor += m + 2 * W
            g_cursor += ng

    # device reconstructs dbase_g = cumsum(adv8)[g] + dbase0[task]; since
    # the cumsum is global per track, subtract its value at each task's
    # first group (the tape.py cbase trick)
    for tr in range(bt):
        s_cum = np.cumsum(adv8[tr].astype(np.int64))
        for kk in range(n_tasks[tr]):
            g0 = per['seg_g'][tr, kk]
            per['dbase0'][tr, kk] -= int(s_cum[g0])

    return WaveLaunch(q_tape=q_tape, r_flat=r_flat, adv8=adv8,
                      gflags=gflags, n_tasks=n_tasks, NG=NG,
                      NG_real=NG_real, TT=TT, LR=LR, **per)
