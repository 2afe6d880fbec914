"""Host-side tape builder for the anti-diagonal WAVEFRONT banded DP.

A copy of unicycler_tpu/ops/wavetape.py without its two-buffer launch
packer (this package uploads the WaveLaunch arrays directly), plus the
card's own launch layout. Companion to ops/wavetape_kernels.py. Every
Gotoh predecessor lives on wavefront a-1 or a-2, so one wavefront step
is a handful of shifted elementwise ops. Two layouts of the same tasks:

  * build_wavetapes (the JAX package's): tasks back-to-back along the
    wavefront axis of bt = 8, 16 or 32 tracks (tape.choose_bt), launches
    cut by a group cap. Its cost model is the TPU's, where one step of
    the vector unit costs in proportion to bt.
  * build_wave_launches (the card's, which ops/banded takes): one task a
    track, tasks sorted longest first, launches cut by a byte budget for
    the moves (MOVES_BUDGET) and the tasks split evenly over them, so a
    launch holds hundreds of tracks and every SM gets blocks.

Per-task outputs do not depend on the layout: window quantisation is per
task, group windows start at each task's own a0, each group belongs to
one task, the carries reset at a task's first group, and the sq / sr
clamps of ops/wavetape_kernels.group_plane bind only in the tape's head
and tail pads (tests/test_torch_wave_layout.py holds both layouts to the
JAX package's wave route). One difference stays inside the route: in the
JAX layout the walk of a task with no path starts at its unreachable
corner and may overwrite the records of the task beside it on the track,
which then retries on the banded kernel, to the alignment the wave route
had found; with one task a track no walk reaches another task.

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
    sentinel pad around each window). The forward kernel copies each
    group's q and r windows from these two arrays into shared memory.
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
# Moves bytes one build_wave_launches launch may hold on the card. A
# polish round of the assembly holds ~16 GB of moves at W = 512 in all;
# ops/banded frees a launch's moves once its walk is queued, so a call
# holds one launch's at a time, and two calls in flight stay far inside
# an 80 GB card beside the run's other memory.
MOVES_BUDGET = 6 << 30

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


def moves_bytes(tracks, NG, W):
    """Bytes of a launch's moves: one int32 word per 8 wavefronts, lane
    and track."""
    return tracks * NG * (G // 8) * W * 4


def padded_groups(NG_real):
    """The group count a launch whose longest track has NG_real groups is
    padded to."""
    return _bucket_geom(max(NG_real, 16), 16, 8)


def _stage_tasks(tasks, W, build_corridor):
    """Per task: (index, n, m, a0, group count, per-group window bases)."""
    metas = []
    for ti, t in enumerate(tasks):
        n, m = len(t.q), len(t.r)
        c = build_corridor(t.corridor_read, t.corridor_ref, n, m, W)
        a0, a_hi, ng = _task_span(c, n, m, W)
        dbase = _task_windows(c, n, W, a0, ng)
        metas.append((ti, n, m, a0, ng, dbase))
    return metas


def split_by_budget(ngs, W, budget=MOVES_BUDGET, launch_bytes=None):
    """Cut task sizes sorted longest first (group counts here; the row
    layout, ops/tape.build_row_launches, passes row counts) into
    contiguous parts whose padded moves fit `budget`: as many parts as the
    fewest that fit (or just enough more), the tasks split evenly over
    them, so the last launch is no small remainder. A part of long tasks
    that the budget fills holds fewer, and the later parts share the rest
    evenly. A task too large for the budget alone gets a part of its own.
    launch_bytes(tracks, longest size) gives a part's moves bytes (by
    default the wave layout's). Returns [(lo, hi)] index ranges."""
    n = len(ngs)
    if launch_bytes is None:
        def launch_bytes(tracks, longest):
            return moves_bytes(tracks, padded_groups(longest), W)

    def fits(lo, hi):
        return hi - lo == 1 or launch_bytes(hi - lo, ngs[lo]) <= budget

    def fill(parts_k):
        """Parts filled from the longest task, each up to the budget and,
        given parts_k, to an even share of the tasks left; None if
        parts_k parts do not take them all."""
        parts, lo = [], 0
        while lo < n:
            if parts_k is None:
                cap = n
            elif len(parts) == parts_k:
                return None
            else:
                cap = -(-(n - lo) // (parts_k - len(parts)))
            hi = lo + 1
            while hi < n and hi - lo < cap and fits(lo, hi + 1):
                hi += 1
            parts.append((lo, hi))
            lo = hi
        return parts

    for parts_k in range(len(fill(None)), n + 1):
        parts = fill(parts_k)
        if parts is not None:
            return parts
    return []


def build_wave_launches(tasks, W, build_corridor, budget=MOVES_BUDGET
                        ) -> List[WaveLaunch]:
    """The card's layout: one task a track, tracks sorted by group count
    (longest first), launches cut by `budget` bytes of moves (see
    split_by_budget). Tasks with empty q or r must be filtered by the
    caller. Launches are WaveLaunch records like build_wavetapes', so the
    kernels, the walker and the decode take either layout."""
    metas = _stage_tasks(tasks, W, build_corridor)
    order = sorted(range(len(tasks)), key=lambda i: -metas[i][4])
    ngs = [metas[i][4] for i in order]
    return [_build_one(tasks, metas, [[order[i]] for i in range(lo, hi)],
                       ngs[lo], W, hi - lo)
            for lo, hi in split_by_budget(ngs, W, budget)]


def build_wavetapes(tasks, W, build_corridor, bt=None) -> List[WaveLaunch]:
    """Lay out tasks into wavefront-tape launches exactly as the JAX
    package's build_wavetapes does. Tasks with empty q or r must be
    filtered by the caller. `bt` forces the track count (by default
    tape.choose_bt picks it)."""
    metas = _stage_tasks(tasks, W, build_corridor)
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
    NG = padded_groups(NG_real)
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
