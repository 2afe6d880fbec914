"""Host-side row-tape builder for the banded DP at wide bands.

Counterpart of unicycler_tpu/ops/tape.py. The TAPE layout concatenates
the tasks of a call along the row axis of one kernel launch. Two layouts
of the same tasks:

  * build_tapes (the JAX package's): each track owns a task list, tasks
    assigned longest-first to the least-loaded track (LPT), each padded
    to a SEG_ALIGN=32 row boundary and laid back to back; the track count
    BT is chosen per launch from {8, 16, 32} by the cost model
    serial_length(bt) x bt (the TPU's rule; kept so the layout, and with
    it every output, matches the JAX package).
  * build_row_launches (the card's, which ops/banded takes): one task a
    track, tracks sorted longest first, launches cut by a byte budget for
    the moves and the tasks split evenly over them, so a launch holds as
    many tracks as the call has tasks and the forward kernel spreads each
    track over a cluster of SMs (csrc/tape_fwd.cu).

Common to both:
  * each track owns a flat reference array: its tasks' windows laid out
    back to back, each padded with W sentinel bases on both sides.
  * per-row metadata is ONE byte (query base + reset / capture / band
    drift); everything else the kernels need is rebuilt on the device from
    small per-task arrays (ops/tape_kernels.tape_prolog).

The size buckets and the per-launch track count are shared with the
wavefront-tape builder (ops/wavetape.py).
"""

from typing import List, NamedTuple

import numpy as np

from .encode import Q_PAD, R_PAD

MAX_SHIFT = 4    # max per-row band drift (corridors are smoothed to this)
SEG_ALIGN = 32        # segment row alignment == reference-window group size
L_CAP = 131072        # tape-row budget per launch at W = 256, 8 tracks

# qf byte layout (per tape row): the query base and all row flags pack
# into ONE uint8.
#   bits 0-2: q code (0-3 base, 4 N, 5 = Q_PAD = segment-pad row)
#   bit  3:   reset (first row of a segment = DP row 1 of its task)
#   bit  4:   capture (the task's row n_act: capture H here)
#   bits 5-7: band drift si in 0..MAX_SHIFT
F_RESET = 8
F_CAPTURE = 16
F_SI_SHIFT = 5


class TapeLaunch(NamedTuple):
    """One kernel launch worth of tape. All arrays are host numpy."""
    qf: np.ndarray           # (BT, L) uint8 packed query+flags
    r_flat: np.ndarray       # (BT, M) int8
    # per-(track, task-in-track) int32 arrays, shape (BT, TT); -1 padded
    cbase: np.ndarray        # c[1] - si-cumsum offset: c_rel = S + cbase
    c0m: np.ndarray          # c[0] (row-0 band offset)
    c_n: np.ndarray          # c[n_act]
    m_t: np.ndarray          # m_act
    n_t: np.ndarray          # n_act
    r_base: np.ndarray       # task's region start in r_flat (r at +W)
    seg_start: np.ndarray    # first tape row (0-based) of the segment
    reset_slot: np.ndarray   # seg_start // 32
    cap_slot: np.ndarray     # (seg_start + n_act - 1) // 32
    last_slot: np.ndarray    # (seg_start + seg_len - 1) // 32
    n_tasks: np.ndarray      # (BT,) int32: real tasks per track
    task_ids: np.ndarray     # (BT, TT) int32: caller's task index; -1 pad
    L: int                   # padded tape rows (bucketed)
    L_real: int              # used tape rows
    TT: int


# the forward kernel's per-task inputs, in tape_kernels.tape_forward order
FORWARD_INPUTS = ('qf', 'r_flat', 'cbase', 'c0m', 'c_n', 'm_t', 'n_t',
                  'r_base', 'seg_start', 'reset_slot', 'cap_slot',
                  'last_slot')


def forward_inputs(tp):
    """The numpy arrays of a TapeLaunch that tape_forward takes, in order."""
    return [getattr(tp, name) for name in FORWARD_INPUTS]


def _bucket_pow2(n, minimum):
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_geom(n, minimum, quantum, ratio=1.125):
    """Geometric size buckets (ratio 1.125, rounded up to `quantum`):
    power-of-two buckets waste up to 50% of the tape in pad rows that
    the kernel EXECUTES and the host UPLOADS (measured 45% on the bench
    fixtures); 1.125x steps cap the waste at ~11%."""
    b = float(minimum)
    while b < n:
        b *= ratio
    return -(-int(b) // quantum) * quantum


def _aligned_len(task):
    return -(-len(task.q) // SEG_ALIGN) * SEG_ALIGN


def _lpt_serial(alens, bt):
    """Serial tape length of an LPT assignment of task row-loads `alens`
    (sorted descending) onto bt tracks: the max track load."""
    loads = [0] * bt
    for a in alens:
        k = loads.index(min(loads))
        loads[k] += a
    return max(loads)


def choose_bt(alens):
    """Pick the track count minimizing serial_length x bt (per-step
    vector cost is proportional to bt; ties go to fewer tracks)."""
    alens = sorted(alens, reverse=True)
    best_bt, best_cost = 8, None
    for bt in (8, 16, 32):
        cost = _lpt_serial(alens, bt) * bt
        if best_cost is None or cost < best_cost:
            best_bt, best_cost = bt, cost
    return best_bt


def padded_rows(L_real, W):
    """The tape length a launch whose longest track has L_real rows is
    padded to (_build_one's bucketing)."""
    if W > 512:
        return _bucket_geom(max(L_real, 512), 512, 256, ratio=1.5)
    return _bucket_geom(max(L_real, 512), 512, 256)


def row_moves_bytes(tracks, L_real, W):
    """Bytes of a launch's moves: one int32 word per 8 tape rows, region
    lane and track."""
    GWp = (W + SEG_ALIGN * MAX_SHIFT + 127) // 128 * 128
    return tracks * (padded_rows(L_real, W) // 8) * GWp * 4


def build_row_launches(tasks, W, build_corridor, budget=None
                       ) -> List[TapeLaunch]:
    """The card's layout: one task a track, tracks sorted by aligned row
    count (longest first), launches cut by `budget` bytes of moves
    (row_moves_bytes; by default wavetape.MOVES_BUDGET) with the tasks
    split evenly over them (wavetape.split_by_budget). Tasks with empty q
    or r must be filtered by the caller. Launches are TapeLaunch records
    like build_tapes', so the kernels, the walker and the decode take
    either layout; per-task outputs do not depend on the layout (every
    task starts on a group boundary with its carries reset, and the
    prolog's clamps bind only in pads)."""
    from .wavetape import MOVES_BUDGET, split_by_budget
    if budget is None:
        budget = MOVES_BUDGET
    order = sorted(range(len(tasks)), key=lambda i: -_aligned_len(tasks[i]))
    rows = [_aligned_len(tasks[i]) for i in order]
    parts = split_by_budget(
        rows, W, budget,
        launch_bytes=lambda tracks, longest: row_moves_bytes(tracks, longest,
                                                             W))
    return [_build_one(tasks, [[order[i]] for i in range(lo, hi)], rows[lo],
                       W, hi - lo, build_corridor) for lo, hi in parts]


def build_tapes(tasks, W, build_corridor, bt=None) -> List[TapeLaunch]:
    """Lay out `tasks` (ops.banded.BandedTask list) into tape launches as
    the JAX package does (several tasks a track, LPT). Tasks with empty q
    or r must be filtered by the caller. `bt` forces the track count (the
    default choose_bt picks it)."""
    order = sorted(range(len(tasks)), key=lambda i: -len(tasks[i].q))
    if bt is None:
        bt = choose_bt([_aligned_len(tasks[i]) for i in order])
    # the row cap bounds the moves intermediate (bt x L x GWp/2 bytes
    # in device memory) and the per-launch fetch
    l_cap = max(512, L_CAP * 256 * 8 // (W * bt) // 512 * 512)

    launches = []
    remaining = order
    while remaining:
        loads = [0] * bt
        assign: List[List[int]] = [[] for _ in range(bt)]
        overflow = []
        for ti in remaining:
            a = _aligned_len(tasks[ti])
            k = loads.index(min(loads))
            # a single over-cap task still gets a (solo) launch
            if loads[k] and loads[k] + a > l_cap:
                overflow.append(ti)
            else:
                assign[k].append(ti)
                loads[k] += a
        launches.append(_build_one(tasks, assign, max(loads), W, bt,
                                   build_corridor))
        remaining = overflow
    return launches


def _build_one(tasks, assign, L_real, W, bt, build_corridor) -> TapeLaunch:
    """Build one launch from `assign`: per-track lists of task indices.
    Every task start is SEG_ALIGN-aligned (its padded length is a
    multiple of SEG_ALIGN), so resets land on group boundaries."""
    # rows quantum 256; wide-band launches (W > 512) bucket coarsely, as
    # the JAX package does (its compiled-shape count), so both packages
    # lay out the same tapes.
    L = padded_rows(L_real, W)
    TT = _bucket_pow2(max(max(len(a) for a in assign), 8), 8)

    qf = np.full((bt, L), Q_PAD, np.uint8)
    per = {name: np.full((bt, TT), -1, np.int32)
           for name in ('cbase', 'c0m', 'c_n', 'm_t', 'n_t', 'r_base',
                        'seg_start', 'reset_slot', 'cap_slot', 'last_slot',
                        'task_ids')}
    n_tasks = np.zeros(bt, np.int32)

    # first pass: per-track reference sizes
    r_sizes = np.zeros(bt, np.int64)
    for tr in range(bt):
        for ti in assign[tr]:
            r_sizes[tr] += len(tasks[ti].r) + 2 * W
    GW = W + SEG_ALIGN * MAX_SHIFT
    M = _bucket_geom(int(r_sizes.max()) + GW + 1, 1024, 512)
    r_flat = np.full((bt, M), R_PAD, np.int8)

    for tr in range(bt):
        r_cursor = 0
        row = 0
        for ti in assign[tr]:
            t = tasks[ti]
            n_act, m_act = len(t.q), len(t.r)
            seg_len = -(-n_act // SEG_ALIGN) * SEG_ALIGN
            c = build_corridor(t.corridor_read, t.corridor_ref,
                               n_act, m_act, W)
            base = r_cursor
            r_flat[tr, base + W:base + W + m_act] = t.r
            r_cursor += m_act + 2 * W

            # si includes the reset row's c[1]-c[0] drift: the kernel
            # swaps in h0 (built at c[0] alignment) and THEN realigns by
            # si, matching the bucketed kernel's row-1 semantics.
            si = np.diff(c).astype(np.uint8)       # <= MAX_SHIFT by corridor
            f = (si << F_SI_SHIFT) | t.q.astype(np.uint8)
            f[0] |= F_RESET
            f[-1] |= F_CAPTURE
            qf[tr, row:row + n_act] = f
            # segment pad rows: si=0, q=Q_PAD (qf already Q_PAD)

            kk = n_tasks[tr]
            per['cbase'][tr, kk] = int(c[1])       # si-cumsum starts at 0
            per['c0m'][tr, kk] = int(c[0])
            per['c_n'][tr, kk] = int(c[n_act])
            per['m_t'][tr, kk] = m_act
            per['n_t'][tr, kk] = n_act
            per['r_base'][tr, kk] = base
            per['seg_start'][tr, kk] = row
            per['reset_slot'][tr, kk] = row // SEG_ALIGN
            per['cap_slot'][tr, kk] = (row + n_act - 1) // SEG_ALIGN
            per['last_slot'][tr, kk] = (row + seg_len - 1) // SEG_ALIGN
            per['task_ids'][tr, kk] = ti
            n_tasks[tr] += 1
            row += seg_len

    # The cumsum-of-si reconstruction on device is global per track; adjust
    # each task's base so c_rel = cumsum(si)[row] + cbase[task] lands on
    # the true c values despite earlier segments' drift accumulating.
    for tr in range(bt):
        s_cum = np.cumsum((qf[tr] >> F_SI_SHIFT) & 7)
        for kk in range(n_tasks[tr]):
            r0 = per['seg_start'][tr, kk]
            per['cbase'][tr, kk] -= int(s_cum[r0])

    return TapeLaunch(qf=qf, r_flat=r_flat,
                      n_tasks=n_tasks, L=L, L_real=L_real, TT=TT, **per)
