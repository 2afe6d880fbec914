"""Launch-geometry helpers shared by the tape builders (a subset of
unicycler_tpu/ops/tape.py: the size buckets and the per-launch track
count; the row-tape builder itself is not ported yet)."""

MAX_SHIFT = 4    # max per-row band drift (corridors are smoothed to this)
L_CAP = 131072        # max tape rows per launch (cellinfo HBM budget ~1 GB)


def _bucket_pow2(n, minimum):
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_geom(n, minimum, quantum, ratio=1.125):
    """Geometric size buckets (ratio 1.125, rounded up to `quantum`):
    power-of-two buckets waste up to 50% of the tape in pad rows that
    the kernel EXECUTES and the host UPLOADS (measured 45% on the bench
    fixtures); 1.125x steps cap the waste at ~11% for more compiled
    shapes, which the persistent compile cache absorbs."""
    b = float(minimum)
    while b < n:
        b *= ratio
    return -(-int(b) // quantum) * quantum


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
