"""Work of the banded DP (ops/banded.align_banded): per task, its real
rows (query bases) times the band width W for the forward kernel, and
its alignment's steps for the walker. Constants as chip_smoke.py counts
them from the kernels' inner loops (loads and stores excluded)."""

import json
import os

OPS_PER_CELL = 45          # the forward's int32 operations a DP cell
OPS_PER_STEP_WALK = 30     # the walker's int32 operations a path step
BYTES_PER_STEP_WALK = 8    # the walker reads a moves word and an offset
WAVE_MAX_W = 2048          # the wave kernels take W up to this

_PEAKS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'peaks.json')


def peaks():
    with open(_PEAKS) as f:
        return json.load(f)


def band_width(band):
    """The lane width of a band radius, as ops/banded.band_width rounds
    it: a multiple of 128, and above 512 a power of two."""
    W = max(128, -(-(2 * band + 1) // 128) * 128)
    if W > 512:
        W = 1 << (W - 1).bit_length()
    return W


def forward(rows, ref_bases, W):
    """(ops, bytes) of a forward pass over tasks with `rows` query bases
    and `ref_bases` window bases in all: rows * W cells; the bases read
    once, 4 bits of moves written a cell, a score and two ends a task
    (counted by the caller through `tasks`)."""
    cells = rows * W
    return cells * OPS_PER_CELL, rows + ref_bases + cells // 2


def walk(steps):
    """(ops, bytes) of the walks over `steps` path steps in all."""
    return steps * OPS_PER_STEP_WALK, steps * BYTES_PER_STEP_WALK


def bound_s(ops, nbytes, peak=None):
    """The least time the card could take: operations at the int32 peak
    or bytes at the bandwidth, whichever is longer."""
    peak = peak or peaks()
    return max(ops / peak['int32_ops_per_s'], nbytes / peak['bytes_per_s'])


def work_bound_s(agg, peak=None):
    """The least time of one route's counted work (a Work.by_route entry):
    its forward passes plus its walks."""
    peak = peak or peaks()
    return bound_s(agg['fwd_ops'], agg['fwd_bytes'], peak) \
        + bound_s(agg['walk_ops'], agg['walk_bytes'], peak)


def cigar_steps(pa):
    """Path steps of one alignment (PairAlignment-like: a `cigar` of
    (count, op) pairs or of run arrays with `.counts`)."""
    cig = getattr(pa, 'cigar', None)
    if cig is None:
        return 0
    counts = getattr(cig, 'counts', None)
    if counts is not None:
        return int(sum(int(c) for c in counts))
    return int(sum(int(c) for c, _ in cig))


class Work(object):
    """Work handed to the banded entry, by route ('wave' for W <= 2048,
    'row' above): forward ops and bytes, walk ops and bytes, tasks."""

    def __init__(self):
        self.by_route = {}

    def add(self, tasks, band, results, need_cigar):
        W = band_width(band)
        route = 'wave' if W <= WAVE_MAX_W else 'row'
        agg = self.by_route.setdefault(route, dict(
            fwd_ops=0, fwd_bytes=0, walk_ops=0, walk_bytes=0, tasks=0,
            rows=0, steps=0))
        rows = sum(len(t.q) for t in tasks if len(t.q) and len(t.r))
        ref_bases = sum(len(t.r) for t in tasks if len(t.q) and len(t.r))
        ops, nbytes = forward(rows, ref_bases, W)
        agg['fwd_ops'] += ops
        agg['fwd_bytes'] += nbytes + 12 * len(tasks)
        agg['tasks'] += len(tasks)
        agg['rows'] += rows
        if need_cigar:
            steps = sum(cigar_steps(pa) for pa in results if pa is not None)
            ops, nbytes = walk(steps)
            agg['walk_ops'] += ops
            agg['walk_bytes'] += nbytes
            agg['steps'] += steps
