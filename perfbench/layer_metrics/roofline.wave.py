"""The wave kernels' share of their roofline: the least time the card
could take for the window's wave-route work (costs/banded.py, counted
from the tasks handed to ops/banded.align_banded and the alignments they
gave: real rows x W cells for the forward, path steps for the walk),
over the CUDA-event time of the window's wavetape_fwd and wavetape_walk
launches (ops/cuda_lib.TIMINGS)."""

from costs import banded

KERNELS = ('wavetape_fwd', 'wavetape_walk')


def read(run):
    rec = run.record
    if rec is None:
        return None
    busy = sum(b - a for name, a, b in rec.launches if name in KERNELS)
    work = rec.work.get('wave')
    if not busy or not work:
        return None
    return 100.0 * banded.work_bound_s(work) / busy
