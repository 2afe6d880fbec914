"""The roofline's work is counted from the tasks handed to the banded
entry and the alignments they gave, so one task set counts the same
whether its launches are laid out on the wave route or on the row
route (and on the CPU's bucketed route)."""

import numpy as np
import torch

from costs import banded as costs


def _tasks(seed=3, n=6):
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(150, 400, n)]
    return [banded.BandedTask(*t) for t in synth.banded_tasks(rng, sizes)]


def test_work_is_the_same_on_the_wave_and_row_routes(monkeypatch):
    from unicycler_tpu_torch.ops import banded
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    tasks = _tasks()
    scoring = Scoring(3, -6, -5, -2)
    band = 60
    W = banded.band_width(band)
    assert W == costs.band_width(band) == 128
    cpu = torch.device('cpu')
    wave = banded.align_banded_tape(tasks, scoring, SEMI_GLOBAL, W, True,
                                    device=cpu)
    monkeypatch.setattr(banded, 'use_wavetape', lambda W: False)
    row = banded.align_banded_tape(tasks, scoring, SEMI_GLOBAL, W, True,
                                   device=cpu)
    bucket = banded.align_banded(tasks, scoring, SEMI_GLOBAL, band=band,
                                 need_cigar=True, device=cpu)
    counts = []
    for results in (wave, row, bucket):
        work = costs.Work()
        work.add(tasks, band, results, True)
        counts.append(work.by_route)
    assert counts[0] == counts[1] == counts[2]
    assert counts[0]['wave']['rows'] == sum(len(t.q) for t in tasks)
    assert counts[0]['wave']['steps'] > 0


def test_recorder_counts_each_call_once(monkeypatch):
    """The counting wrappers of a traced run count the CPU route's
    align_banded_async, which runs align_banded inside, once."""
    from harness.tracing import Recorder
    from unicycler_tpu_torch.ops import banded
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    tasks = _tasks(5, 4)
    scoring = Scoring(3, -6, -5, -2)
    rec = Recorder(torch.device('cpu'))
    rec.start()
    h = banded.align_banded_async(tasks, scoring, SEMI_GLOBAL, band=60,
                                  need_cigar=True, device='cpu')
    banded.collect_many([h])
    banded.align_banded(tasks, scoring, SEMI_GLOBAL, band=60,
                        need_cigar=False, device='cpu')
    got = rec.stop(rec._t0 + 1.0)
    assert got.work['wave']['tasks'] == 2 * len(tasks)
    assert got.work['wave']['rows'] == 2 * sum(len(t.q) for t in tasks)
    # the wrappers are taken out again
    assert banded.align_banded.__module__ == banded.__name__
