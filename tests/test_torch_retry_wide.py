"""The band-escape retry path at the row route's width against the JAX
package.

(a) _align_banded_moves_path at W 4096, the band of long-read bridging's
row route, equals the JAX package's at W 4096, with the moves decoded on
the host and walked by the plain walker: scores, spans and CIGARs.
(b) A row-route align_banded_tape call at W 4096 in which the walks that
end on an odd row are taken as band escapes (their records_to_cigar
gives None) retries those tasks at W 4096, and equals the JAX package's
row-tape route (interpret-mode Pallas) forced the same way. Tolerance 0.
"""

import pytest

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops import pallas_traceback as jpt
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import tape_kernels as ttk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring
from unicycler_tpu_torch.utils import trace

W = 4096
BAND = 1500            # band_width(1500) == 4096


@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_retry_path_w4096_matches_jax(cfg):
    tasks = tasks_np(43, [90, 110, 100], drift=True)
    want = jb._align_banded_moves_path(
        [jb.BandedTask(*t) for t in tasks], JScoring(*SCORING_T),
        JConfig(*CONFIGS[cfg]), W, True)
    keys = [pa_key(p) for p in want]
    assert all(p.cigar for p in want)
    for walk in (False, True):
        got = tb._align_banded_moves_path(
            [tb.BandedTask(*t) for t in tasks], TScoring(*SCORING_T),
            TConfig(*CONFIGS[cfg]), W, True, device='cpu', device_walk=walk)
        assert [pa_key(p) for p in got] == keys


def _odd_end_escapes(records_to_cigar):
    """records_to_cigar taking every walk that ends on an odd row as a
    band escape (None: the caller retries the task)."""
    def forced(records, end_i, *a, **kw):
        if int(end_i) % 2:
            return None
        return records_to_cigar(records, end_i, *a, **kw)
    return forced


def test_row_route_forced_escapes_match_jax(monkeypatch):
    assert tb.band_width(BAND) == W
    tasks = tasks_np(47, [90, 110, 100, 120, 70], drift=True)
    args = (SCORING_T, CONFIGS['path'])
    monkeypatch.setattr(jpt, 'records_to_cigar',
                        _odd_end_escapes(jpt.records_to_cigar))
    monkeypatch.setattr(ttk, 'records_to_cigar',
                        _odd_end_escapes(ttk.records_to_cigar))
    want = jb.align_banded_tape([jb.BandedTask(*t) for t in tasks],
                                JScoring(*args[0]), JConfig(*args[1]), W,
                                True, interpret=True)
    trace.reset()
    trace.enable()
    try:
        got = tb.align_banded_tape([tb.BandedTask(*t) for t in tasks],
                                   TScoring(*args[0]), TConfig(*args[1]), W,
                                   True, device='cpu')
    finally:
        trace.disable()
    retried = trace.as_dict()['counters'].get('tape.retry', 0)
    assert 0 < retried < len(tasks)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    assert all(p.cigar for p in got)
