"""The banded traceback walk (the TPU's pallas_traceback kernel) and the
retry path that runs it, against the JAX package.

The plain version of the walk (what csrc/banded_walk.cu is held to on the
card) equals JAX traceback_device run in Pallas interpret mode on moves
from JAX banded_batch_device: records and final states, exactly. The
retry path with the walk (device_walk=True, the CUDA default, here on the
plain versions) equals the host-decode retry path in the five configs of
scripts/check_device_traceback.py, with some walks forced to end in a band
escape so that their tasks take the host traceback, and equals the JAX
package's retry path: scores, spans and CIGARs. Inside the wave route,
the tasks a group window finds no path in retry and are walked into
CIGARs.
"""

import functools

import numpy as np
import pytest
import torch

from torch_parity import (CONFIGS, SCORING_T, pa_key, retally, tasks_np,
                          zigzag_tasks)

from jax.experimental import pallas as pl

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops import pallas_traceback as jpt
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import traceback_kernels as ttk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring
from unicycler_tpu_torch.utils import trace


def _check_tasks(seed):
    """Tasks shaped like scripts/check_device_traceback.py's (mixed sizes,
    straight corridors with a random offset, and reads longer than their
    reference), shortened for the CPU."""
    rng = np.random.default_rng(seed)
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(seed, [40, 90, 400, 700, 600], drift=False)]
    for _ in range(2):
        ref = rng.integers(0, 4, 300).astype(np.int8)
        q = np.concatenate([ref, rng.integers(0, 4, 250)]).astype(np.int8)
        tasks.append(tb.BandedTask(q, ref, np.array([0, 300], np.int32),
                                   np.array([0, 300], np.int32)))
    return tasks


@pytest.mark.parametrize('W', [256, 512])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'overlap'])
def test_walk_plain_matches_pallas_interpret(cfg, W, monkeypatch):
    monkeypatch.setattr(jpt.pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(3, [60, 700, 300, 90, 5, 640], drift=True)]
    host = tb._pack_bucket(tasks, list(range(len(tasks))), 1024, 1024, W, 8)
    score, end_i, end_j, moves = jb.banded_batch_device(
        *host, scoring=JScoring(*SCORING_T), config=JConfig(*CONFIGS[cfg]),
        W=W, need_moves=True)
    crow = host[2][:, 1:]
    rec_w, fin_w = jpt.traceback_device(moves, crow, end_i, end_j, W)
    rec_g, fin_g = ttk.banded_traceback(
        *(torch.from_numpy(np.array(x))
          for x in (moves, crow, end_i, end_j)), W)
    np.testing.assert_array_equal(np.asarray(rec_w), rec_g.numpy())
    np.testing.assert_array_equal(np.asarray(fin_w), fin_g.numpy())
    # the walks cross the 512-row chunks of the TPU kernel's grid
    assert (rec_g.numpy()[:, 512:] != 0).sum() > 100


def _force_escapes(monkeypatch, every=3):
    """Make every `every`-th walk of a launch end in a band escape."""
    inner = ttk.banded_traceback

    def forced(moves, crow, end_i, end_j, W):
        records, final = inner(moves, crow, end_i, end_j, W)
        final = final.clone()
        final[::every, 2] = 2
        return records, final

    monkeypatch.setattr(ttk, 'banded_traceback', forced)


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_retry_device_walk_matches_host_decode(cfg, monkeypatch):
    tasks = _check_tasks(7)
    scoring, config = TScoring(*SCORING_T), TConfig(*CONFIGS[cfg])
    want = tb._align_banded_moves_path(tasks, scoring, config, 256, True,
                                       device='cpu', device_walk=False)
    trace.reset()
    trace.enable()
    try:
        got = tb._align_banded_moves_path(tasks, scoring, config, 256, True,
                                          device='cpu', device_walk=True)
        _force_escapes(monkeypatch)
        forced = tb._align_banded_moves_path(tasks, scoring, config, 256,
                                             True, device='cpu',
                                             device_walk=True)
    finally:
        trace.disable()
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    assert [pa_key(p) for p in forced] == [pa_key(p) for p in want]
    assert trace.as_dict()['counters']['retry.device_walk'] == 2 * len(tasks)
    assert sum(1 for p in want if p.cigar) >= len(tasks) - 1


@pytest.mark.parametrize('cfg', ['semi', 'global', 'end'])
def test_retry_device_walk_matches_jax(cfg):
    tasks = tasks_np(17, [90, 400, 230, 600], drift=True)
    want = jb._align_banded_moves_path(
        [jb.BandedTask(*t) for t in tasks], JScoring(*SCORING_T),
        JConfig(*CONFIGS[cfg]), 256, True)
    got = tb._align_banded_moves_path(
        [tb.BandedTask(*t) for t in tasks], TScoring(*SCORING_T),
        TConfig(*CONFIGS[cfg]), 256, True, device='cpu', device_walk=True)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]


def test_wave_route_retries_walk_into_cigars(monkeypatch):
    """FULLY_GLOBAL tasks with zigzag corridors: the wave route (the
    kernels' plain versions) retries the tasks it cannot align, and the
    retry path walks them; the results equal the host decode's. On the
    card's layout (one task a track) the retried tasks have no path in
    the per-row band either. On the JAX package's layout (several tasks a
    track) a NEG task's walk from its unreachable corner also overwrites
    a neighbouring task's records, so that neighbour retries too and is
    walked into a CIGAR that re-tallies; both layouts give the same
    results."""
    from unicycler_tpu_torch.ops import wavetape as tw
    tasks = [tb.BandedTask(*t) for t in zigzag_tasks(5)]
    args = (TScoring(*SCORING_T), TConfig(*CONFIGS['global']), 128, True)
    inner = tb._align_banded_moves_path
    retried = []

    def walked(task_list, *a, **kw):
        out = inner(task_list, *a, device_walk=True, **kw)
        retried.extend(out)
        return out

    want = tb.align_banded_tape(tasks, *args, device='cpu')
    monkeypatch.setattr(tb, '_align_banded_moves_path', walked)
    runs = {}
    for layout in ('task', 'jax'):
        if layout == 'jax':
            monkeypatch.setattr(tw, 'build_wave_launches',
                                lambda t, W, corridor, budget:
                                tw.build_wavetapes(t, W, corridor))
        del retried[:]
        trace.reset()
        trace.enable()
        try:
            got = tb.align_banded_tape(tasks, *args, device='cpu')
        finally:
            trace.disable()
        counters = trace.as_dict()['counters']
        assert counters['retry.device_walk'] == counters['tape.retry'] > 0
        assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
        runs[layout] = (counters['tape.retry'],
                        sum(1 for p in retried if p.cigar))
    assert runs['task'][1] == 0
    assert runs['jax'][1] > 0
    assert runs['jax'][0] == runs['task'][0] + runs['jax'][1]
    for t, pa in zip(tasks, want):
        if pa.cigar:
            assert retally(t.q, t.r, pa) == pa.score
