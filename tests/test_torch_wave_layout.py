"""The card's wave layout (ops/wavetape.build_wave_launches: one task a
track, tracks sorted longest first, launches cut by a moves budget),
which ops/banded takes on every device, held on the CPU:

(a) the port's wave route on that layout, with the kernels' plain
    versions, equals the JAX package's interpret-mode wave route per task,
    exactly, for all five AlignConfigs at W = 128 and 512 on straight and
    drifting corridors, with tracks of different group counts in one
    launch (W = 512 in test_torch_wave_layout_w512.py);
(b) a moves budget small enough to split a call into >= 3 launches gives
    the one-launch results;
(c) each track's own capture gate gives the same best as the TPU
    kernel's gate (the OR over all tracks) over every real group of a
    JAX-layout launch, so at each task's lastg;
(d) the layout's invariants: one task a track, tracks sorted by group
    count, every launch within the budget, the tasks split evenly over
    the launches, per-track group counts equal to lastg + 1.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np
from test_torch_wavetape import jax_wave_route, port_wave_route

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import wavetape as tw
from unicycler_tpu_torch.ops import wavetape_kernels as twk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring
from unicycler_tpu_torch.utils import trace

SIZES = {128: [60, 120, 200, 330, 90, 170], 512: [150, 400, 700, 260]}


def _launches(tasks, W, budget=tw.MOVES_BUDGET):
    return tw.build_wave_launches([tb.BandedTask(*t) for t in tasks], W,
                                  tb.build_corridor, budget)


def _route_counters(tasks, cfg, W):
    trace.reset()
    trace.enable()
    try:
        got = port_wave_route(tasks, CONFIGS[cfg], W)
    finally:
        trace.disable()
    return [pa_key(p) for p in got], trace.as_dict()['counters']


def check_route_matches_jax(cfg, drift, W, monkeypatch):
    """(a) at one (config, corridor, W); the W = 512 cases are in
    test_torch_wave_layout_w512.py."""
    monkeypatch.setenv('UNICYCLER_TPU_WAVETAPE', '1')
    tasks = tasks_np(41, SIZES[W], drift=drift)
    launches = _launches(tasks, W)
    assert len(launches) == 1
    tp = launches[0]
    assert tp.q_tape.shape[0] == len(tasks)
    assert len(set((tp.lastg.max(1) + 1).tolist())) > 1
    want = [pa_key(p) for p in jax_wave_route(tasks, CONFIGS[cfg], W)]
    got, counters = _route_counters(tasks, cfg, W)
    assert counters['wave.tracks'] >= len(tasks)
    assert got == want


@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_task_layout_route_matches_jax(cfg, drift, monkeypatch):
    check_route_matches_jax(cfg, drift, 128, monkeypatch)


@pytest.mark.parametrize('cfg', ['semi', 'global', 'overlap'])
def test_budget_split_matches_one_launch(cfg, monkeypatch):
    W = 128
    tasks = tasks_np(43, [300, 80, 150, 410, 60, 220, 120, 350, 90],
                     drift=True)
    one, ctr1 = _route_counters(tasks, cfg, W)
    assert ctr1['wave.launches'] == 1
    NG = tw.padded_groups(_launches(tasks, W)[0].NG_real)
    total = tw.moves_bytes(len(tasks), NG, W)
    monkeypatch.setattr(tw, 'MOVES_BUDGET', total // 4)
    split, ctr = _route_counters(tasks, cfg, W)
    assert ctr['wave.launches'] >= 3
    assert ctr['wave.tracks'] == len(tasks)
    assert split == one


@pytest.mark.parametrize('W', [128, 512])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'path', 'overlap', 'end'])
def test_track_capture_gate_matches_any_track_gate(cfg, W):
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(47, [180, 333, 90, 140, 260, 75, 410], drift=True)]
    tp = tw.build_wavetapes(tasks, W, tb.build_corridor, bt=4)[0]
    assert int(tp.n_tasks.max()) > 1
    up = [torch.from_numpy(np.ascontiguousarray(x))
          for x in tw.forward_inputs(tp)]
    plane, _ = twk.group_plane(*up[2:11], tp.LR, tp.r_flat.shape[1], W)
    plane_any = plane.clone()
    plane_any[..., twk.P_HIT] = plane[..., twk.P_HIT].amax(0, keepdim=True)
    assert not torch.equal(plane, plane_any)
    args = (TScoring(*SCORING_T), TConfig(*CONFIGS[cfg]), W, False)
    _, best = twk.wavetape_forward_plain(up[0], up[1], plane, *args)
    _, best_any = twk.wavetape_forward_plain(up[0], up[1], plane_any, *args)
    ngt = twk.track_groups(up[11])
    assert torch.equal(twk.real_groups(None, best, ngt)[1],
                       twk.real_groups(None, best_any, ngt)[1])
    for tr in range(tp.lastg.shape[0]):
        for kk in range(int(tp.n_tasks[tr])):
            g = int(tp.lastg[tr, kk])
            assert torch.equal(best[tr, g], best_any[tr, g])


@pytest.mark.parametrize('split', [False, True], ids=['one', 'budget'])
@pytest.mark.parametrize('W', [128, 512, 2048])
def test_layout_invariants(W, split):
    sizes = [int(x) for x in
             np.random.default_rng(W).integers(40, 900, 40)]
    tasks = [tb.BandedTask(*t) for t in tasks_np(53, sizes, drift=True)]
    metas = tw._stage_tasks(tasks, W, tb.build_corridor)
    own = {ti: ng for ti, _, _, _, ng, _ in metas}
    budget = tw.MOVES_BUDGET
    if split:
        budget = sum(tw.moves_bytes(1, ng, W) for ng in own.values()) // 5
    launches = tw.build_wave_launches(tasks, W, tb.build_corridor, budget)
    assert (len(launches) == 1) != split
    seen, ngts = [], []
    for tp in launches:
        B = tp.q_tape.shape[0]
        assert (tp.n_tasks == 1).all()
        assert (tp.task_ids[:, 1:] == -1).all()
        ngt = tp.lastg[:, 0] + 1
        assert np.array_equal(ngt, [own[t] for t in tp.task_ids[:, 0]])
        assert np.array_equal(twk.track_groups(torch.from_numpy(
            tp.lastg)).numpy(), ngt)
        assert tp.NG == tw.padded_groups(int(ngt[0])) >= ngt.max()
        assert B == 1 or tw.moves_bytes(B, tp.NG, W) <= budget
        seen += tp.task_ids[:, 0].tolist()
        ngts += ngt.tolist()
    assert sorted(seen) == list(range(len(tasks)))
    assert ngts == sorted(ngts, reverse=True)
    if split:
        # the tasks split evenly: a launch the budget does not fill holds
        # its share, and the last launch is no small remainder
        assert len(launches) >= 3
        counts = [tp.q_tape.shape[0] for tp in launches]
        assert counts[-1] >= len(tasks) // len(launches)
        assert all(b >= a - 1 for a, b in zip(counts, counts[1:]))


def test_oversize_task_gets_a_launch_of_its_own():
    W = 128
    ngs = [400, 60, 50, 40, 30]
    budget = tw.moves_bytes(3, tw.padded_groups(60), W)
    parts = tw.split_by_budget(ngs, W, budget)
    assert parts[0] == (0, 1)
    assert parts[-1][1] == len(ngs)
    for lo, hi in parts[1:]:
        assert tw.moves_bytes(hi - lo, tw.padded_groups(ngs[lo]),
                              W) <= budget
