"""The card's row layout (ops/tape.build_row_launches: one task a track,
tracks sorted longest first, launches cut by a moves budget), which
ops/banded takes on every device for bands W > 2048, held on the CPU:

(a) the port's row route on that layout, with the kernels' plain
    versions, equals the JAX package's interpret-mode row route per task,
    exactly, for all five AlignConfigs at W = 4096, with tracks of
    different lengths in one launch (W = 8192 in
    test_torch_row_layout_w8192.py);
(b) a moves budget small enough to split a call into >= 3 launches gives
    the one-launch results;
(c) the layout's invariants: one task a track, tracks sorted by row
    count, every launch within the budget, the tasks split evenly; and
    the forward kernel's cluster size rule;
(d) the per-track stop (the forward kernel stops at each track's last
    real group) gives the full tape's best and hatn at each task's last
    and capture slots, in both layouts.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import tape as tt
from unicycler_tpu_torch.ops import tape_kernels as tk
from unicycler_tpu_torch.ops import wavetape as tw
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring
from unicycler_tpu_torch.utils import trace

SIZES = [150, 400, 260, 90, 330]


def _route(tasks, cfg, W):
    trace.reset()
    trace.enable()
    try:
        got = tb.align_banded_tape([tb.BandedTask(*t) for t in tasks],
                                   TScoring(*SCORING_T),
                                   TConfig(*CONFIGS[cfg]), W, True,
                                   device='cpu')
    finally:
        trace.disable()
    return [pa_key(p) for p in got], trace.as_dict()['counters']


def check_route_matches_jax(cfg, W):
    """(a) at one (config, W); the W = 8192 cases are in
    test_torch_row_layout_w8192.py."""
    tasks = tasks_np(41, SIZES, drift=True)
    launches = tt.build_row_launches([tb.BandedTask(*t) for t in tasks], W,
                                     tb.build_corridor)
    assert len(launches) == 1
    tp = launches[0]
    assert tp.qf.shape[0] == len(tasks)
    assert len(set((tp.last_slot.max(1) + 1).tolist())) > 1
    want = jb.align_banded_tape([jb.BandedTask(*t) for t in tasks],
                                JScoring(*SCORING_T), JConfig(*CONFIGS[cfg]),
                                W, True, interpret=True)
    got, counters = _route(tasks, cfg, W)
    assert counters['tape.tracks'] == len(tasks)
    assert counters['tape.launches'] == 1
    assert got == [pa_key(p) for p in want]
    assert all(k[5] for k in got)


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_row_layout_route_matches_jax(cfg):
    check_route_matches_jax(cfg, 4096)


@pytest.mark.parametrize('cfg', ['semi', 'global', 'path'])
def test_budget_split_matches_one_launch(cfg, monkeypatch):
    W = 4096
    tasks = tasks_np(43, [300, 80, 150, 410, 60, 220, 120], drift=True)
    one, ctr1 = _route(tasks, cfg, W)
    assert ctr1['tape.launches'] == 1
    total = tt.row_moves_bytes(len(tasks), 416, W)
    monkeypatch.setattr(tw, 'MOVES_BUDGET', total // 4)
    split, ctr = _route(tasks, cfg, W)
    assert ctr['tape.launches'] >= 3
    assert ctr['tape.tracks'] == len(tasks)
    assert split == one


@pytest.mark.parametrize('split', [False, True], ids=['one', 'budget'])
@pytest.mark.parametrize('W', [4096, 8192])
def test_row_layout_invariants(W, split):
    sizes = [int(x) for x in
             np.random.default_rng(W).integers(40, 900, 40)]
    tasks = [tb.BandedTask(*t) for t in tasks_np(53, sizes, drift=True)]
    own = {ti: -(-len(t.q) // 32) * 32 for ti, t in enumerate(tasks)}
    budget = tw.MOVES_BUDGET
    if split:
        budget = sum(tt.row_moves_bytes(1, n, W) for n in own.values()) // 5
    launches = tt.build_row_launches(tasks, W, tb.build_corridor, budget)
    assert (len(launches) == 1) != split
    seen, rows = [], []
    for tp in launches:
        B = tp.qf.shape[0]
        assert (tp.n_tasks == 1).all()
        assert (tp.task_ids[:, 1:] == -1).all()
        assert (tp.seg_start[:, 0] == 0).all()
        lens = [own[t] for t in tp.task_ids[:, 0]]
        assert tp.L_real == lens[0]
        assert tp.L == tt.padded_rows(lens[0], W) >= max(lens)
        ngt = tk.track_groups(torch.from_numpy(tp.last_slot)).numpy()
        assert np.array_equal(ngt * 32, lens)
        assert B == 1 or tt.row_moves_bytes(B, tp.L_real, W) <= budget
        seen += tp.task_ids[:, 0].tolist()
        rows += lens
    assert sorted(seen) == list(range(len(tasks)))
    assert rows == sorted(rows, reverse=True)
    if split:
        # the tasks split evenly: a launch the budget does not fill holds
        # its share, and the last launch is no small remainder
        assert len(launches) >= 3
        counts = [tp.qf.shape[0] for tp in launches]
        assert counts[-1] >= len(tasks) // len(launches)
        assert all(b >= a - 1 for a, b in zip(counts, counts[1:]))


@pytest.mark.parametrize('W', [4096, 8192])
def test_cluster_size_rule(W):
    """Eight blocks a track while tracks x 8 fit the card's SMs and every
    cluster is resident at once, then fewer; never under 128 lanes a
    block."""
    GWp = tk.region_width(W)
    resident = {8: 16, 4: 32, 2: 66, 1: 132}.get
    for tracks, want in ((1, 8), (8, 8), (16, 8), (17, 4), (32, 4),
                         (33, 2), (66, 2), (67, 1), (500, 1)):
        C = tk.cluster_size(tracks, W, 132, resident)
        assert C == want, (tracks, C)
        assert GWp // C >= tk.MIN_BLOCK_LANES
    # a card that holds fewer clusters of 8 takes 4 blocks a track
    assert tk.cluster_size(16, W, 132, {8: 14, 4: 32}.get) == 4
    # a band too wide for one block takes a cluster whatever the tracks
    assert tk.cluster_size(500, 16384, 132, resident) == 2


def _forward(tp, cfg, W, stop):
    up = [torch.from_numpy(np.ascontiguousarray(x))
          for x in tt.forward_inputs(tp)]
    rowinfo, gplane, _, _ = tk.tape_prolog(up[0], up[1], up[2], up[3],
                                           up[5], up[7], up[8], W)
    ngt = tk.track_groups(up[11])
    out = tk.tape_forward_plain(rowinfo, gplane, up[1], TScoring(*SCORING_T),
                                TConfig(*CONFIGS[cfg]), W, True,
                                ngt=ngt if stop else None)
    return out, ngt


@pytest.mark.parametrize('layout', ['jax', 'card'])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'overlap'])
def test_track_stop_keeps_task_outputs(cfg, layout):
    W = 4096
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(47, [180, 333, 90, 140, 260, 75, 410], drift=True)]
    if layout == 'jax':
        tp = tt.build_tapes(tasks, W, tb.build_corridor, bt=4)[0]
        assert int(tp.n_tasks.max()) > 1
    else:
        tp = tt.build_row_launches(tasks, W, tb.build_corridor)[0]
    (mv_s, hatn_s, best_s), ngt = _forward(tp, cfg, W, True)
    (mv_f, hatn_f, best_f), _ = _forward(tp, cfg, W, False)
    assert int(ngt.max()) < tp.L // 32
    # the stop computes the real groups exactly and zeroes the rest
    for s, f in zip((mv_s, hatn_s, best_s),
                    tk.real_rows(mv_f, hatn_f, best_f, ngt)):
        assert torch.equal(s, f)
    for tr in range(tp.qf.shape[0]):
        for kk in range(int(tp.n_tasks[tr])):
            last, cap = int(tp.last_slot[tr, kk]), int(tp.cap_slot[tr, kk])
            assert torch.equal(best_s[last, tr], best_f[last, tr])
            assert torch.equal(hatn_s[cap, tr], hatn_f[cap, tr])
            assert int(hatn_s[cap, tr].abs().sum()) > 0
