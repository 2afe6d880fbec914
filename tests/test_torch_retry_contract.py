"""Contracts of the retry kernels and the row forward's launch plan.

(c) csrc/banded.cu stops each task after its row n_act, so moves rows at
and past n_act are unspecified. The walk and the host decode never read
them: with those rows filled with random words, the plain walker gives
the same records and finals, and both retry routes (device walk and host
decode) the same PairAlignments, exactly.
(d) tape_kernels.cluster_size plans every band: at W 131,072 and 262,144,
too wide for every cluster size, it returns one block a track, the plan
csrc/tape_fwd.cu runs as its tiled kernel (block_plan mirrors the
kernel's own rule), and every narrower band keeps a cluster template.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import banded_kernel as bk
from unicycler_tpu_torch.ops import tape_kernels as tk
from unicycler_tpu_torch.ops import traceback_kernels as tbk
from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring


def _fill_past_n_act(moves, n_acts, rng):
    """moves with every row at or past its task's n_act replaced by
    random int32 words."""
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, moves.shape,
                                          dtype=np.int64).astype(np.int32))
    rows = torch.arange(moves.shape[1])[None, :]
    past = rows >= n_acts.to(torch.int64)[:, None]
    return torch.where(past[:, :, None], words, moves)


@pytest.mark.parametrize('cfg', ['semi', 'global', 'end'])
def test_moves_past_n_act_change_nothing(cfg, monkeypatch):
    W = 256
    scoring, config = Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg])
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(53, [60, 300, 140, 90], drift=True)]
    rng = np.random.default_rng(5)
    want = [[pa_key(p) for p in tb._align_banded_moves_path(
        tasks, scoring, config, W, True, device='cpu', device_walk=walk)]
        for walk in (False, True)]
    assert want[0] == want[1]

    host = tb._pack_bucket(tasks, list(range(len(tasks))), 512, 512, W,
                           bk.BT)
    args = [torch.from_numpy(x) for x in host]
    _, ei, ej, moves = bk.banded_batch(*args, scoring, config, W, True)
    crow = args[2][:, 1:].contiguous()
    clean = tbk.banded_traceback(moves, crow, ei, ej, W)
    filled = tbk.banded_traceback(_fill_past_n_act(moves, args[3], rng),
                                  crow, ei, ej, W)
    assert int((clean[0] != 0).sum()) > 300
    for a, b in zip(clean, filled):
        assert torch.equal(a, b)

    inner = bk.banded_batch

    def garbage(q, r_ext, c, n_acts, m_acts, *a, **kw):
        out = inner(q, r_ext, c, n_acts, m_acts, *a, **kw)
        if out[3] is None:
            return out
        return out[:3] + (_fill_past_n_act(out[3], n_acts, rng),)

    monkeypatch.setattr(bk, 'banded_batch', garbage)
    for walk, keys in zip((False, True), want):
        got = tb._align_banded_moves_path(tasks, scoring, config, W, True,
                                          device='cpu', device_walk=walk)
        assert [pa_key(p) for p in got] == keys


@pytest.mark.parametrize('W', [131072, 262144])
def test_cluster_size_plans_any_width(W):
    resident = {8: 15, 4: 32, 2: 66, 1: 132}.get
    assert tk.tiled(W)
    for tracks in (1, 2, 16, 132, 300):
        C = tk.cluster_size(tracks, W, 132, resident)
        assert C == 1
        assert tk.block_plan(W, C) == ('tiled', 0)
    for Wn in (4096, 8192, 16384, 32768, 65536):
        assert not tk.tiled(Wn)
        for tracks in (1, 2, 16, 132, 300):
            plan = tk.block_plan(Wn, tk.cluster_size(tracks, Wn, 132,
                                                     resident))
            assert plan is not None and plan[0] == 'cluster'
