"""Wavefront kernels of the port against the JAX package's Pallas kernels.

(b) The port's tape builder gives the JAX builder's arrays, and the plain
versions of the forward kernel and the walker (what the CUDA kernels are
held to on the card) equal the Pallas kernels run in interpret mode:
scores, ends, moves, window bases, records and final states, exactly.
(c, W = 512) The port's wave route on the CPU equals the JAX package's
interpret-mode wave route for two AlignConfigs; test_torch_wave_route_w512.py
has the other three, and test_torch_wave_route.py and
test_torch_wave_route_noend.py cover W = 128.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops import pallas_wavetape as jpw
from unicycler_tpu.ops import wavetape as jw
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import wavetape as tw
from unicycler_tpu_torch.ops import wavetape_kernels as twk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring


def jax_wave_route(tasks, config, W, need_cigar=True):
    """The JAX package's wave route on the CPU (interpret-mode kernels)."""
    return jb.align_banded_tape(
        [jb.BandedTask(*t) for t in tasks], JScoring(*SCORING_T),
        JConfig(*config), W, need_cigar, interpret=True)


def port_wave_route(tasks, config, W, need_cigar=True):
    return tb.align_banded_tape(
        [tb.BandedTask(*t) for t in tasks], TScoring(*SCORING_T),
        TConfig(*config), W, need_cigar, device='cpu')


@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_plain_kernels_match_pallas_interpret(cfg):
    config = CONFIGS[cfg]
    W = 128
    tasks = tasks_np(23, [180, 333, 90, 140], drift=True)
    lj = jw.build_wavetapes([jb.BandedTask(*t) for t in tasks], W,
                            jb.build_corridor)
    lt = tw.build_wavetapes([tb.BandedTask(*t) for t in tasks], W,
                            tb.build_corridor)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        for field in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)),
                                          err_msg=field)
    tp = lj[0]
    args = tw.forward_inputs(tp)
    want = jpw.wavetape_forward(*args, scoring=JScoring(*SCORING_T),
                                config=JConfig(*config), W=W,
                                need_moves=True, interpret=True)
    got = twk.wavetape_forward(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in args),
        scoring=TScoring(*SCORING_T), config=TConfig(*config), W=W,
        need_moves=True)
    for name, w, g in zip(('score', 'end_i', 'end_j', 'moves', 'db_rows'),
                          want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)

    valid = tp.n_t > 0
    ei = np.where(valid, np.asarray(want[1]), 0)
    ej = np.where(valid, np.asarray(want[2]), 0)
    ab = np.where(valid, tp.abase, 0)
    rec_w, fin_w = jpw.wavetape_traceback(want[3], want[4], tp.n_tasks, ei,
                                          ej, ab, W, interpret=True)
    rec_g, fin_g = twk.wavetape_traceback(
        got[3], got[4], torch.from_numpy(tp.n_tasks), torch.from_numpy(ei),
        torch.from_numpy(ej), torch.from_numpy(ab), W)
    np.testing.assert_array_equal(np.asarray(rec_w), rec_g.numpy())
    # fin of task slots that hold no task is never written by either walker
    np.testing.assert_array_equal(np.asarray(fin_w)[valid],
                                  fin_g.numpy()[valid])
    assert (rec_g.numpy() != 0).sum() > 100


@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_wave_route_matches_jax_w512(cfg, drift, monkeypatch):
    monkeypatch.setenv('UNICYCLER_TPU_WAVETAPE', '1')
    tasks = tasks_np(31, [150, 400, 700, 260], drift=drift)
    want = jax_wave_route(tasks, CONFIGS[cfg], 512)
    got = port_wave_route(tasks, CONFIGS[cfg], 512)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
