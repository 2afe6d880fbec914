"""Row-tape kernels of the port against the JAX package's Pallas kernels.

(a) The port's row-tape builder gives the JAX builder's arrays, and the
plain versions of the forward kernel and the walker (what the CUDA kernels
are held to on the card) equal the Pallas kernels run in interpret mode,
exactly (tolerance 0): scores, end cells, moves, the walker's sidecars,
records, and final states on the task slots that hold a task. W = 128
takes the Pallas kernel's unrolled body, W = 2176 its rolled body.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops import pallas_tape as jpt
from unicycler_tpu.ops import tape as jt
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import tape as tt
from unicycler_tpu_torch.ops import tape_kernels as tk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring


@pytest.mark.parametrize('W', [128, 2176])
@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_plain_tape_kernels_match_pallas_interpret(cfg, W):
    config = CONFIGS[cfg]
    # nine tasks: every one of the 8 tracks holds at least one, so the
    # moves of every track are defined in both packages
    tasks = tasks_np(23, [180, 333, 90, 140, 200, 75, 260, 120, 99],
                     drift=True)
    lj = jt.build_tapes([jb.BandedTask(*t) for t in tasks], W,
                        jb.build_corridor)
    lt = tt.build_tapes([tb.BandedTask(*t) for t in tasks], W,
                        tb.build_corridor)
    assert len(lj) == len(lt) == 1
    for a, b in zip(lj, lt):
        for field in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          np.asarray(getattr(b, field)),
                                          err_msg=field)
    tp = lt[0]
    assert (tp.n_tasks > 0).all()
    args = tt.forward_inputs(tp)
    want = jpt.tape_forward(*args, scoring=JScoring(*SCORING_T),
                            config=JConfig(*config), W=W, need_moves=True,
                            interpret=True)
    got = tk.tape_forward(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in args),
        scoring=TScoring(*SCORING_T), config=TConfig(*config), W=W,
        need_moves=True)
    valid = tp.n_t > 0
    for name, w, g in zip(('score', 'end_i', 'end_j'), want, got):
        np.testing.assert_array_equal(np.asarray(w)[valid], g.numpy()[valid],
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy(),
                                  err_msg='moves')
    for name, w, g in zip(('c_rel', 'jr_rows'), want[4], got[4]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)

    end_abs = np.where(valid, tp.seg_start + np.asarray(want[1]), 0)
    ej = np.where(valid, np.asarray(want[2]), 0)
    ss = np.where(valid, tp.seg_start, 0)
    rec_w, fin_w = jpt.tape_traceback(want[3], want[4][0], want[4][1],
                                      tp.n_tasks, end_abs, ej, ss, W,
                                      interpret=True)
    rec_g, fin_g = tk.tape_traceback(
        got[3], got[4][0], got[4][1], torch.from_numpy(tp.n_tasks),
        torch.from_numpy(end_abs), torch.from_numpy(ej),
        torch.from_numpy(ss), W)
    np.testing.assert_array_equal(np.asarray(rec_w), rec_g.numpy())
    # fin of task slots that hold no task is never written by either walker
    np.testing.assert_array_equal(np.asarray(fin_w)[valid],
                                  fin_g.numpy()[valid])
    assert (rec_g.numpy() != 0).sum() > 500
