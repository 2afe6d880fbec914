"""(d) The banded kernel's plain version and the CPU route against JAX.

The torch twin of the XLA _banded_single (the plain version that the CUDA
banded kernel is held to on the card) equals JAX's banded_batch_device
on the same padded batch: scores, ends and nibble-plane moves, exactly.
The port's align_banded(device='cpu') and band-escape retry path
(_align_banded_moves_path) equal the JAX package's on the CPU: scores,
spans and CIGARs.
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops import banded_kernel as tk
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring


@pytest.mark.parametrize('W', [128, 256])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_banded_twin_matches_xla(cfg, W):
    tasks = [tb.BandedTask(*t) for t in
             tasks_np(7, [60, 150, 300, 90, 5], drift=True)]
    host = tb._pack_bucket(tasks, list(range(len(tasks))), 512, 512, W, 8)
    want = jb.banded_batch_device(*host, scoring=JScoring(*SCORING_T),
                                  config=JConfig(*CONFIGS[cfg]), W=W,
                                  need_moves=True)
    got = tk.banded_batch(*(torch.from_numpy(x) for x in host),
                          TScoring(*SCORING_T), TConfig(*CONFIGS[cfg]), W,
                          True)
    for name, w, g in zip(('score', 'end_i', 'end_j', 'moves'), want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)


@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_align_banded_cpu_route_matches_jax(cfg, drift):
    tasks = tasks_np(13, [60, 150, 300, 90, 450], drift=drift)
    for need_cigar in (True, False):
        want = jb.align_banded([jb.BandedTask(*t) for t in tasks],
                               JScoring(*SCORING_T),
                               config=JConfig(*CONFIGS[cfg]), band=40,
                               need_cigar=need_cigar)
        got = tb.align_banded([tb.BandedTask(*t) for t in tasks],
                              TScoring(*SCORING_T),
                              config=TConfig(*CONFIGS[cfg]), band=40,
                              need_cigar=need_cigar, device='cpu')
        assert [pa_key(p) for p in got] == [pa_key(p) for p in want]


@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_retry_path_matches_jax(cfg):
    tasks = tasks_np(17, [90, 400, 230], drift=True)
    want = jb._align_banded_moves_path(
        [jb.BandedTask(*t) for t in tasks], JScoring(*SCORING_T),
        JConfig(*CONFIGS[cfg]), 256, True)
    got = tb._align_banded_moves_path(
        [tb.BandedTask(*t) for t in tasks], TScoring(*SCORING_T),
        TConfig(*CONFIGS[cfg]), 256, True, device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
