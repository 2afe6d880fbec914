"""(b) The port's row-tape route at W = 4096 against the JAX package.

align_banded_tape(device='cpu') runs the row tapes on the kernels' plain
versions; it equals the JAX package's row-tape route with interpret-mode
Pallas kernels and the JAX package's CPU route (the bucketed XLA DP), on
short drifting tasks, exactly (tolerance 0: scores, ends, CIGARs).
"""

import pytest

from torch_parity import CONFIGS, SCORING_T, pa_key, tasks_np

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring

W = 4096
BAND = 1500            # band_width(1500) == 4096


@pytest.mark.parametrize('cfg', ['path', 'global'])
def test_row_route_matches_jax_at_w4096(cfg):
    tasks = tasks_np(41, [150, 400, 260, 90, 330], drift=True)
    assert tb.band_width(BAND) == W
    jt = [jb.BandedTask(*t) for t in tasks]
    jtape = jb.align_banded_tape(jt, JScoring(*SCORING_T),
                                 JConfig(*CONFIGS[cfg]), W, True,
                                 interpret=True)
    jcpu = jb.align_banded(jt, JScoring(*SCORING_T), JConfig(*CONFIGS[cfg]),
                           band=BAND)
    got = tb.align_banded_tape([tb.BandedTask(*t) for t in tasks],
                               TScoring(*SCORING_T), TConfig(*CONFIGS[cfg]),
                               W, True, device='cpu')
    keys = [pa_key(p) for p in got]
    assert keys == [pa_key(p) for p in jtape]
    assert keys == [pa_key(p) for p in jcpu]
    assert all(p.cigar for p in got)
