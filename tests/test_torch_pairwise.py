"""(c) The port's full-matrix DP against the JAX package.

align_pairs equals the JAX version for all five AlignConfigs, with and
without a diagonal band, with and without CIGARs, exactly (tolerance 0:
scores, ends, starts, CIGARs). get_auto_score_threshold for a scheme
outside the precomputed table measures the random-alignment distribution
with that DP and equals the JAX package's numbers.
"""

import numpy as np
import pytest

from torch_parity import CONFIGS, SCORING_T, pa_key

from unicycler_tpu.align import scoring as jsc
from unicycler_tpu.align import semi_global as jsg
from unicycler_tpu.ops import pairwise as jp

from unicycler_tpu_torch import synth
from unicycler_tpu_torch.align import scoring as tsc
from unicycler_tpu_torch.align import semi_global as tsg
from unicycler_tpu_torch.ops import pairwise as tp


def _pairs(seed):
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for n in (40, 90, 150, 7, 120, 200):
        r = rng.integers(0, 4, n + int(rng.integers(-10, 30))).astype(np.int8)
        qs.append(synth._mutate(rng, r, 0.06, 0.03, 0.03).astype(np.int8))
        rs.append(r)
    return qs, rs


@pytest.mark.parametrize('need_cigar', [True, False])
@pytest.mark.parametrize('band', [None, 20])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_align_pairs_matches_jax(cfg, band, need_cigar):
    qs, rs = _pairs(5)
    want = jp.align_pairs(qs, rs, jp.Scoring(*SCORING_T),
                          jp.AlignConfig(*CONFIGS[cfg]),
                          need_cigar=need_cigar, band=band)
    got = tp.align_pairs(qs, rs, tp.Scoring(*SCORING_T),
                         tp.AlignConfig(*CONFIGS[cfg]),
                         need_cigar=need_cigar, band=band, device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    if need_cigar:
        assert all(p.cigar for p in got if p.s1_len > 10)


def test_auto_score_threshold_outside_the_table_matches_jax():
    scheme = '2,-4,-4,-2'
    assert scheme not in tsg._RANDOM_SCORE_TABLE
    want = jsg.get_auto_score_threshold(jsc.AlignmentScoringScheme(scheme))
    got = tsg.get_auto_score_threshold(tsc.AlignmentScoringScheme(scheme),
                                       device='cpu')
    assert got == want
