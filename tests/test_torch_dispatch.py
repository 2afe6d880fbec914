"""(d) The port's dispatch and consensus against the JAX package.

batch_align equals the JAX version across both of its branches (the
full-matrix DP for small pairs, the banded DP along the diagonal for
large ones; MAX_FULL_DP_CELLS is lowered in both packages so that both
branches run on small inputs), and consensus_align equals the JAX
version. Exact (tolerance 0: alignments, consensus strings).
"""

import numpy as np
import pytest

from torch_parity import CONFIGS, SCORING_T, pa_key

from unicycler_tpu import settings as jset
from unicycler_tpu.ops import dispatch as jd
from unicycler_tpu.ops import msa as jm
from unicycler_tpu.ops import pairwise as jp

from unicycler_tpu_torch import settings as tset
from unicycler_tpu_torch import synth
from unicycler_tpu_torch.io.fastx import decode_sequence
from unicycler_tpu_torch.ops import dispatch as td
from unicycler_tpu_torch.ops import msa as tm
from unicycler_tpu_torch.ops import pairwise as tp


@pytest.fixture
def small_full_dp(monkeypatch):
    # 512 x 512 bucketed cells and below take the full-matrix DP
    for s in (jset, tset):
        monkeypatch.setattr(s, 'MAX_FULL_DP_CELLS', 1 << 18)


def _pairs(seed, sizes):
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for n in sizes:
        r = rng.integers(0, 4, n).astype(np.int8)
        qs.append(synth._mutate(rng, r, 0.05, 0.03, 0.03).astype(np.int8))
        rs.append(r)
    return qs, rs


@pytest.mark.parametrize('cfg', ['global', 'path', 'semi'])
def test_batch_align_matches_jax_on_both_branches(cfg, small_full_dp):
    qs, rs = _pairs(9, [300, 450, 700, 150, 900])
    want = jd.batch_align(qs, rs, jp.Scoring(*SCORING_T),
                          jp.AlignConfig(*CONFIGS[cfg]), band=60)
    got = td.batch_align(qs, rs, tp.Scoring(*SCORING_T),
                         tp.AlignConfig(*CONFIGS[cfg]), band=60,
                         device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    assert jd.scaled_score(want[2], jp.Scoring(*SCORING_T)) == \
        td.scaled_score(got[2], tp.Scoring(*SCORING_T))


@pytest.mark.parametrize('branch', ['full', 'banded'])
def test_consensus_align_matches_jax(branch, monkeypatch):
    if branch == 'banded':
        for s in (jset, tset):
            monkeypatch.setattr(s, 'MAX_FULL_DP_CELLS', 1 << 18)
    rng = np.random.default_rng(4)
    truth = rng.integers(0, 4, 620).astype(np.int8)
    seqs = [decode_sequence(synth._mutate(rng, truth, 0.04, 0.02, 0.02))
            for _ in range(7)]
    quals = [''.join(chr(33 + int(q)) for q in rng.integers(5, 40, len(s)))
             for s in seqs]
    want = jm.consensus_align(seqs, quals, jp.Scoring(*SCORING_T))
    got = tm.consensus_align(seqs, quals, tp.Scoring(*SCORING_T),
                             device='cpu')
    assert got == want
    assert abs(len(got) - len(truth)) < 30
