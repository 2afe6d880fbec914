"""The port's reference-shaped wrapper surface (align/compat.py) against
the JAX package's (unicycler_tpu/align/compat.py), on the CPU.

Each function runs on the same seeded pairs in both packages (the port
with device='cpu'); the result strings must be character-equal, the
'%.6f' scaled score included, and the numbers exactly equal (tolerance
0). The `banded` cases lower MAX_FULL_DP_CELLS in both packages so that
the pairs take the banded kernel's route instead of the full-matrix DP.
"""

import random

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread a test process)

from unicycler_tpu import settings as jsettings
from unicycler_tpu.align import compat as jcompat
from unicycler_tpu.align.scoring import AlignmentScoringScheme as JScheme

from unicycler_tpu_torch import settings as tsettings
from unicycler_tpu_torch.align import compat as tcompat
from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme

SCHEME = '3,-6,-5,-2'


def _seq(rng, n):
    return ''.join(rng.choice('ACGT') for _ in range(n))


def _mutate(rng, seq, rate=0.05):
    out = []
    for base in seq:
        r = rng.random()
        if r < rate / 3:
            continue                               # deletion
        if r < 2 * rate / 3:
            out.append(base + rng.choice('ACGT'))  # insertion
        elif r < rate:
            out.append(rng.choice([b for b in 'ACGT' if b != base]))
        else:
            out.append(base)
    return ''.join(out)


def pairs(seed):
    """(s1, s2) pairs for each kind of call, from one seed."""
    rng = random.Random(seed)
    s2 = _seq(rng, rng.randint(500, 800))
    glob = _mutate(rng, s2)
    head = _mutate(rng, s2[:rng.randint(150, 300)])
    tail = _mutate(rng, s2[-rng.randint(150, 300):])
    inner_at = rng.randint(50, 200)
    inner = _mutate(rng, s2[inner_at:inner_at + 250])
    left = _seq(rng, 300) + s2[:200]       # s1's end overlaps s2's start
    return {'global': (glob, s2), 'path': (head + _seq(rng, 40), s2),
            'inner': (inner, s2), 'start': (head, s2), 'end': (tail, s2),
            'overlap': (left, s2)}


CALLS = {
    'fully_global': lambda m, p, s: m.fully_global_alignment(
        *p['global'], s, band_size=100),
    'fully_global_unbanded': lambda m, p, s: m.fully_global_alignment(
        *p['global'], s, use_banding=False),
    'path': lambda m, p, s: m.path_alignment(*p['path'], s, band_size=120),
    'semi_global_exhaustive': lambda m, p, s:
        m.semi_global_alignment_exhaustive(*p['inner'], s),
    'overlap': lambda m, p, s: m.overlap_alignment(*p['overlap'], s, 200),
    'start': lambda m, p, s: m.start_alignment(*p['start'], s),
    'end': lambda m, p, s: m.end_alignment(*p['end'], s),
}


def _both(monkeypatch, call, seed, banded):
    if banded:
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, 'MAX_FULL_DP_CELLS', 1 << 16)
    p = pairs(seed)
    want = CALLS[call](jcompat, p, JScheme(SCHEME))
    got = CALLS[call](_OnCpu(), p, AlignmentScoringScheme(SCHEME))
    return want, got


class _OnCpu(object):
    """The port's compat module with device='cpu' on every call."""

    def __getattr__(self, name):
        fn = getattr(tcompat, name)
        return lambda *a, **k: fn(*a, device='cpu', **k)


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('call', sorted(CALLS))
def test_pairwise_calls_match_jax(monkeypatch, call, seed):
    want, got = _both(monkeypatch, call, seed, banded=False)
    assert got == want
    assert got not in ('', '-1,-1')


@pytest.mark.parametrize('call', ['fully_global', 'path', 'start', 'end'])
def test_banded_calls_match_jax(monkeypatch, call):
    want, got = _both(monkeypatch, call, 7, banded=True)
    assert got == want
    assert got != ''


@pytest.mark.parametrize('seed,n_seqs', [(3, 4), (4, 1), (5, 0)])
def test_consensus_alignment_matches_jax(seed, n_seqs):
    rng = random.Random(seed)
    truth = _seq(rng, 400)
    seqs = [_mutate(rng, truth, 0.04) for _ in range(n_seqs)]
    quals = ['I' * len(s) for s in seqs[:-1]]   # the last one gets none
    want = jcompat.consensus_alignment(seqs, quals, JScheme(SCHEME),
                                       bandwidth=200)
    got = tcompat.consensus_alignment(seqs, quals,
                                      AlignmentScoringScheme(SCHEME),
                                      bandwidth=200, device='cpu')
    assert got == want


def test_random_alignment_mean_and_std_dev_match_jax():
    want = jcompat.get_random_sequence_alignment_mean_and_std_dev(
        120, 12, JScheme(SCHEME))
    got = tcompat.get_random_sequence_alignment_mean_and_std_dev(
        120, 12, AlignmentScoringScheme(SCHEME), device='cpu')
    assert got == want


def test_simulate_depths_matches_jax():
    lengths = [500, 1200, 3000, 800, 2500] * 4
    want = jcompat.simulate_depths(lengths, 10000, 6)
    got = tcompat.simulate_depths(lengths, 10000, 6)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
