"""The port's k-mer-spectrum read corrector (unicycler_tpu_torch.asm.correct)
against the JAX package's, exactly: packed k-mers, the spectrum, the
solidity threshold and the corrected reads with their stats.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_debruijn import rand_genome

from unicycler_tpu.asm import correct as jc
from unicycler_tpu.io.fastx import encode_sequence
from unicycler_tpu.pipeline.fake_reads import make_fake_short_reads

from unicycler_tpu_torch.asm import correct as tc


@pytest.fixture(scope='module')
def noisy_reads():
    """Pairs over a 4 kbp circular genome at 1% error, as code arrays, with
    a few N bases (code 4) planted."""
    genome = rand_genome(4000, 303)
    p1, p2 = make_fake_short_reads(genome, error_rate=0.01, seed=9)
    reads = [encode_sequence(seq) for _, seq, _ in p1 + p2]
    rng = np.random.default_rng(3)
    for i in rng.integers(0, len(reads), 40):
        reads[i] = reads[i].copy()
        reads[i][rng.integers(0, len(reads[i]))] = 4
    return reads


@pytest.mark.parametrize('k', [5, 21, 31])
def test_pack_and_canonical_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 500).astype(np.int8)
    codes[[7, 100, 401]] = 4
    km, valid = tc.pack_kmers(codes, k)
    want_km, want_valid = jc.pack_kmers(codes, k)
    assert np.array_equal(km, want_km) and np.array_equal(valid, want_valid)
    assert not valid.all() and valid.any()
    assert np.array_equal(tc.revcomp_packed(km, k), jc.revcomp_packed(km, k))
    assert np.array_equal(tc.canonical_packed(km, k),
                          jc.canonical_packed(km, k))
    # k = 31 with a leading T: keys with the top bits of 62 set
    top = np.full(40, 3, np.int8)
    assert np.array_equal(tc.canonical_packed(tc.pack_kmers(top, k)[0], k),
                          jc.canonical_packed(jc.pack_kmers(top, k)[0], k))
    assert len(tc.pack_kmers(codes[:k - 1], k)[0]) == 0


@pytest.mark.parametrize('k', [15, 21])
def test_spectrum_and_threshold_match_jax(noisy_reads, k):
    kmers, counts = tc.count_spectrum(noisy_reads, k)
    want_k, want_c = jc.count_spectrum(noisy_reads, k)
    assert np.array_equal(kmers, want_k) and np.array_equal(counts, want_c)
    assert tc.solid_threshold(counts) == jc.solid_threshold(want_c)
    for t in (None, 3):
        got = tc.KmerSpectrum(noisy_reads, k, t)
        want = jc.KmerSpectrum(noisy_reads, k, t)
        assert got.threshold == want.threshold
        assert np.array_equal(got.solid, want.solid)
        assert np.array_equal(got.counts, want.counts)
    assert tc.solid_threshold(np.zeros(0, np.int64)) == 2


def test_correct_reads_matches_jax(noisy_reads):
    got, got_stats = tc.correct_reads(noisy_reads)
    want, want_stats = jc.correct_reads(noisy_reads)
    assert got_stats == want_stats
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got_stats['reads_corrected'] > 100
    assert got_stats['substitutions'] >= got_stats['reads_corrected']


def test_correct_read_matches_jax(noisy_reads):
    spectrum_t = tc.KmerSpectrum(noisy_reads)
    spectrum_j = jc.KmerSpectrum(noisy_reads)
    for codes in noisy_reads[:300]:
        got, n = tc.correct_read(codes, spectrum_t)
        want, m = jc.correct_read(codes, spectrum_j)
        assert n == m and np.array_equal(got, want)
