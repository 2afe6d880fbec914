"""The port's k-mer counter (unicycler_tpu_torch.ops.kmer_count; torch.sort
and unique_consecutive) against the JAX package's count_canonical_device
(on the CPU) and against np.unique, exactly.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_debruijn import rand_genome

from unicycler_tpu.asm import correct as jc
from unicycler_tpu.io.fastx import encode_sequence
from unicycler_tpu.ops import kmer_count as jkc
from unicycler_tpu.pipeline.fake_reads import make_fake_short_reads

from unicycler_tpu_torch.ops import kmer_count as tkc


@pytest.fixture(scope='module')
def reads():
    genome = rand_genome(5000, 404)
    p1, p2 = make_fake_short_reads(genome, error_rate=0.01, seed=2)
    out = [encode_sequence(seq) for _, seq, _ in p1 + p2]
    out[3] = out[3].copy()
    out[3][10] = 4
    return out + [np.zeros(0, np.int8), np.full(12, 3, np.int8)]


@pytest.mark.parametrize('k', [11, 21, 31])
def test_count_spectrum_matches_jax_and_np_unique(reads, k):
    got_k, got_c = tkc.count_spectrum(reads, k, device='cpu')
    want_k, want_c = jkc.count_spectrum(reads, k)
    assert got_k.dtype == np.uint64 and got_c.dtype == np.int64
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
    host_k, host_c = jc.count_spectrum(reads, k)
    assert np.array_equal(got_k, host_k) and np.array_equal(got_c, host_c)
    assert got_c.sum() > 100000


def test_top_bit_keys_sort_unsigned():
    """Keys at the top of the 62-bit range of k = 31 (a leading T), at the
    top of the 64-bit range (k = 32) and at 0 sort as np.unique does."""
    rng = np.random.default_rng(7)
    keys = np.concatenate([
        rng.integers(0, 1 << 62, 5000, dtype=np.uint64),
        (np.uint64(3) << np.uint64(60)) | rng.integers(0, 1 << 60, 3000,
                                                       dtype=np.uint64),
        np.full(17, (1 << 62) - 1, np.uint64),
        np.full(5, (1 << 64) - 1, np.uint64),
        (np.uint64(1) << np.uint64(63)) + rng.integers(0, 50, 400,
                                                       dtype=np.uint64),
        np.zeros(9, np.uint64)])
    chunks = [keys[:4000], keys[4000:]]
    got_k, got_c = tkc.count_canonical_device(chunks, 31, device='cpu')
    want_k, want_c = np.unique(keys, return_counts=True)
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
    low = [c[c < (np.uint64(1) << np.uint64(62))] for c in chunks]
    jk, jcnt = jkc.count_canonical_device(low, 31)
    gk, gcnt = tkc.count_canonical_device(low, 31, device='cpu')
    assert np.array_equal(gk, jk) and np.array_equal(gcnt, jcnt)


def test_empty_and_device_contract(monkeypatch):
    k, c = tkc.count_canonical_device([], 21, device='cpu')
    assert k.dtype == np.uint64 and len(k) == 0 and len(c) == 0
    k, c = tkc.count_spectrum([np.zeros(5, np.int8)], 21, device='cpu')
    assert len(k) == 0 and len(c) == 0
    monkeypatch.setenv('UNICYCLER_TPU_DEVICE_KMERS', '1')
    assert tkc.device_counting_enabled() == torch.cuda.is_available()
    monkeypatch.setenv('UNICYCLER_TPU_DEVICE_KMERS', '0')
    assert not tkc.device_counting_enabled()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tkc.count_canonical_device([np.arange(5, dtype=np.uint64)], 21)
