"""Canonical k-mer counting on the card (sort / run-length reduce; the
counterpart of unicycler_tpu/ops/kmer_count.py).

Pack 2-bit k-mers on the host (asm/correct.pack_kmers), sort the keys on
the device and count equal runs:

    pack (host, vectorised)  ->  torch.sort  ->  unique_consecutive

The JAX package sorts two uint32 words with lax.sort (jax defaults to
32-bit integers). torch sorts one int64 key: each uint64 key has its top
bit flipped, which maps the unsigned order onto the signed one, so every
k <= 32 sorts in np.unique's order. Results equal
np.unique(keys, return_counts=True) exactly.

As in the JAX package, the pipeline counts on the host
(asm/debruijn.count_kmers, asm/correct.count_spectrum); this module is
the opt-in device path, enabled for callers by
UNICYCLER_TPU_DEVICE_KMERS=1 on a CUDA device.
"""

import os

import numpy as np
import torch

from ..asm.correct import _joined, canonical_packed, pack_kmers
from ..device import resolve_device

_SIGN = np.uint64(1 << 63)


def device_counting_enabled():
    return os.environ.get('UNICYCLER_TPU_DEVICE_KMERS') == '1' \
        and torch.cuda.is_available()


def count_canonical_device(kmer_chunks, k, device=None):
    """(unique sorted canonical k-mers uint64, counts int64) with the sort
    and the run count on `device` (None = CUDA). kmer_chunks: list of
    uint64 arrays of canonical k-mers (host)."""
    device = resolve_device(device)
    if not kmer_chunks:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    allk = np.concatenate(kmer_chunks).astype(np.uint64, copy=False)
    keys = torch.from_numpy((allk ^ _SIGN).view(np.int64)).to(device)
    keys, _ = torch.sort(keys)
    uniq, counts = torch.unique_consecutive(keys, return_counts=True)
    uniq = uniq.cpu().numpy().view(np.uint64) ^ _SIGN
    return uniq, counts.cpu().numpy().astype(np.int64)


def count_spectrum(read_code_arrays, k, device=None):
    """asm.correct.count_spectrum with the sort on `device` (None = CUDA):
    the reads packed in joined chunks (the same k-mer multiset as one
    pack a read, since a window across a separator is invalid)."""
    chunks = []
    for joined, _ in _joined(read_code_arrays):
        km, valid = pack_kmers(joined, k)
        if len(km):
            chunks.append(canonical_packed(km[valid], k))
    return count_canonical_device(chunks, k, device=device)
