"""The full-matrix DP's kernel module (ops/pairwise.py, csrc/pairwise.cu).

(c) align_batch_device on CPU tensors (the plain version) against the JAX
package's align_batch_device on the same raw arrays, for every AlignConfig,
with and without a diagonal band and moves, on one batch of mixed lengths
with lopsided pairs (7 x 600 and 600 x 7) and pairs of length 0 on either
side: scores and end cells equal, and the moves equal on each pair's real
region [0, n_act) x [0, m_act] (tolerance 0). The JAX side pads to length
buckets, the port to the longest pair, so only that region is shared.
The kernel's contract leaves moves rows at and past n_act and columns past
m_act unspecified: the host decode never reads them (random bytes there
give the same CIGARs). The CUDA wrapper's binding is held to the kernel's
C prototype (every pointer and the stream a c_void_p, so ctypes does not
cut them to 32 bits), and a CPU tensor takes the plain version and
launches nothing.
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T

from unicycler_tpu.ops import encode as je
from unicycler_tpu.ops import pairwise as jp

from unicycler_tpu_torch import synth
from unicycler_tpu_torch.ops import cuda_lib
from unicycler_tpu_torch.ops import pairwise as tp
from unicycler_tpu_torch.ops.encode import pack_pairs

# (len q, len r): mixed lengths, the lopsided pairs and empty sides
SIZES = [(40, 52), (7, 600), (600, 7), (0, 30), (25, 0), (150, 121),
         (300, 280), (93, 100), (0, 0)]


def _pairs(seed, sizes=SIZES):
    return synth.sized_pairs(np.random.default_rng(seed), sizes)


def _diags(q_lens, r_lens, band):
    if band is None:
        return None, None
    diffs = r_lens.astype(np.int64) - q_lens.astype(np.int64)
    return ((-band - np.maximum(0, diffs)).astype(np.int32),
            (band + np.maximum(0, -diffs)).astype(np.int32))


def _port(qs, rs, cfg, band, need_moves):
    host = pack_pairs(qs, rs, max(max(len(q) for q in qs), 1),
                      max(max(len(r) for r in rs), 1))
    lower, upper = _diags(host[1], host[3], band)
    t = lambda x: None if x is None else torch.from_numpy(x)
    out = tp.align_batch_device(*(t(x) for x in host),
                                tp.Scoring(*SCORING_T),
                                tp.AlignConfig(*CONFIGS[cfg]), need_moves,
                                t(lower), t(upper))
    return host, out


@pytest.mark.parametrize('need_moves', [True, False])
@pytest.mark.parametrize('band', [None, 20])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_align_batch_device_matches_jax(cfg, band, need_moves):
    qs, rs = _pairs(3)
    jhost = je.pack_pairs(qs, rs)
    lower, upper = _diags(jhost[1], jhost[3], band)
    want = jp.align_batch_device(*jhost, jp.Scoring(*SCORING_T),
                                 jp.AlignConfig(*CONFIGS[cfg]), need_moves,
                                 lower, upper)
    host, got = _port(qs, rs, cfg, band, need_moves)
    assert got[0].dtype == got[1].dtype == got[2].dtype == torch.int32
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if not need_moves:
        assert got[3] is None
        return
    moves, jmoves = got[3].numpy(), np.asarray(want[3])
    assert moves.dtype == np.uint8
    assert moves.shape == (len(qs), host[0].shape[1], host[2].shape[1] + 1)
    for b, (q, r) in enumerate(zip(qs, rs)):
        n, m = len(q), len(r)
        assert np.array_equal(moves[b, :n, :m + 1], jmoves[b, :n, :m + 1])


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_moves_outside_the_real_region_are_never_read(cfg):
    """The kernel writes moves rows < n_act and columns <= m_act only:
    random bytes everywhere else decode to the same CIGARs and starts."""
    qs, rs = _pairs(9)
    _, (score, end_i, end_j, moves) = _port(qs, rs, cfg, None, True)
    rng = np.random.default_rng(4)
    moves = moves.numpy()
    noisy = rng.integers(0, 256, moves.shape).astype(np.uint8)
    config = tp.AlignConfig(*CONFIGS[cfg])
    for b, (q, r) in enumerate(zip(qs, rs)):
        n, m = len(q), len(r)
        noisy[b, :n, :m + 1] = moves[b, :n, :m + 1]
        want = tp.decode_traceback(moves[b], end_i[b], end_j[b], config)
        got = tp.decode_traceback(noisy[b], end_i[b], end_j[b], config)
        assert [tuple(x) for x in got[0]] == [tuple(x) for x in want[0]]
        assert got[1:] == want[1:]


def test_cpu_tensors_take_the_plain_version_and_other_devices_raise():
    qs, rs = _pairs(5, SIZES[:3])
    before = cuda_lib.LAUNCHES['pairwise']
    host, got = _port(qs, rs, 'semi', None, True)
    assert cuda_lib.LAUNCHES['pairwise'] == before
    want = tp.align_batch_plain(*(torch.from_numpy(x) for x in host),
                                tp.Scoring(*SCORING_T), tp.SEMI_GLOBAL, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    meta = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                        device='meta') for x in host]
    with pytest.raises(ValueError, match='unsupported device'):
        tp.align_batch_device(*meta, tp.Scoring(*SCORING_T), tp.SEMI_GLOBAL,
                              True)


def _prototype(name):
    """Parameter declarations of the extern "C" function `name` in the
    kernel sources."""
    for src in cuda_lib.SOURCES:
        with open(os.path.join(cuda_lib.CSRC_DIR, src)) as f:
            text = f.read()
        found = re.search(r'extern "C" int %s\(([^)]*)\)' % name, text)
        if found:
            return [p.strip() for p in found.group(1).split(',')]
    raise AssertionError('%s not found in %s' % (name, cuda_lib.SOURCES))


def test_pairwise_kernel_is_built_and_bound_by_pointer():
    assert 'pairwise.cu' in cuda_lib.SOURCES
    assert os.path.isfile(os.path.join(cuda_lib.CSRC_DIR, 'pairwise.cu'))
    assert 'pairwise' in cuda_lib.LAUNCHES
    params = _prototype('pairwise_launch')
    argtypes = cuda_lib._SIGNATURES['pairwise_launch']
    assert len(params) == len(argtypes) == 23
    for decl, argtype in zip(params, argtypes):
        if '*' in decl:
            assert argtype is ctypes.c_void_p, decl
        else:
            assert argtype is ctypes.c_int and decl.startswith('int '), decl


def test_shared_memory_limit_mirrors_the_kernel():
    with open(os.path.join(cuda_lib.CSRC_DIR, 'pairwise.cu')) as f:
        found = re.search(r'constexpr int SMEM_COLS = (\d+);', f.read())
    assert int(found.group(1)) == tp.SMEM_COLS
    # H and F (8 bytes a column) fit the H100's 232,448 bytes a block
    # beside the kernel's static shared memory
    assert 8 * tp.SMEM_COLS + 1024 <= 232448



def test_cuda_wrapper_refuses_cpu_tensors():
    """align_batch_cuda never passes host pointers to the kernel."""
    qs, rs = _pairs(5, SIZES[:2])
    host = pack_pairs(qs, rs)
    with pytest.raises(ValueError, match='CUDA'):
        tp.align_batch_cuda(*(torch.from_numpy(x) for x in host),
                            tp.Scoring(*SCORING_T), tp.SEMI_GLOBAL, True)
