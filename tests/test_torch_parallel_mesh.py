"""The port's mesh layer (parallel/mesh.py) and multi-device alignment
route (ops/banded.align_banded_multi, the mesh branches of align_banded
and align_banded_async) against the JAX package's, on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices (tests/conftest.py),
its multi-device route with interpret=True as its own tests run it; the
port's mesh is ['cpu'] * 8 (a mesh may name one device more than once).
Every comparison is exact (tolerance 0: scores, ends, CIGARs, moves,
statistics).
"""

import numpy as np
import pytest
import torch

from torch_parity import CONFIGS, SCORING_T, pa_key

import jax

from unicycler_tpu.ops import banded as jb
from unicycler_tpu.ops.pairwise import AlignConfig as JConfig
from unicycler_tpu.ops.pairwise import Scoring as JScoring
from unicycler_tpu.parallel import mesh as jmesh

from unicycler_tpu_torch.ops import banded as tb
from unicycler_tpu_torch.ops.banded_kernel import banded_batch_plain
from unicycler_tpu_torch.ops.encode import R_PAD
from unicycler_tpu_torch.ops.pairwise import AlignConfig as TConfig
from unicycler_tpu_torch.ops.pairwise import Scoring as TScoring
from unicycler_tpu_torch.parallel import mesh as tmesh

CPU8 = ['cpu'] * 8
# the task lengths of the JAX package's own multi-device test
MULTI_SIZES = [60, 90, 120, 150, 180, 210, 240, 270, 300, 110, 130, 170,
               190, 230, 250, 80, 70, 100]


def _mutate(codes, rng, sub=0.06, ind=0.04):
    out = []
    i = 0
    while i < len(codes):
        r = rng.random()
        if r < ind / 2:
            out.append(rng.integers(0, 4))
            continue
        if r < ind:
            i += 1
            continue
        if r < ind + sub:
            out.append((codes[i] + rng.integers(1, 4)) % 4)
        else:
            out.append(codes[i])
        i += 1
    return np.array(out, np.int8)


def multi_tasks(seed=3, sizes=MULTI_SIZES):
    """(q, r, corridor_read, corridor_ref) numpy tuples: mutated slices of
    random references on straight corridors, as the JAX package's
    multi-device test makes them; one empty query is appended so the
    degenerate-task filter is exercised too."""
    rng = np.random.default_rng(seed)
    tasks = []
    for n in sizes:
        ref = rng.integers(0, 4, n + 120).astype(np.int8)
        off = int(rng.integers(0, 80))
        q = _mutate(ref[off:off + n], rng)
        tasks.append((q, ref, np.array([0, len(q)], np.int32),
                      np.array([off, off + n], np.int32)))
    tasks.append((np.zeros(0, np.int8), tasks[0][1], np.zeros(0, np.int32),
                  np.zeros(0, np.int32)))
    return tasks


def _both(tasks):
    return ([jb.BandedTask(*t) for t in tasks],
            [tb.BandedTask(*t) for t in tasks])


@pytest.mark.parametrize('cfg,need_cigar', [('semi', True), ('global', True),
                                            ('path', True), ('semi', False)])
def test_align_banded_multi_matches_jax(cfg, need_cigar):
    jt, tt = _both(multi_tasks())
    want = jb.align_banded_multi(jt, JScoring(*SCORING_T),
                                 JConfig(*CONFIGS[cfg]), 128, need_cigar,
                                 jax.devices()[:8], interpret=True)
    got = tb.align_banded_multi(tt, TScoring(*SCORING_T),
                                TConfig(*CONFIGS[cfg]), 128, need_cigar,
                                CPU8)
    single = tb.align_banded(tt, TScoring(*SCORING_T), TConfig(*CONFIGS[cfg]),
                             band=40, need_cigar=need_cigar, device='cpu')
    keys = [pa_key(p) for p in got]
    assert keys == [pa_key(p) for p in want]
    # the degenerate task aside, the single-device route gives the same
    assert keys[:-1] == [pa_key(p) for p in single[:-1]]
    assert keys[-1] == pa_key(want[-1]) and keys[-1][0] == 0
    if need_cigar:
        # (a global task whose corner lies outside its band scores 0)
        assert any(p.cigar for p in got)


def test_align_banded_multi_uneven_mesh():
    """Three entries (more partitions than a power of two, ties in the
    greedy balance) against the JAX package's three devices."""
    jt, tt = _both(multi_tasks(seed=8, sizes=[100] * 5 + [150, 150, 60]))
    want = jb.align_banded_multi(jt, JScoring(*SCORING_T),
                                 JConfig(*CONFIGS['semi']), 128, True,
                                 jax.devices()[:3], interpret=True)
    got = tb.align_banded_multi(tt, TScoring(*SCORING_T),
                                TConfig(*CONFIGS['semi']), 128, True,
                                ['cpu'] * 3)
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]


@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_align_banded_with_mesh_matches_jax(monkeypatch, cfg):
    """align_banded and align_banded_async with an 8-entry mesh installed
    take align_banded_multi. The JAX package sends a CPU mesh there only
    under UNICYCLER_TPU_FORCE_MESH=1 and otherwise splits each bucket over
    the mesh; the port's result equals both of its routes."""
    jt, tt = _both(multi_tasks(seed=5)[:-1])
    js, ts = JScoring(*SCORING_T), TScoring(*SCORING_T)
    jc, tc = JConfig(*CONFIGS[cfg]), TConfig(*CONFIGS[cfg])
    jmesh.set_default_mesh(jmesh.get_mesh(jax.devices()[:8]))
    tmesh.set_default_mesh(tmesh.get_mesh(CPU8))
    try:
        monkeypatch.delenv('UNICYCLER_TPU_FORCE_MESH', raising=False)
        want_split = jb.align_banded(jt, js, config=jc, band=40)
        monkeypatch.setenv('UNICYCLER_TPU_FORCE_MESH', '1')
        want_multi = jb.align_banded(jt, js, config=jc, band=40)
        got = tb.align_banded(tt, ts, config=tc, band=40, device='cpu')
        got_async = tb.align_banded_async(tt, ts, config=tc, band=40,
                                          device='cpu').collect()
    finally:
        jmesh.set_default_mesh(None)
        tmesh.set_default_mesh(None)
    plain = tb.align_banded(tt, ts, config=tc, band=40, device='cpu')
    keys = [pa_key(p) for p in got]
    assert keys == [pa_key(p) for p in want_split]
    assert keys == [pa_key(p) for p in want_multi]
    assert keys == [pa_key(p) for p in got_async]
    assert keys == [pa_key(p) for p in plain]


def test_mesh_of_another_device_type_raises():
    tmesh.set_default_mesh([torch.device('cuda', 0)] * 2)
    try:
        with pytest.raises(ValueError):
            tb.align_banded([tb.BandedTask(*multi_tasks()[0])],
                            TScoring(*SCORING_T), device='cpu')
    finally:
        tmesh.set_default_mesh(None)


def test_get_mesh():
    assert tmesh.get_mesh(CPU8) == [torch.device('cpu')] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.get_mesh()
    with pytest.raises(ValueError):
        tmesh.get_mesh([])


def _banded_batch(batch, n_pad, m_pad, W, seed, planted):
    """A padded banded batch on straight-diagonal corridors; planted: q
    is a verbatim slice of r, so every semi-global score is match * n."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 4, (batch, n_pad)).astype(np.int8)
    r_ext = np.full((batch, m_pad + 2 * W), R_PAD, np.int8)
    r_ext[:, W:W + m_pad] = rng.randint(0, 4, (batch, m_pad)).astype(np.int8)
    c = np.tile(np.arange(n_pad + 1, dtype=np.int32) - W // 2, (batch, 1))
    n_acts = np.full(batch, n_pad, np.int32)
    m_acts = np.full(batch, m_pad, np.int32)
    if planted:
        q[:] = r_ext[:, W:W + n_pad]
    else:
        n_acts[:] = rng.randint(n_pad // 2, n_pad + 1, batch)
        m_acts[:] = rng.randint(m_pad // 2, m_pad + 1, batch)
    return q, r_ext, c, n_acts, m_acts


@pytest.mark.parametrize('planted', [True, False], ids=['planted', 'random'])
@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_sharded_banded_align_and_stats_match_jax(planted, cfg):
    W, n_pad, m_pad, batch = 128, 128, 256, 16
    batch_np = _banded_batch(batch, n_pad, m_pad, W, 4, planted)
    js, ts = JScoring(*SCORING_T), TScoring(*SCORING_T)
    jc, tc = JConfig(*CONFIGS[cfg]), TConfig(*CONFIGS[cfg])
    want = jmesh.sharded_banded_align(jmesh.get_mesh(jax.devices()[:8]),
                                      *batch_np, scoring=js, config=jc, W=W,
                                      need_moves=True)
    got = tmesh.sharded_banded_align(tmesh.get_mesh(CPU8), *batch_np,
                                     scoring=ts, config=tc, W=W,
                                     need_moves=True)
    plain = banded_batch_plain(*(torch.from_numpy(x) for x in batch_np), ts,
                               tc, W, True)
    for g, w, p in zip(got, want, plain):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, p)
    scores = got[0].numpy()
    if planted and cfg == 'semi':
        assert (scores == SCORING_T[0] * n_pad).all()
    jstats = jmesh.sharded_align_stats(jmesh.get_mesh(jax.devices()[:8]),
                                       scores)
    tstats = tmesh.sharded_align_stats(tmesh.get_mesh(CPU8), scores)
    assert tstats == {'aligned': int((scores > 0).sum()),
                      'score_sum': int(scores.astype(np.int64).sum()),
                      'score_max': int(scores.max())}
    # the JAX package sums in int32, which wraps on global tasks whose
    # corner lies outside the band (NEG scores); the port sums in int64
    if abs(int(scores.astype(np.int64).sum())) < 2 ** 31:
        assert tstats == jstats
    else:
        assert cfg == 'global'
        assert {k: tstats[k] for k in ('aligned', 'score_max')} == \
            {k: jstats[k] for k in ('aligned', 'score_max')}


def test_shard_batched_call_needs_an_even_split():
    fn = tmesh.shard_batched_call(lambda x: (x + 1, None), CPU8[:3])
    out, none = fn(np.arange(6))
    assert none is None and out.tolist() == list(range(1, 7))
    with pytest.raises(ValueError):
        fn(np.arange(7))
