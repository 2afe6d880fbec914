"""The per-task anti-diagonal wavefront forward (the TPU's pallas_wavefront
kernel) against the JAX package.

The plain version (what csrc/wavefront_fwd.cu is held to on the card)
equals the Pallas kernel run in interpret mode on the same staged inputs:
hatn, lcv and lci, exactly. wavefront_batch and wavefront_batch_corridor
with device='cpu' equal the JAX package's interpret-mode entries on the
straight and drifting corridors of tests/test_wavefront.py, for
SEMI_GLOBAL and FULLY_GLOBAL, and on short tasks at W 2560 and 4096; the
drift precondition raises in both. wavefront_forward_pairs (the card
kernel's algorithm: real-parity lanes only, segments with halos, the
per-task stop) equals wavefront_forward_plain in all six configs.
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_wavefront import W, _drifty_tasks, _random_tasks

from unicycler_tpu.ops import pallas_wavefront as jwf
from unicycler_tpu.ops import pairwise as jpw

from unicycler_tpu_torch.ops import pairwise as tpw
from unicycler_tpu_torch.ops import wavefront as twf

CONFIGS = {'semi': 'SEMI_GLOBAL', 'global': 'FULLY_GLOBAL'}
SCORING = (3, -6, -5, -2)


def _both(cfg):
    return ((jpw.Scoring(*SCORING), getattr(jpw, CONFIGS[cfg])),
            (tpw.Scoring(*SCORING), getattr(tpw, CONFIGS[cfg])))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_forward_plain_matches_pallas_interpret(cfg):
    (js, jc), (ts, tc) = _both(cfg)
    q, r, c_rows, n_acts, m_acts = _drifty_tasks(np.random.RandomState(23),
                                                 4, 120, 300, W)
    staged = jwf._prepare(q, r, c_rows, n_acts, m_acts, W)
    for a, b in zip(staged, twf._prepare(q, r, c_rows, n_acts, m_acts, W)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    par, db, zq, zr, a_lo, n_groups, Wcap, GWp, _ = staged
    assert int(np.abs(db[:, :, 1]).max()) > 0      # the windows drift
    want = jwf._wavefront_call(par, db, zq, zr, B=4, W=W, Wcap=Wcap,
                               GWp=GWp, n_groups=n_groups, a_lo=a_lo,
                               scoring=js, config=jc, interpret=True)
    got = twf.wavefront_forward(
        *(torch.from_numpy(x) for x in (par, db, zq, zr)), W=W, Wcap=Wcap,
        a_lo=a_lo, scoring=ts, config=tc)
    for name, w, g in zip(('hatn', 'lcv', 'lci'), want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)


@pytest.mark.parametrize('corridor', ['straight', 'drift'])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_batch_matches_jax(cfg, corridor):
    (js, jc), (ts, tc) = _both(cfg)
    if corridor == 'straight':
        q, r, c0, n_acts, m_acts = _random_tasks(np.random.RandomState(11),
                                                 8, 96, 192)
        want = jwf.wavefront_batch(q, r, c0, n_acts, m_acts, js, jc, W=W,
                                   interpret=True)
        got = twf.wavefront_batch(q, r, c0, n_acts, m_acts, ts, tc, W=W,
                                  device='cpu')
    else:
        q, r, c_rows, n_acts, m_acts = _drifty_tasks(
            np.random.RandomState(31), 4, 100, 220, W)
        want = jwf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts,
                                            js, jc, W=W, interpret=True)
        got = twf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, ts,
                                           tc, W=W, device='cpu')
    for name, w, g in zip(('score', 'end_i', 'end_j'), want, got):
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert (got[0] > tpw.NEG // 2).sum() >= len(got[0]) // 2


def test_drift_precondition_raises():
    q, r, c_rows, n_acts, m_acts = _drifty_tasks(np.random.RandomState(3),
                                                 2, 120, 400, W)
    # a corridor that jumps 150 diagonals inside one group
    c_rows[0] = np.asarray(c_rows[0], np.int64).copy()
    c_rows[0][60:] += 150
    (js, jc), (ts, tc) = _both('semi')
    with pytest.raises(ValueError, match='drift too large'):
        jwf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, js, jc,
                                     W=W, interpret=True)
    with pytest.raises(ValueError, match='drift too large'):
        twf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, ts, tc,
                                     W=W, device='cpu')


@pytest.mark.parametrize('W', [2560, 4096])
def test_wide_short_task_matches_jax(W):
    """Bands wider than 2048 (which the card's kernel once refused) on
    short drifting tasks (n ~ 200): the entry equals the JAX package's."""
    (js, jc), (ts, tc) = _both('semi')
    q, r, c_rows, n_acts, m_acts = _drifty_tasks(np.random.RandomState(41),
                                                 2, 220, 900, W)
    want = jwf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, js, jc,
                                        W=W, interpret=True)
    got = twf.wavefront_batch_corridor(q, r, c_rows, n_acts, m_acts, ts, tc,
                                       W=W, device='cpu')
    for name, w, g in zip(('score', 'end_i', 'end_j'), want, got):
        np.testing.assert_array_equal(w, g, err_msg=name)
    assert (got[0] > tpw.NEG // 2).all()


@pytest.mark.parametrize('W,seg', [(128, twf.SEG), (256, 20), (256, 7),
                                   (2560, twf.SEG)])
@pytest.mark.parametrize('cfg', ['SEMI_GLOBAL', 'FULLY_GLOBAL', 'PATH_CONFIG',
                                 'OVERLAP_CONFIG', 'START_CONFIG',
                                 'END_CONFIG'])
def test_pairs_version_matches_plain(cfg, W, seg):
    """The card kernel's algorithm in plain PyTorch (real-parity lanes
    only, segments of `seg` owned pairs with halos, carries exchanged once
    a group, each task stopped after its wavefront n + m) gives
    wavefront_forward_plain's outputs exactly, on drifting corridors with
    odd and even advances and tasks of different lengths."""
    q, r, c_rows, n_acts, m_acts = _drifty_tasks(np.random.RandomState(23),
                                                 4, 120, 300, W)
    par, db, zq, zr, a_lo, n_groups, Wcap, GWp, _ = twf._prepare(
        q, r, c_rows, n_acts, m_acts, W)
    assert (db[:, :, 1] % 2 == 1).any()              # odd advances
    args = [torch.from_numpy(x) for x in (par, db, zq, zr)]
    kw = dict(W=W, Wcap=Wcap, a_lo=a_lo, scoring=tpw.Scoring(*SCORING),
              config=getattr(tpw, cfg))
    want = twf.wavefront_forward_plain(*args, **kw)
    got = twf.wavefront_forward_pairs(*args, seg=seg, **kw)
    for name, w, g in zip(('hatn', 'lcv', 'lci'), want, got):
        assert torch.equal(w, g), name
    assert int((want[0] > tpw.NEG).sum()) > 0
    assert int(twf.task_groups(args[0], n_groups, a_lo).min()) < n_groups
