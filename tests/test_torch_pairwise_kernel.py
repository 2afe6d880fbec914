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
    for name, n_args in (('pairwise_launch', 24),
                         ('pairwise_launch_plan', 27)):
        params = _prototype(name)
        argtypes = cuda_lib._SIGNATURES[name]
        assert len(params) == len(argtypes) == n_args
        for decl, argtype in zip(params, argtypes):
            if '*' in decl:
                assert argtype is ctypes.c_void_p, decl
            else:
                assert argtype is ctypes.c_int and decl.startswith('int '), \
                    decl


def test_shared_memory_limit_mirrors_the_kernel():
    with open(os.path.join(cuda_lib.CSRC_DIR, 'pairwise.cu')) as f:
        text = f.read()
    const = {name: int(re.search(r'constexpr int %s = (\d+);' % name,
                                 text).group(1))
             for name in ('SMEM_COLS', 'MAXT', 'MAXC', 'RMAX', 'K', 'KC')}
    assert 'return (m_pad + 16) / 16 * 16;' in text
    assert 'return (m_pad + KC) / KC * KC + (n_pad + 4) / 4 * 4;' in text
    assert tp.caps_width(1310, 1420) == 1424 + 1312
    assert [tp.moves_stride(m) for m in (0, 15, 16, 1420)] == \
        [16, 16, 32, 1424]
    assert const['SMEM_COLS'] == tp.SMEM_COLS
    assert (const['MAXT'], const['MAXC'], const['RMAX']) == \
        (tp.MAX_THREADS, tp.MAX_CLUSTER, tp.MAX_ROWS)
    assert 'MAX_STRIPE_ROWS = MAXC * MAXT * RMAX;' in text
    assert const['KC'] == KC
    # the staged reference beside the static rings (2 * KC 8-byte words a
    # slot, one ring a warp) fits the H100's 232,448 bytes a block
    rings = (const['MAXT'] // 32) * const['K'] * 16 * const['KC']
    assert tp.SMEM_COLS + rings + 1024 <= 232448
    # the widest reference dispatch.batch_align sends here is staged
    assert 131072 <= tp.SMEM_COLS



def test_cuda_wrapper_refuses_cpu_tensors():
    """align_batch_cuda never passes host pointers to the kernel."""
    qs, rs = _pairs(5, SIZES[:2])
    host = pack_pairs(qs, rs)
    with pytest.raises(ValueError, match='CUDA'):
        tp.align_batch_cuda(*(torch.from_numpy(x) for x in host),
                            tp.Scoring(*SCORING_T), tp.SEMI_GLOBAL, True)


# ---------------------------------------------------------------------------
# csrc/pairwise.cu's order of work, as a numpy model: row strips, columns in
# time, E a register recurrence over the unmasked G, stripes passing their
# last row through a scratch, moves leaving through 16-byte shift registers
# ---------------------------------------------------------------------------

NEG, NEG_HALF = tp.NEG, tp.NEG // 2
KC = 4          # columns a thread takes a step (csrc/pairwise.cu)


def _strip_model(qs, rs, scoring, config, lower, upper, R, TS,
                 textbook=False):
    """csrc/pairwise.cu on one padded batch, as its threads would run it:
    TS threads of R rows a stripe, each taking a block of KC columns a
    step, thread t one block behind thread t - 1, the strip's bottom row
    (H, F) handed to the next thread and the stripe's to the next stripe.
    Returns (score, end_i, end_j, moves) with the moves in a buffer of
    sentinel bytes (0xEE) where the kernel writes nothing, rows of
    moves_stride(m_pad) bytes, stored as the kernel stores them: a row's
    four bytes of a block into a word of its 16-byte group, the group
    stored whole at its fourth block or the row's last. textbook=True
    takes E over the
    masked H instead (E(j) = max(E(j-1) + ext, H(j-1) + open)), the form
    the kernel must not use."""
    ma, mi, op, ex = scoring
    fs1, fs2, fe1, fe2 = config
    B = len(qs)
    n_pad = max(max(len(q) for q in qs), 1)
    m_pad = max(max(len(r) for r in rs), 1)
    S = tp.moves_stride(m_pad)
    flat = np.full(B * n_pad * S, 0xEE, np.uint8)
    SR = TS * R
    ts = np.arange(TS)
    out = []
    for b, (q, r) in enumerate(zip(qs, rs)):
        n_act, m_act = len(q), len(r)
        lo = -tp.NEG_BAND if lower is None else int(lower[b])
        up = tp.NEG_BAND if upper is None else int(upper[b])
        nblk = m_act // KC + 1
        width = nblk * KC
        js = np.arange(width)
        h0 = np.zeros(width, np.int64) if fs2 else \
            np.where(js > 0, op + (js - 1) * ex, 0)
        h0 = np.where((-js >= lo) & (-js <= up), h0, NEG)
        if n_act == 0:
            row_vals = h0[:m_act + 1]
            rv, rj = row_vals.max(), int(np.argmax(row_vals))
            best, ej = int(h0[m_act]), m_act
            if fe2 and rv > best:
                best, ej = int(rv), rj
            out.append((best, 0, ej))
            continue
        # the reference by column (column 0 and past m_act unused)
        rcol = np.full(width, -1, np.int64)
        rcol[1:m_act + 1] = r
        cv, ci = np.full(TS, -2 ** 62), np.full(TS, 2 ** 62)
        rv = rj = corner = None
        scr = (h0, np.full(width, NEG, np.int64))
        for s in range(-(-n_act // SR)):
            i0 = s * SR + ts * R                      # rows i0+1 .. i0+R
            hl = np.full((R, TS), NEG, np.int64)
            eu, gl, el = hl.copy(), hl.copy(), hl.copy()
            reg = np.zeros((R, TS, 16), np.uint8)     # a group a row
            thl = np.full(TS, NEG, np.int64)
            botH = np.full((TS, width), NEG, np.int64)
            botF = botH.copy()
            for sg in range(nblk + TS):
                cb = sg - ts
                act = (cb >= 0) & (cb < nblk)
                cbc = np.clip(cb, 0, nblk - 1)
                cols = cbc[:, None] * KC + np.arange(KC)[None, :]  # (TS, KC)
                prev = np.maximum(ts - 1, 0)
                hu = np.where(ts[:, None] == 0, scr[0][cols],
                              botH[prev[:, None], cols])
                fu = np.where(ts[:, None] == 0, scr[1][cols],
                              botF[prev[:, None], cols])
                hd = thl.copy()
                thl = np.where(act, hu[:, KC - 1], thl)
                rb = rcol[cols]
                for k in range(R):
                    i = i0 + k + 1
                    qv = np.where(i <= n_act, q[np.clip(i - 1, 0, n_act - 1)],
                                  -2)
                    hb = 0 if fs1 else op + (i - 1) * ex
                    e_c, g_c, el_c = eu[k].copy(), gl[k].copy(), el[k].copy()
                    hp_c = hl[k].copy()
                    nh = np.empty((TS, KC), np.int64)
                    nf = np.empty((TS, KC), np.int64)
                    word = np.zeros((TS, KC), np.uint8)
                    for c in range(KC):
                        j = cbc * KC + c
                        fe = fu[:, c] + ex
                        fn = np.maximum(hu[:, c] + op, fe)
                        fb = (fn == fe) & (fu[:, c] > NEG_HALF)
                        left = hd if c == 0 else hu[:, c - 1]
                        dg = left + np.where(rb[:, c] == qv, ma, mi)
                        g = np.maximum(dg, fn)
                        if textbook:
                            e = np.maximum(el_c + ex, hp_c + op)
                        else:
                            e = np.maximum(e_c + ex, g_c + op)
                        h = np.maximum(g, e)
                        j0c = j == 0
                        dg = np.where(j0c, hb, dg)
                        g = np.where(j0c, hb, g)
                        e = np.where(j0c, NEG, e)
                        h = np.where(j0c, hb, h)
                        d = i - j
                        inb = (d >= lo) & (d <= up)
                        h = np.where(inb, h, NEG)
                        em = np.where(inb, e, NEG)
                        fm = np.where(inb, fn, NEG)
                        eb = (em == el_c + ex) & (el_c > NEG_HALF)
                        src = np.where(h == dg, 0, np.where(h == em, 1, 2))
                        word[:, c] = src | (eb << 2) | (fb << 3)
                        e_c, g_c, el_c, hp_c = e, g, em, h
                        nh[:, c], nf[:, c] = h, fm
                    eu[k] = np.where(act, e_c, eu[k])
                    gl[k] = np.where(act, g_c, gl[k])
                    el[k] = np.where(act, el_c, el[k])
                    for t in np.nonzero(act)[0]:
                        it, j0 = int(i[t]), int(cbc[t]) * KC
                        for c in range(KC):
                            jt = j0 + c
                            if it == n_act and jt <= m_act:
                                if rv is None or nh[t, c] > rv:
                                    rv, rj = int(nh[t, c]), jt
                                if jt == m_act:
                                    corner = int(nh[t, c])
                            if jt == m_act and it <= n_act and \
                                    nh[t, c] > cv[t]:
                                cv[t], ci[t] = nh[t, c], it
                        w4 = (j0 // KC) & 3
                        reg[k, t, 4 * w4:4 * w4 + 4] = word[t]
                        if it <= n_act and (w4 == 3 or j0 + KC > m_act):
                            g = (b * n_pad + it - 1) * S + (j0 & ~15)
                            flat[g:g + 16] = reg[k, t]
                    hd_next = hl[k].copy()
                    hl[k] = np.where(act, nh[:, KC - 1], hl[k])
                    hu, fu, hd = nh, nf, hd_next
                for t in np.nonzero(act)[0]:
                    c0 = int(cbc[t]) * KC
                    botH[t, c0:c0 + KC] = hu[t]
                    botF[t, c0:c0 + KC] = fu[t]
            scr = (botH[TS - 1], botF[TS - 1])
        bv, bi = int(h0[m_act]), 0
        for t in range(TS):          # (value, lowest row), row 0 first
            if cv[t] > bv or (cv[t] == bv and ci[t] < bi):
                bv, bi = int(cv[t]), int(ci[t])
        best, ei, ej = corner, n_act, m_act
        if fe2 and rv > best:
            best, ej = rv, rj
        if fe1 and bv > best:
            best, ei, ej = bv, bi, m_act
        out.append((best, ei, ej))
    return np.array(out).T, flat.reshape(B, n_pad, S)


# small pairs, long enough that several strips, stripes and 16-byte groups
# meet; the lopsided and empty pairs of SIZES
MODEL_SIZES = [(23, 29), (37, 31), (5, 40), (40, 6), (0, 9), (12, 0),
               (31, 35)]


@pytest.mark.parametrize('R,TS', [(1, 8), (2, 5), (4, 3)])
@pytest.mark.parametrize('band', [None, 4])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_strip_order_model_matches_jax(cfg, band, R, TS):
    """The kernel's order of work gives _align_single's scores, ends and
    moves bit for bit, whatever R and the stripe height (R > 1 puts rows
    of one strip on both sides of a stripe's edge), and its stores write
    each pair's real region and nothing past its rows n_act or its last
    16-byte group."""
    qs, rs = _pairs(11, MODEL_SIZES)
    jhost = je.pack_pairs(qs, rs)
    lower, upper = _diags(jhost[1], jhost[3], band)
    want = jp.align_batch_device(*jhost, jp.Scoring(*SCORING_T),
                                 jp.AlignConfig(*CONFIGS[cfg]), True,
                                 lower, upper)
    (score, ei, ej), moves = _strip_model(
        qs, rs, SCORING_T, CONFIGS[cfg], lower, upper, R, TS)
    for g, w in zip((score, ei, ej), want[:3]):
        assert np.array_equal(g, np.asarray(w))
    jmoves = np.asarray(want[3])
    for b, (q, r) in enumerate(zip(qs, rs)):
        n, m = len(q), len(r)
        assert np.array_equal(moves[b, :n, :m + 1], jmoves[b, :n, :m + 1])
        assert (moves[b, n:] == 0xEE).all()
        assert (moves[b, :n, tp.moves_stride(m):] == 0xEE).all()


def test_band_carries_f_from_the_column_left_of_it():
    """Under a band, the column just left of it holds a real F (from the
    in-band cell above), and E carries it into the band: the textbook E
    over the masked H gives other moves, so the model above holds the
    kernel's form to something the band really exercises."""
    qs, rs = _pairs(11, MODEL_SIZES)
    jhost = je.pack_pairs(qs, rs)
    lower, upper = _diags(jhost[1], jhost[3], 4)
    want = np.asarray(jp.align_batch_device(
        *jhost, jp.Scoring(*SCORING_T), jp.AlignConfig(*CONFIGS['global']),
        True, lower, upper)[3])
    _, moves = _strip_model(qs, rs, SCORING_T, CONFIGS['global'], lower,
                            upper, 2, 5, textbook=True)
    differ = sum(not np.array_equal(moves[b, :len(q), :len(r) + 1],
                                    want[b, :len(q), :len(r) + 1])
                 for b, (q, r) in enumerate(zip(qs, rs)))
    assert differ > 0


def test_full_plan_mirrors_the_kernel_rule():
    """full_plan (the kernel's pairwise_plan): R = 1 below 256 rows, 2 up
    to 4,096, 4 beyond; about 128 of a pair's threads a block, up to 8
    blocks; a stripe covers the rows up to MAX_STRIPE_ROWS; the wide
    pairs' 128 rows are 128 threads of one block."""
    assert tp.full_plan(128) == (1, 128, 1, 1)
    assert tp.full_plan(1310) == (2, 96, 8, 1)
    assert tp.full_plan(1932) == (2, 128, 8, 1)
    assert tp.full_plan(131072) == (4, 256, 8, 16)
    assert tp.full_plan(0) == (1, 32, 1, 1)
    for n in (1, 31, 255, 256, 511, 512, 1024, 2048, 4096, 8192, 8193,
              30000):
        R, T, C, stripes = tp.full_plan(n)
        assert T % 32 == 0 and T <= tp.MAX_THREADS and C <= tp.MAX_CLUSTER
        assert C * T * R * stripes >= n
        assert (stripes > 1) == (n > tp.MAX_STRIPE_ROWS)
        assert R == (1 if n < 256 else 2 if n <= 4096 else 4)


# ---------------------------------------------------------------------------
# The walk: walk_full_plain against the JAX decode, its layout against
# today's CPU route, and a lane-level model of csrc/pairwise_walk.cu
# ---------------------------------------------------------------------------

def _forward(qs, rs, cfg, band):
    host, out = _port(qs, rs, cfg, band, True)
    return host, out


@pytest.mark.parametrize('band', [None, 20])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_walk_full_plain_matches_jax_decode(cfg, band):
    """walk_full_plain's header and runs (walk order) are the JAX
    package's decode_traceback on the JAX moves, pair for pair."""
    qs, rs = _pairs(13)
    jhost = je.pack_pairs(qs, rs)
    lower, upper = _diags(jhost[1], jhost[3], band)
    jconfig = jp.AlignConfig(*CONFIGS[cfg])
    js, ji, jj, jm = (np.array(x) for x in jp.align_batch_device(
        *jhost, jp.Scoring(*SCORING_T), jconfig, True, lower, upper))
    out = tp.walk_full_plain(torch.from_numpy(jm), torch.from_numpy(js),
                             torch.from_numpy(ji), torch.from_numpy(jj),
                             tp.AlignConfig(*CONFIGS[cfg]))
    assert out.dtype == torch.int32 and out.shape == (
        len(qs), tp.WALK_HEAD + 2 * tp.walk_ops(*jm.shape[1:2],
                                                jm.shape[2] - 1))
    for b, (head, runs) in enumerate(tp.walk_records(out)):
        cigar, si, sj = jp.decode_traceback(jm[b], ji[b], jj[b], jconfig)
        codes = {'M': 0, 'I': 1, 'D': 2}
        assert head == (int(js[b]), int(ji[b]), int(jj[b]), len(cigar),
                        si, sj)
        assert runs == tuple(x for c, op in reversed(cigar)
                             for x in (c, codes[op]))


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_walk_layout_gives_the_cpu_route_alignments(cfg):
    """pairs_from_walk over walk_full_plain's layout (what the card's route
    fetches) gives align_pairs's PairAlignments on the CPU, cigars as the
    same [(count, op)] lists."""
    qs, rs = _pairs(17)
    config = tp.AlignConfig(*CONFIGS[cfg])
    want = tp.align_pairs(qs, rs, tp.Scoring(*SCORING_T), config,
                          device='cpu')
    for band in (None, 20):
        host, (score, end_i, end_j, moves) = _forward(qs, rs, cfg, band)
        got = tp.pairs_from_walk(
            tp.walk_full_plain(moves, score, end_i, end_j, config).numpy(),
            host[1], host[3])
        if band is None:
            assert got == want
            assert all(type(g.cigar) is list for g in got)
        ref = tp.align_pairs(qs, rs, tp.Scoring(*SCORING_T), config,
                             band=band, device='cpu')
        assert got == ref


def test_cpu_route_spans_nest_under_the_caller():
    """align_pairs's spans pack, fetch and decode nest under the caller's
    span; the CPU route copies nothing to the host and counts no fetch
    bytes."""
    from unicycler_tpu_torch.utils import trace
    qs, rs = _pairs(5, SIZES[:4])
    trace.reset()
    trace.enable()
    try:
        with trace.span('full_dp'):
            tp.align_pairs(qs, rs, tp.Scoring(*SCORING_T), tp.SEMI_GLOBAL,
                           device='cpu')
    finally:
        trace.disable()
    got = trace.as_dict()
    assert {'full_dp/pack', 'full_dp/fetch', 'full_dp/decode'} <= \
        set(got['spans'])
    assert 'full_dp.fetch_bytes' not in got['counters']
    trace.reset()


TR, SPAN, HALF, NBUF, DW = 32, 128, 56, 4, 8   # csrc/pairwise_walk.cu


def _walk_model(moves, score, end_i, end_j, fs1, fs2):
    """csrc/pairwise_walk.cu, lane by lane: chunks of TR rows staged as
    SPAN-byte windows around a guessed diagonal (a diagonal's miss
    restages, a gap run's miss finishes the run from device memory, DW
    cells a lane), 32 steps at a time by ballots; returns its output rows
    and the numbers of restages and of direct runs. Reads only staged
    bytes outside the direct runs, so a window or chunk fault shows as a
    wrong walk or a miss that never ends."""
    B, n_pad, m1 = moves.shape
    flat = moves.reshape(-1)
    total16 = flat.size & ~15
    direct = total16 < SPAN
    lanes = np.arange(32)
    out = np.zeros((B, tp.WALK_HEAD + 2 * tp.walk_ops(n_pad, m1 - 1)),
                   np.int32)
    restages = directs = 0
    for b in range(B):
        pbase = b * n_pad * m1
        i, j = int(end_i[b]), int(end_j[b])
        runs = []

        def emit(op, n):
            if n <= 0:
                return
            if runs and runs[-1][1] == op:
                runs[-1][0] += n
            else:
                runs.append([n, op])

        bufs = {}                       # chunk number -> (top, ws, bytes)

        def stage(kk, top_k, te, je):
            ws = np.zeros(TR, np.int64)
            data = np.zeros((TR, SPAN), np.int64)
            for ln in range(TR):
                t = top_k - ln
                if t < 0:
                    continue
                want = pbase + t * m1 + (je - (te - t)) - HALF
                w = min(want & ~15, total16 - SPAN)
                w = max(w, 0)
                ws[ln] = w
                data[ln] = flat[w:w + SPAN]
            bufs[kk] = (top_k, ws, data)

        top, k = i - 1, 0
        if not direct and i > 0 and j > 0:
            for c in range(NBUF):
                stage(c, top - c * TR, i - 1, j)

        def cell(t, jj):
            off = pbase + t * m1 + jj
            if direct or off >= total16:
                return int(flat[off])
            s = top - t
            if s < 0 or s >= TR:
                return -2
            ctop, ws, data = bufs[k]
            assert ctop == top
            o = off - ws[s]
            return int(data[s, o]) if 0 <= o < SPAN else -1

        state = 0
        while True:
            if state == 0:
                if i == 0:
                    if not fs2 and j > 0:
                        emit(2, j)
                        j = 0
                    break
                if j == 0:
                    if not fs1 and i > 0:
                        emit(1, i)
                        i = 0
                    break
            if not direct and i - 1 < top - TR + 1:
                k += 1
                top -= TR
                stage(k + NBUF - 1, top - (NBUF - 1) * TR, i - 1, j)
            if state == 0:
                c = [cell(i - 1 - x, j - x) if i - x >= 1 and j - x >= 1
                     else -1 for x in lanes]
                diag = [v >= 0 and (v & 3) == 0 for v in c]
                n = diag.index(False) if False in diag else 32
                if n:
                    emit(0, n)
                    i -= n
                    j -= n
                    continue
                if c[0] < 0:
                    restages += 1
                    assert restages < 10000
                    for cc in range(NBUF):
                        stage(k + cc, top - cc * TR, i - 1, j)
                    continue
                state = 1 if (c[0] & 3) == 1 else 2
            else:
                horiz = state == 1
                c = []
                for x in lanes:
                    ti, tj = (i - 1, j - x) if horiz else (i - 1 - x, j)
                    c.append(cell(ti, tj) if ti >= 0 and tj >= 1 else -3)
                if horiz:
                    stop = [v >= 0 and (not (v & 4) or j - x == 1)
                            for x, v in zip(lanes, c)]
                else:
                    stop = [v >= 0 and (not (v & 8) or i - 1 - x == 0)
                            for x, v in zip(lanes, c)]
                go = [v >= 0 and not st for v, st in zip(c, stop)]
                n = go.index(False) if False in go else 32
                ended = n < 32 and stop[n]
                steps = n + 1 if ended else n
                emit(2 if horiz else 1, steps)
                if horiz:
                    j -= steps
                else:
                    i -= steps
                if ended:
                    state = 0
                elif n < 32 and c[n] == -1:
                    directs += 1
                    while True:      # run_direct
                        first = []
                        for ln in lanes:
                            f = DW
                            for cc in range(DW):
                                x = ln * DW + cc
                                t, jj = (i - 1, j - x) if horiz else \
                                    (i - 1 - x, j)
                                v = int(flat[pbase + t * m1 + jj]) \
                                    if t >= 0 and jj >= 1 else 0
                                st = (not (v & 4) or j - x <= 1) if horiz \
                                    else (not (v & 8) or i - 1 - x <= 0)
                                if st:
                                    f = cc
                                    break
                            first.append(f)
                        hit = [ln for ln in lanes if first[ln] < DW]
                        n = hit[0] * DW + first[hit[0]] + 1 if hit \
                            else 32 * DW
                        emit(2 if horiz else 1, n)
                        if horiz:
                            j -= n
                        else:
                            i -= n
                        if hit:
                            break
                    state = 0
                    if not direct and i > 0 and i - 1 < top - TR + 1:
                        top = i - 1
                        restages += 1
                        for cc in range(NBUF):
                            stage(k + cc, top - cc * TR, i - 1, j)
        out[b, :tp.WALK_HEAD] = (score[b], end_i[b], end_j[b], len(runs),
                                 i, j)
        if runs:
            out[b, tp.WALK_HEAD:tp.WALK_HEAD + 2 * len(runs)] = \
                np.asarray(runs).ravel()
    return out, restages, directs


def _gappy_pairs(seed):
    """Pairs whose paths leave the staged windows: insertions and
    deletions of 60-150 bases (more than a window's slack), beside a
    diagonal-heavy pair and one too short to stage."""
    rng = np.random.default_rng(seed)
    qs, rs = [], []
    for n_ins, n_del in ((90, 0), (0, 120), (70, 150), (0, 0)):
        base = rng.integers(0, 4, 300).astype(np.int8)
        q = np.concatenate([base[:100], rng.integers(0, 4, n_ins)
                            .astype(np.int8), base[100:]])
        r = np.concatenate([base[:180], rng.integers(0, 4, n_del)
                            .astype(np.int8), base[180:]])
        qs.append(q)
        rs.append(r)
    return qs, rs


@pytest.mark.parametrize('case', ['gappy', 'mixed', 'tiny'])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'end'])
def test_walk_kernel_model_matches_plain(cfg, case):
    """The kernel's walk (windows, restages, 32-step ballots) gives
    walk_full_plain's headers and runs, on paths with gaps longer than a
    window's slack (some restage), mixed pairs and a buffer too small to
    stage (read directly)."""
    qs, rs = {'gappy': lambda: _gappy_pairs(3),
              'mixed': lambda: _pairs(7),
              'tiny': lambda: _pairs(7, [(3, 4), (2, 2)])}[case]()
    config = tp.AlignConfig(*CONFIGS[cfg])
    _, (score, end_i, end_j, moves) = _forward(qs, rs, cfg, None)
    want = tp.walk_records(tp.walk_full_plain(moves, score, end_i, end_j,
                                              config))
    got, restages, directs = _walk_model(
        moves.numpy(), score.numpy(), end_i.numpy(), end_j.numpy(),
        config.free_start_s1, config.free_start_s2)
    assert tp.walk_records(got) == want
    if case == 'gappy' and cfg == 'global':
        assert restages > 0 and directs > 0


def test_walk_cuda_wrapper_refuses_cpu_tensors():
    qs, rs = _pairs(5, SIZES[:2])
    _, (score, end_i, end_j, moves) = _forward(qs, rs, 'semi', None)
    with pytest.raises(ValueError, match='CUDA'):
        tp.walk_full_cuda(moves, score, end_i, end_j, tp.SEMI_GLOBAL)


def test_walk_kernel_is_built_and_bound_by_pointer():
    assert 'pairwise_walk.cu' in cuda_lib.SOURCES
    assert 'pairwise_walk' in cuda_lib.LAUNCHES
    params = _prototype('pairwise_walk_launch')
    argtypes = cuda_lib._SIGNATURES['pairwise_walk_launch']
    assert len(params) == len(argtypes) == 12
    for decl, argtype in zip(params, argtypes):
        if '*' in decl:
            assert argtype is ctypes.c_void_p, decl
        else:
            assert argtype is ctypes.c_int and decl.startswith('int '), decl
    with open(os.path.join(cuda_lib.CSRC_DIR, 'pairwise_walk.cu')) as f:
        text = f.read()
    for name, value in (('TR', TR), ('SPAN', SPAN), ('HALF', HALF),
                        ('NBUF', NBUF), ('HEAD', tp.WALK_HEAD)):
        assert re.search(r'constexpr int %s = %d;' % (name, value), text)
