"""(h) The port's CUDA route against its plain versions, on the card.

Every test here is marked `gpu` and skips on a host without a CUDA
device; the decision is taken inside each test. The file imports nothing
of JAX, so it runs on a machine that has only PyTorch:

    UNICYCLER_TPU_TESTS=1 python -m pytest tests/test_torch_gpu.py -m gpu

(UNICYCLER_TPU_TESTS=1 keeps tests/conftest.py from importing jax.)
It drives the inputs of the CPU parity tests through the CUDA kernels:
the wave route on the card equals the same route on the CPU (the plain
versions, which the CPU tests hold to the JAX package), the kernels'
raw outputs are bit-equal to their plain versions, and the device driver
of align_jobs places the reads of the small synthetic genome.
"""

import random

import numpy as np
import pytest
import torch

from torch_parity import (CONFIGS, SCORING_T, pa_key, retally, tasks_np,
                          zigzag_tasks)

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _routes(tasks, cfg, W, dev):
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    bt = [bo.BandedTask(*t) for t in tasks]
    args = (Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W, True)
    got = bo.align_banded_tape(bt, *args, device=dev)
    want = bo.align_banded_tape(bt, *args, device='cpu')
    return [pa_key(p) for p in got], [pa_key(p) for p in want]


@pytest.mark.parametrize('W', [128, 512, 1024, 2048])
@pytest.mark.parametrize('drift', [False, True], ids=['straight', 'drift'])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_wave_route_matches_cpu_route(cfg, drift, W):
    dev = _cuda()
    got, want = _routes(tasks_np(11, [60, 120, 200, 330, 90, 170], drift),
                        cfg, W, dev)
    assert got == want


def _wave_kernels_match_plain(tp, scoring, config, W, dev):
    """Both wave kernels against their plain versions on one launch:
    moves and best over each track's real groups, records and fin."""
    from unicycler_tpu_torch.ops import wavetape_kernels as wk
    from unicycler_tpu_torch.ops.wavetape import forward_inputs
    up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
    plane, _ = wk.group_plane(*up[2:11], tp.LR, tp.r_flat.shape[1], W)
    ngt = wk.track_groups(up[11])
    got = wk.wavetape_forward_cuda(up[0], up[1], plane, ngt, scoring,
                                   config, W, True)
    want = wk.wavetape_forward_plain(up[0], up[1], plane, scoring, config,
                                     W, True)
    for g, w in zip(wk.real_groups(*got, ngt), wk.real_groups(*want, ngt)):
        assert torch.equal(g, w)
    score, ei, ej, moves, db = wk.wavetape_forward(
        *up, scoring=scoring, config=config, W=W, need_moves=True)
    valid = up[4] > 0
    zero = torch.zeros_like(ei)
    args = [x.to(torch.int32).contiguous() for x in
            (moves, db, torch.from_numpy(tp.n_tasks).to(dev),
             torch.where(valid, ei, zero), torch.where(valid, ej, zero),
             torch.where(valid, torch.from_numpy(tp.abase).to(dev),
                         zero))]
    rec, fin = wk.wavetape_traceback_cuda(*args, W)
    rec_p, fin_p = wk.wavetape_traceback_plain(*args, W)
    assert torch.equal(rec, rec_p) and torch.equal(fin, fin_p)
    return rec


@pytest.mark.parametrize('W,bt', [(128, 8), (512, 32), (1024, 8),
                                  (2048, 8)])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_kernels_bit_equal_to_plain(cfg, W, bt):
    """The JAX package's layout (several tasks a track) through the wave
    kernels, and the banded kernel, against their plain versions."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    from unicycler_tpu_torch.ops.wavetape import build_wavetapes
    scoring, config = Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg])
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(23, [180, 333, 90, 400, 260], drift=True)]
    tp = build_wavetapes(tasks, W, bo.build_corridor, bt=bt)[0]
    _wave_kernels_match_plain(tp, scoring, config, W, dev)

    _banded_kernels_match_plain(tasks, scoring, config, W, dev)


def _banded_kernels_match_plain(tasks, scoring, config, W, dev, lanes=(0,)):
    """The banded kernel (at each `lanes` a thread) against its plain
    version on tasks packed into one bucket: score, ends and moves rows
    [0, n_act); the banded walker against its plain version on the
    kernel's moves. Returns the walker's records."""
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    n_pad = bo.bucket_length(max(len(t.q) for t in tasks))
    m_pad = bo.bucket_length(max(len(t.r) for t in tasks))
    host = bo._pack_bucket(tasks, list(range(len(tasks))), n_pad, m_pad, W,
                           bk.BT)
    bargs = [torch.from_numpy(x).to(dev) for x in host]
    n_acts = bargs[3]
    want = bk.banded_batch_plain(*bargs, scoring, config, W, True)
    for ln in lanes:
        got = bk.banded_batch_cuda(*bargs, scoring, config, W, True,
                                   lanes=ln)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w), 'lanes %d' % ln
        assert torch.equal(bk.moves_rows_real(got[3], n_acts),
                           bk.moves_rows_real(want[3], n_acts)), \
            'lanes %d' % ln
    score, ei, ej, moves = got
    crow = bargs[2][:, 1:].contiguous()
    rec, fin = tbk.banded_traceback_cuda(moves, crow, ei, ej, W)
    rec_p, fin_p = tbk.banded_traceback_plain(moves, crow, ei, ej, W)
    assert torch.equal(rec, rec_p) and torch.equal(fin, fin_p)
    return rec


@pytest.mark.parametrize('W', [128, 512, 1024, 2048, 4096, 16384])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_banded_kernels_bit_equal_to_plain(cfg, W):
    """Kernels 3 and 6 of the retry path against their plain versions at
    the wave route's widths and the row route's, on drifting and zigzag
    corridors (rows drifting up to MAX_SHIFT), the fast kernel at each
    lanes-a-thread template that fits."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(29, [180, 700, 90, 400, 1300, 64], drift=True)
             + zigzag_tasks(3, n_tasks=6)]
    lanes = [ln for ln in (2, 4, 8) if (W + 128) // ln <= 576] or [0]
    rec = _banded_kernels_match_plain(tasks, Scoring(*SCORING_T),
                                      AlignConfig(*CONFIGS[cfg]), W, dev,
                                      lanes)
    assert int((rec != 0).sum()) > 1000


@pytest.mark.parametrize('W', [128, 512, 1024, 2048])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'path'])
def test_gpu_task_layout_kernels_bit_equal_to_plain(cfg, W):
    """The card's layout (one task a track) at 264 tracks of mixed
    lengths through both wave kernels, against their plain versions."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    from unicycler_tpu_torch.ops.wavetape import build_wave_launches
    rng = np.random.default_rng(W)
    sizes = [int(x) for x in rng.integers(30, 400, 264)]
    tasks = [bo.BandedTask(*t) for t in tasks_np(61, sizes, drift=True)]
    launches = build_wave_launches(tasks, W, bo.build_corridor)
    assert len(launches) == 1 and launches[0].q_tape.shape[0] == 264
    rec = _wave_kernels_match_plain(launches[0], Scoring(*SCORING_T),
                                    AlignConfig(*CONFIGS[cfg]), W, dev)
    assert int((rec != 0).sum()) > 264 * 20


def test_gpu_call_fills_the_card():
    """A call of >= 132 tasks launches >= 132 tracks a launch."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    from unicycler_tpu_torch.utils import trace
    rng = np.random.default_rng(3)
    sizes = [int(x) for x in rng.integers(200, 1500, 200)]
    tasks = [bo.BandedTask(*t) for t in tasks_np(67, sizes, drift=True)]
    trace.reset()
    trace.enable()
    cuda_lib.reset_launches()
    try:
        got = bo.align_banded_tape(tasks, Scoring(*SCORING_T), SEMI_GLOBAL,
                                   512, True, device=dev)
    finally:
        trace.disable()
    ctr = trace.as_dict()['counters']
    launches = cuda_lib.LAUNCHES['wavetape_fwd']
    assert launches >= 1 and cuda_lib.LAUNCHES['wavetape_walk'] == launches
    assert ctr['wave.tracks'] / ctr['wave.launches'] >= 132
    assert ctr.get('wave.short_launches', 0) == 0
    for t, pa in zip(tasks, got):
        if pa.cigar:
            assert retally(t.q, t.r, pa) == pa.score


@pytest.mark.parametrize('seed,sensitivity', [(1, 0), (2, 1)])
def test_gpu_slice(seed, sensitivity):
    """The device driver of align_jobs on the workload of the CPU slice
    test: reads land on their origin and every CIGAR re-tallies to its
    score; the wave route on the card equals the CPU route on the tasks
    that seeding builds for those reads."""
    dev = _cuda()
    from unicycler_tpu_torch import settings, synth
    from unicycler_tpu_torch.align import semi_global as sg
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.io.fastx import Read, Reference
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import minimizer as mz

    rng = np.random.default_rng(seed)
    reps = synth.random_replicons(rng, [24000, 6000])
    reads = synth.simulate_reads(rng, reps, 8, n50=2500, min_len=1000,
                                 max_len=4000)
    refs = [Reference(str(i + 1), s) for i, s in enumerate(reps)]
    rd = [Read(n, s, None) for n, s, _ in reads]
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    random.seed(0)
    cuda_lib.reset_launches()
    sg.align_jobs([sg.AlignJob(rd, refs, scheme,
                               sensitivity_level=sensitivity)], device=dev)
    assert cuda_lib.LAUNCHES['wavetape_fwd'] > 0
    assert cuda_lib.LAUNCHES['wavetape_walk'] > 0
    placed = 0
    for read, (_, _, truth) in zip(rd, reads):
        for a in read.alignments:
            assert a.raw_score == a._pair.score
        if read.alignments:
            best = max(read.alignments, key=lambda a: a.raw_score)
            placed += (best.ref is refs[truth.replicon]
                       and bool(best.rev_comp) == truth.rev_comp
                       and abs(best.ref_start_pos - truth.start) <= 100)
    assert placed >= len(rd) - 1

    band = settings.BAND_SIZES[0]
    index = mz.get_cached_index([r.codes for r in refs],
                                settings.SEED_KMER_SIZES[0], 10)
    tasks = []
    for read in rd:
        clusters = index.lookup(read.codes)
        tasks += sg._make_tasks(read, refs, clusters[
            :settings.MAX_LINE_TRACE_COUNTS[0]], band)
    tasks = [tuple(t.banded) for t in tasks]
    got, want = _routes(tasks, 'semi', bo.band_width(band), dev)
    assert got == want


def test_gpu_retry_path_matches_cpu():
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(17, [90, 400, 230, 1500], drift=True)]
    cuda_lib.reset_launches()
    got = bo._align_banded_moves_path(tasks, Scoring(*SCORING_T),
                                      SEMI_GLOBAL, 512, True, device=dev)
    assert cuda_lib.LAUNCHES['banded'] > 0
    want = bo._align_banded_moves_path(tasks, Scoring(*SCORING_T),
                                       SEMI_GLOBAL, 512, True, device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]


@pytest.mark.parametrize('W', [4096, 16384])
@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_gpu_retry_path_wide_matches_cpu(cfg, W):
    """The retry path at the row route's widths runs kernels 3 and 6 on
    the card and equals the CPU route."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(19, [300, 480, 120], drift=True)]
    args = (Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W, True)
    cuda_lib.reset_launches()
    got = bo._align_banded_moves_path(tasks, *args, device=dev)
    assert cuda_lib.LAUNCHES['banded'] > 0
    assert cuda_lib.LAUNCHES['banded_walk'] > 0
    want = bo._align_banded_moves_path(tasks, *args, device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    assert all(p.cigar for p in got)


def _row_kernels_match_plain(tp, scoring, config, W, dev, clusters):
    """Both row kernels against their plain versions on one TapeLaunch,
    the forward at each cluster size: moves, hatn and best over each
    track's real groups, records and fin. Returns the records."""
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.tape import forward_inputs
    up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
    rowinfo, gplane, _, _ = tk.tape_prolog(up[0], up[1], up[2], up[3],
                                           up[5], up[7], up[8], W)
    ngt = tk.track_groups(up[11])
    want = tk.tape_forward_plain(rowinfo, gplane, up[1], scoring, config, W,
                                 True, ngt=ngt)
    for C in clusters:
        got = tk.real_rows(*tk.tape_forward_cuda(
            rowinfo, gplane, up[1], ngt, scoring, config, W, True,
            cluster=C), ngt)
        for g, w in zip(got, want):
            assert torch.equal(g, w), 'cluster size %d' % C
    score, ei, ej, moves, (c_rel, jr_rows) = tk.tape_forward(
        *up, scoring=scoring, config=config, W=W, need_moves=True)
    valid = up[6] > 0
    zero = torch.zeros_like(ei)
    args = [x.to(torch.int32).contiguous() for x in
            (moves, c_rel, jr_rows, torch.from_numpy(tp.n_tasks).to(dev),
             torch.where(valid, up[8] + ei, zero),
             torch.where(valid, ej, zero), torch.where(valid, up[8], zero))]
    rec, fin = tk.tape_traceback_cuda(*args, W)
    rec_p, fin_p = tk.tape_traceback_plain(*args, W)
    assert torch.equal(rec, rec_p) and torch.equal(fin, fin_p)
    return rec


@pytest.mark.parametrize('bt', [8, 32])
@pytest.mark.parametrize('W', [4096, 8192])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'path'])
def test_gpu_tape_kernels_bit_equal_to_plain(cfg, W, bt):
    """The row-tape forward kernel and walker against their plain
    versions, at the bands of long-read bridging, on the JAX package's
    layout (several tasks a track), the forward at the launch's own
    cluster size."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    from unicycler_tpu_torch.ops.tape import build_tapes
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(29, [180, 333, 90, 400, 260, 700, 150, 520, 64],
                      drift=True)]
    tp = build_tapes(tasks, W, bo.build_corridor, bt=bt)[0]
    rec = _row_kernels_match_plain(
        tp, Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W, dev,
        [tk.launch_cluster(bt, W, dev)])
    assert int((rec != 0).sum()) > 1000


@pytest.mark.parametrize('W', [4096, 8192, 16384, 32768])
@pytest.mark.parametrize('cfg', ['semi', 'global', 'path'])
def test_gpu_row_layout_kernels_bit_equal_to_plain(cfg, W):
    """The card's row layout (one task a track, tracks of different
    lengths) through the forward kernel at each cluster size that fits
    the band (1, 2, 4 and 8 up to W 8192; C >= 2 at W 16384, C >= 4 at W
    32768) and the walker, against their plain versions."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    from unicycler_tpu_torch.ops.tape import build_row_launches
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(31, [180, 333, 90, 400, 260, 700, 150, 520, 64, 610],
                      drift=True)]
    launches = build_row_launches(tasks, W, bo.build_corridor)
    assert len(launches) == 1 and launches[0].qf.shape[0] == len(tasks)
    clusters = [C for C in (1, 2, 4, 8)
                if tk.region_width(W) // C <= tk.MAX_BLOCK_LANES]
    assert clusters == {4096: [1, 2, 4, 8], 8192: [1, 2, 4, 8],
                        16384: [2, 4, 8], 32768: [4, 8]}[W]
    rec = _row_kernels_match_plain(
        launches[0], Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W,
        dev, clusters)
    assert int((rec != 0).sum()) > 2000


@pytest.mark.parametrize('cfg', ['semi', 'global', 'path'])
def test_gpu_row_kernels_short_task_w131072(cfg):
    """A short task (<= 256 rows) at W 131,072, too wide for every
    cluster size: the tiled forward kernel (one block a track) and the
    walker against their plain versions."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import tape_kernels as tk
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    from unicycler_tpu_torch.ops.tape import build_row_launches
    W = 131072
    assert tk.tiled(W) and tk.launch_cluster(1, W, dev) == 1
    tasks = [bo.BandedTask(*t) for t in tasks_np(37, [230], drift=True)]
    launches = build_row_launches(tasks, W, bo.build_corridor)
    assert len(launches) == 1 and launches[0].L_real <= 256
    rec = _row_kernels_match_plain(
        launches[0], Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W,
        dev, [1])
    assert int((rec != 0).sum()) > 150


def test_gpu_cluster_size_fills_the_card():
    """The launch's cluster size: 8 blocks a track for a few tracks, fewer
    as the tracks grow, every cluster resident at once."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import tape_kernels as tk
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for W in (4096, 8192):
        assert tk.launch_cluster(8, W, dev) == 8
        for tracks in (1, 10, 16, 33, 66, 84, 132, 300):
            C = tk.launch_cluster(tracks, W, dev)
            assert C == 1 or (tracks * C <= sms
                              and tracks <= tk.resident_clusters(C, W))


@pytest.mark.parametrize('cfg', ['global', 'path'])
def test_gpu_batch_align_row_route_matches_cpu(cfg, monkeypatch):
    """batch_align at W = 4096 on the card (row-tape kernels) equals the
    CPU route (bucketed row DP): the row route is exact per row band."""
    dev = _cuda()
    from unicycler_tpu_torch import settings
    from unicycler_tpu_torch.ops import cuda_lib, dispatch
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    monkeypatch.setattr(settings, 'MAX_FULL_DP_CELLS', 1 << 16)
    rng = np.random.default_rng(7)
    qs, rs = [], []
    for n in (700, 1500, 400, 2600, 1100):
        r = rng.integers(0, 4, n).astype(np.int8)
        keep = rng.random(n) > 0.05
        q = r[keep].copy()
        flip = rng.random(len(q)) < 0.05
        q[flip] = (q[flip] + 1) % 4
        qs.append(q)
        rs.append(r)
    args = (Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), 1000, True)
    cuda_lib.reset_launches()
    got = dispatch.batch_align(qs, rs, *args, device=dev)
    assert cuda_lib.LAUNCHES['tape_fwd'] > 0
    assert cuda_lib.LAUNCHES['tape_walk'] > 0
    want = dispatch.batch_align(qs, rs, *args, device='cpu')
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]


@pytest.mark.parametrize('W', [256, 512, 1024, 2048])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_banded_walk_bit_equal_to_plain(cfg, W):
    """The banded traceback walker against its plain version, on the
    banded kernel's moves at the retry path's widths."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    scoring, config = Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg])
    tasks = [bo.BandedTask(*t) for t in
             tasks_np(29, [180, 700, 90, 400, 1300, 64], drift=True)]
    host = bo._pack_bucket(tasks, list(range(len(tasks))), 2048, 2048, W,
                           bk.BT)
    bargs = [torch.from_numpy(x).to(dev) for x in host]
    score, ei, ej, moves = bk.banded_batch_cuda(*bargs, scoring, config, W,
                                                True)
    crow = bargs[2][:, 1:].contiguous()
    got = tbk.banded_traceback_cuda(moves, crow, ei, ej, W)
    want = tbk.banded_traceback_plain(moves, crow, ei, ej, W)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] != 0).sum()) > 1000


def _wavefront_inputs(W, sizes, dev):
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import wavefront as wf
    tasks = tasks_np(31, sizes, drift=True)
    n_acts = np.array([len(t[0]) for t in tasks], np.int32)
    m_acts = np.array([len(t[1]) for t in tasks], np.int32)
    q = np.zeros((len(tasks), n_acts.max()), np.int8)
    r = np.zeros((len(tasks), m_acts.max()), np.int8)
    c_rows = []
    for b, (tq, tr, cr, cf) in enumerate(tasks):
        q[b, :len(tq)] = tq
        r[b, :len(tr)] = tr
        c_rows.append(bo.build_corridor(cr, cf, len(tq), len(tr), W))
    staged = wf._prepare(q, r, c_rows, n_acts, m_acts, W)
    args = [torch.from_numpy(x).to(dev) for x in staged[:4]]
    return (q, r, c_rows, n_acts, m_acts), args, dict(W=W, Wcap=staged[6],
                                                      a_lo=staged[4])


@pytest.mark.parametrize('W', [128, 512, 1024, 2048, 4096, 16384])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_wavefront_bit_equal_to_plain(cfg, W):
    """The per-task wavefront forward against its plain version on
    drifting corridors (short tasks at the wide bands); the entry's ends
    on the card equal the CPU's up to W 4096."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import wavefront as wf
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    scoring, config = Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg])
    sizes = [300, 900, 640, 1200, 150] if W <= 2048 else [200, 260, 150]
    host, args, kw = _wavefront_inputs(W, sizes, dev)
    kw.update(scoring=scoring, config=config)
    got = wf.wavefront_forward_cuda(*args, **kw)
    for g, w in zip(got, wf.wavefront_forward_plain(*args, **kw)):
        assert torch.equal(g, w)
    assert int((got[0] > wf.NEG).sum()) > 0
    if W <= 4096:
        got = wf.wavefront_batch_corridor(*host, scoring, config, W,
                                          device=dev)
        want = wf.wavefront_batch_corridor(*host, scoring, config, W,
                                           device='cpu')
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('plan', [(1, 11, 1, False), (2, 6, 1, False),
                                  (4, 3, 1, False), (8, 2, 1, False),
                                  (1, 2, 6, False), (2, 3, 2, True),
                                  (1, 1, 11, True)],
                         ids=lambda p: 'C%d_NW%d_L%d%s' % (p[0], p[1], p[2],
                                                          '_global' * p[3]))
def test_gpu_wavefront_launch_shapes(plan):
    """Every launch shape of kernel 7 (cluster size, warps a block,
    segments a warp, carries in shared or global memory) gives the plain
    version's outputs at W 2048."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import wavefront as wf
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    kw = dict(scoring=Scoring(*SCORING_T),
              config=AlignConfig(*CONFIGS['semi']))
    _, args, shape = _wavefront_inputs(2048, [700, 1300, 400], dev)
    kw.update(shape)
    want = wf.wavefront_forward_plain(*args, **kw)
    got = wf.wavefront_forward_cuda(*args, plan=plan, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize('band', [40, 200])
def test_gpu_align_banded_retries_walk_on_the_card(band, monkeypatch):
    """align_banded on FULLY_GLOBAL tasks with zigzag corridors sends the
    tasks the wave route cannot align to the retry path, which walks them
    on the card; the results equal the host-decode retry path's. In the
    JAX package's layout (several tasks a track), where a NEG task's walk
    also overwrites a neighbour's records, the retried neighbours are
    walked on the card into CIGARs that re-tally, and the results equal
    the card layout's."""
    import functools
    dev = _cuda()
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import wavetape as tw
    from unicycler_tpu_torch.ops.pairwise import FULLY_GLOBAL, Scoring
    from unicycler_tpu_torch.utils import trace
    tasks = [bo.BandedTask(*t) for t in zigzag_tasks(5)]
    inner = bo._align_banded_moves_path
    retried = []

    def observed(task_list, *a, **kw):
        out = inner(task_list, *a, **kw)
        retried.extend(out)
        return out

    call = lambda: bo.align_banded(tasks, Scoring(*SCORING_T), FULLY_GLOBAL,
                                   band, True, device=dev)
    monkeypatch.setattr(bo, '_align_banded_moves_path', observed)
    trace.reset()
    trace.enable()
    cuda_lib.reset_launches()
    try:
        got = call()
        walked = trace.as_dict()['counters'].get('retry.device_walk', 0)
        monkeypatch.setattr(tw, 'build_wave_launches',
                            lambda t, W, corridor, budget:
                            tw.build_wavetapes(t, W, corridor))
        del retried[:]
        got_jax = call()
        monkeypatch.setattr(bo, '_align_banded_moves_path', functools.partial(
            inner, device_walk=False))
        want = call()
    finally:
        trace.disable()
    if band == 40:
        assert walked > 0 and cuda_lib.LAUNCHES['banded_walk'] > 0
        assert sum(1 for p in retried if p.cigar) > 0
    assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
    assert [pa_key(p) for p in got_jax] == [pa_key(p) for p in want]
    for t, pa in zip(tasks, got):
        if pa.cigar:
            assert retally(t.q, t.r, pa) == pa.score


def test_gpu_cli_matches_cpu_route(tmp_path):
    """The command line (pipeline.main.main, a long-read-only run) on the
    card writes the same assembly.gfa and assembly.fasta as on the CPU
    route, on the 12 kbp genome of tests/test_torch_pipeline.py (reads of
    5,000 bp every 300 bp, alternate strands)."""
    dev = _cuda()
    from unicycler_tpu_torch.misc import reverse_complement
    from unicycler_tpu_torch.pipeline.main import main
    rng = random.Random(77)
    genome = ''.join(rng.choice('ACGT') for _ in range(12000))
    ext = genome + genome[:5000]
    reads = tmp_path / 'long.fastq'
    with open(reads, 'w') as f:
        for k, i in enumerate(range(0, len(genome), 300), 1):
            seq = ext[i:i + 5000]
            seq = reverse_complement(seq) if k % 2 == 0 else seq
            f.write('@fake_long_%d\n%s\n+\n%s\n' % (k, seq, 'I' * len(seq)))
    argv = ['-l', str(reads), '--verbosity', '0', '--keep', '0']
    main(argv + ['-o', str(tmp_path / 'gpu')], device=dev)
    main(argv + ['-o', str(tmp_path / 'cpu')], device='cpu')
    for name in ('assembly.gfa', 'assembly.fasta'):
        got = (tmp_path / 'gpu' / name).read_bytes()
        assert got == (tmp_path / 'cpu' / name).read_bytes(), name
        assert len(got) > 10000


def test_gpu_hybrid_cli_matches_cpu_route(tmp_path):
    """The command line's hybrid run (`--short_read_graph G.gfa -l
    long.fastq`) on the card writes the same assembly.gfa and
    assembly.fasta as on the CPU route, on a ~100 kbp synth.repeat_genome
    (5 planted copies, its collapsed overlap-0 GFA as the short-read graph,
    6 reads of the slice's error model around each copy)."""
    dev = _cuda()
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.pipeline.main import main
    rng = np.random.default_rng(8)
    chrom, gfa, copies = synth.repeat_genome(
        rng, [15000] * 6, [(2500, 3, 250), (1200, 2, 0)])
    graph = tmp_path / 'short_read_graph.gfa'
    graph.write_text(gfa)
    sim = synth.reads_around(rng, chrom, copies, 6, n50=9000)
    reads = tmp_path / 'long.fastq'
    reads.write_text(''.join('@%s\n%s\n+\n%s\n' % (n, s, ',' * len(s))
                             for n, s, _ in sim))
    argv = ['--short_read_graph', str(graph), '-l', str(reads),
            '--verbosity', '0', '--keep', '0']
    main(argv + ['-o', str(tmp_path / 'gpu')], device=dev)
    main(argv + ['-o', str(tmp_path / 'cpu')], device='cpu')
    for name in ('assembly.gfa', 'assembly.fasta'):
        got = (tmp_path / 'gpu' / name).read_bytes()
        assert got == (tmp_path / 'cpu' / name).read_bytes(), name
        assert len(got) > 90000


def _write_pairs(tmp_path, pairs_1, pairs_2):
    argv = []
    for flag, pairs in (('-1', pairs_1), ('-2', pairs_2)):
        path = tmp_path / (flag[1] + '.fastq')
        path.write_text(''.join('@%s\n%s\n+\n%s\n' % p for p in pairs))
        argv += [flag, str(path)]
    return argv


def _card_and_cpu(tmp_path, argv, min_bytes):
    """main on the card (traced) and on the CPU route; the outputs must be
    byte-equal. Returns the card run's spans."""
    from unicycler_tpu_torch.pipeline.main import main
    from unicycler_tpu_torch.utils import trace
    dev = _cuda()
    argv = argv + ['--verbosity', '0', '--keep', '0']
    trace.reset()
    trace.enable()
    try:
        main(argv + ['-o', str(tmp_path / 'gpu')], device=dev)
    finally:
        trace.disable()
    spans = trace.as_dict()['spans']
    main(argv + ['-o', str(tmp_path / 'cpu')], device='cpu')
    for name in ('assembly.gfa', 'assembly.fasta'):
        got = (tmp_path / 'gpu' / name).read_bytes()
        assert got == (tmp_path / 'cpu' / name).read_bytes(), name
        assert len(got) > min_bytes
    return spans


def test_gpu_shortread_cli_matches_cpu_route(tmp_path):
    """Unicycler's default command line (`-1 R1 -2 R2 -l long.fastq`) on
    the card writes the same assembly.gfa and assembly.fasta as on the
    CPU route, on a ~30 kbp circular synth.repeat_genome (6 planted
    copies) with 2 x 150 bp pairs at 40x (synth.short_read_pairs) and long
    reads at 8x."""
    _cuda()
    from unicycler_tpu_torch import synth
    rng = np.random.default_rng(12)
    chrom, _, _ = synth.repeat_genome(rng, [3600] * 7,
                                      [(1500, 2, 250), (700, 4, 0)])
    argv = _write_pairs(tmp_path, *synth.short_read_pairs(rng, [chrom], 40))
    sim = synth.simulate_read_set(rng, [chrom], 8, n50=9000)
    path = tmp_path / 'long.fastq'
    path.write_text(''.join('@%s\n%s\n+\n%s\n' % (n, s, ',' * len(s))
                            for n, s, _ in sim))
    spans = _card_and_cpu(tmp_path, argv + ['-l', str(path)], 25000)
    assert 'short_read_graph/correct_reads' in spans
    assert 'long_read_bridges' in spans


def test_gpu_shortread_pairs_polish_matches_cpu_route(tmp_path):
    """`-1 R1 -2 R2` alone on the 8 kbp genome of the JAX package's
    short-read test (perfect pairs tiled at every position): the graph's
    own bridges are applied, so the final short-read polish runs, its
    16,000 reads aligned on the card; byte-equal to the CPU route."""
    _cuda()
    from unicycler_tpu_torch.pipeline.fake_reads import make_fake_short_reads
    rng = random.Random(42)
    genome = ''.join(rng.choice('ACGT') for _ in range(8000))
    argv = _write_pairs(tmp_path, *make_fake_short_reads(genome))
    spans = _card_and_cpu(tmp_path, argv + ['--min_fasta_length', '100'],
                          7000)
    assert 'final_polish/align_banded' in spans


@pytest.mark.parametrize('k', [21, 31])
def test_gpu_kmer_count_matches_np_unique(k):
    """kmer_count.count_spectrum on the card over ~10 M k-mers of reads
    from a 2 Mbp random genome, and count_canonical_device over keys up to
    the top of k = 31's 62 bits (and of the 64-bit word), equal to
    np.unique array for array."""
    dev = _cuda()
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.asm import correct
    from unicycler_tpu_torch.io.fastx import encode_sequence
    from unicycler_tpu_torch.ops import kmer_count
    rng = np.random.default_rng(k)
    genome = synth.random_replicons(rng, [2_000_000])[0]
    starts = rng.integers(0, len(genome) - 150, 80_000)
    reads = [encode_sequence(genome[s:s + 150]) for s in starts.tolist()]
    got_k, got_c = kmer_count.count_spectrum(reads, k, device=dev)
    want_k, want_c = correct.count_spectrum(reads, k)
    assert want_c.sum() > 9_000_000
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)
    assert (got_k >> np.uint64(2 * k - 2) == 3).any()
    keys = np.concatenate([
        rng.integers(0, 1 << 62, 1_000_000, dtype=np.uint64),
        (np.uint64(3) << np.uint64(60)) + rng.integers(0, 1000, 50_000,
                                                       dtype=np.uint64),
        np.full(7, (1 << 64) - 1, np.uint64)])
    got_k, got_c = kmer_count.count_canonical_device([keys], 31, device=dev)
    want_k, want_c = np.unique(keys, return_counts=True)
    assert np.array_equal(got_k, want_k) and np.array_equal(got_c, want_c)


def _multi_against_single(devices, W, cfg, tasks):
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    bt = [bo.BandedTask(*t) for t in tasks]
    args = (Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), W, True)
    got = bo.align_banded_multi(bt, *args, devices)
    want = bo.align_banded_tape(bt, *args, device=devices[0])
    return [pa_key(p) for p in got], [pa_key(p) for p in want]


@pytest.mark.parametrize('W', [512, 4096])
@pytest.mark.parametrize('cfg', ['semi', 'global'])
def test_gpu_align_banded_multi_on_one_card_twice(cfg, W):
    """A mesh naming the one card twice: two partitions queued on it, per
    task equal to one device's tape route (retries included)."""
    dev = torch.device('cuda', _cuda().index or 0)
    tasks = tasks_np(12, [60, 120, 200, 330, 90, 170, 250, 140], True) \
        + zigzag_tasks(5, 8)
    got, want = _multi_against_single([dev, dev], W, cfg, tasks)
    assert got == want


@pytest.mark.parametrize('W', [512, 4096])
def test_gpu_align_banded_multi_over_every_card(W):
    """One partition a card: each launch (and its occupancy and cluster
    queries) must run on its tensors' card, not the current one."""
    _cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip('needs two or more CUDA devices')
    devices = [torch.device('cuda', i) for i in range(n)]
    tasks = tasks_np(13, [80, 160, 240, 320, 400, 120, 200, 280] * n, True)
    got, want = _multi_against_single(devices, W, 'semi', tasks)
    assert got == want


def _full_dp_pairs(shape):
    """Code-array pairs of one full-matrix DP probe shape (chip_smoke.py
    phase 6): a 1,300 bp repeat's consensus, 100-2,000 bp mixed in one
    call, empty sides beside a real pair, and the two widest pairs
    dispatch.batch_align sends to the full DP (2^24 bucketed cells)."""
    from unicycler_tpu_torch import synth
    rng = np.random.default_rng(31)
    if shape == 'consensus':
        pairs = synth.banded_tasks(rng, [1300] * 12)
        return [p[0] for p in pairs], [p[1] for p in pairs]
    sizes = {'mixed': [(int(x), int(x * rng.uniform(0.9, 1.1)))
                       for x in rng.integers(100, 2000, 12)],
             'empty': [(0, 500), (500, 0), (0, 0), (300, 320)],
             'tall': [(131072, 128), (131000, 120)],
             'wide': [(128, 131072), (120, 131000)]}[shape]
    return synth.sized_pairs(rng, sizes)


@pytest.mark.parametrize('shape,band', [
    ('consensus', None), ('consensus', 20), ('consensus', 1000),
    ('mixed', None), ('mixed', 20), ('empty', None), ('empty', 20),
    ('wide', None), ('wide', 20), ('tall', None)])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_full_dp_bit_equal_to_plain(cfg, shape, band):
    """csrc/pairwise.cu against align_batch_plain: score and ends
    bit-equal, moves on each pair's real region [0, n_act) x [0, m_act];
    without moves the same score and ends. The tall shape's plain version
    runs on the CPU (its 131,072-row loop of small ops is faster there)."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.encode import pack_pairs
    qs, rs = _full_dp_pairs(shape)
    host = list(pack_pairs(qs, rs, max(max(len(q) for q in qs), 1),
                           max(max(len(r) for r in rs), 1)))
    if band is not None:
        diffs = host[3].astype(np.int64) - host[1].astype(np.int64)
        host += [(-band - np.maximum(0, diffs)).astype(np.int32),
                 (band + np.maximum(0, -diffs)).astype(np.int32)]
    up = [torch.from_numpy(x).to(dev) for x in host]
    args = (pw.Scoring(*SCORING_T), pw.AlignConfig(*CONFIGS[cfg]))
    before = cuda_lib.LAUNCHES['pairwise']
    got = pw.align_batch_device(*up[:4], *args, True, *up[4:])
    bare = pw.align_batch_device(*up[:4], *args, False, *up[4:])
    assert cuda_lib.LAUNCHES['pairwise'] == before + 2
    pdev = 'cpu' if shape == 'tall' else dev
    want = pw.align_batch_plain(*(x.to(pdev) for x in up[:4]), *args, True,
                                *(x.to(pdev) for x in up[4:]))
    for g, n, w in zip(got[:3], bare[:3], want[:3]):
        assert torch.equal(g.cpu(), w.cpu()) and torch.equal(n, g)
    assert bare[3] is None
    km, pm = got[3].cpu(), want[3].cpu()
    for b, (q, r) in enumerate(zip(qs, rs)):
        assert torch.equal(km[b, :len(q), :len(r) + 1],
                           pm[b, :len(q), :len(r) + 1]), b


@pytest.mark.parametrize('shape,band', [
    ('consensus', None), ('consensus', 20), ('mixed', None), ('mixed', 1000),
    ('empty', None), ('wide', None), ('tall', None)])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_full_dp_walker_equal_to_plain(cfg, shape, band):
    """csrc/pairwise_walk.cu over the forward kernel's outputs against
    walk_full_plain (the host decode) on the same inputs: every pair's
    header (score, ends, run count, starts) and runs equal."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.encode import pack_pairs
    qs, rs = _full_dp_pairs(shape)
    host = list(pack_pairs(qs, rs, max(max(len(q) for q in qs), 1),
                           max(max(len(r) for r in rs), 1)))
    if band is not None:
        diffs = host[3].astype(np.int64) - host[1].astype(np.int64)
        host += [(-band - np.maximum(0, diffs)).astype(np.int32),
                 (band + np.maximum(0, -diffs)).astype(np.int32)]
    up = [torch.from_numpy(x).to(dev) for x in host]
    config = pw.AlignConfig(*CONFIGS[cfg])
    score, end_i, end_j, moves = pw.align_batch_device(
        *up[:4], pw.Scoring(*SCORING_T), config, True, *up[4:])
    before = cuda_lib.LAUNCHES['pairwise_walk']
    got = pw.walk_full_cuda(moves, score, end_i, end_j, config)
    assert cuda_lib.LAUNCHES['pairwise_walk'] == before + 1
    want = pw.walk_full_plain(moves, score, end_i, end_j, config)
    assert got.shape == want.shape and got.device == want.device
    assert pw.walk_records(got) == pw.walk_records(want)


@pytest.mark.parametrize('band', [None, 20])
@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_align_pairs_matches_cpu_route(cfg, band):
    """align_pairs on the card (forward and walk on the card, one fetch of
    the runs) gives the CPU route's PairAlignments, cigars as the same
    lists, and copies no moves to the host."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.utils import trace
    qs, rs = _full_dp_pairs('mixed')
    args = (pw.Scoring(*SCORING_T), pw.AlignConfig(*CONFIGS[cfg]))
    cuda_lib.reset_launches()
    trace.reset()
    trace.enable()
    try:
        got = pw.align_pairs(qs, rs, *args, band=band, device=dev)
    finally:
        trace.disable()
    fetched = trace.as_dict()['counters']['full_dp.fetch_bytes']
    trace.reset()
    assert cuda_lib.LAUNCHES['pairwise'] == 1
    assert cuda_lib.LAUNCHES['pairwise_walk'] == 1
    want = pw.align_pairs(qs, rs, *args, band=band, device='cpu')
    assert got == want
    assert all(type(g.cigar) is list for g in got)
    n_pad, m_pad = max(len(q) for q in qs), max(len(r) for r in rs)
    assert fetched == 4 * len(qs) * (pw.WALK_HEAD
                                     + 2 * pw.walk_ops(n_pad, m_pad))
    assert fetched < 0.05 * len(qs) * n_pad * (m_pad + 1)
    bare = pw.align_pairs(qs, rs, *args, need_cigar=False, band=band,
                          device=dev)
    assert cuda_lib.LAUNCHES['pairwise_walk'] == 1
    assert [(p.score, p.s1_end, p.s2_end) for p in bare] == \
        [(p.score, p.s1_end, p.s2_end) for p in want]


def test_gpu_align_pairs_from_eight_threads_matches_serial():
    """Bridging finalises up to 8 bridges on threads, each launching the
    full-matrix DP on the caller's stream: the same calls from 8 threads
    at once give the serial results."""
    from concurrent.futures import ThreadPoolExecutor
    dev = _cuda()
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    rng = np.random.default_rng(17)
    calls = []
    for k in range(16):
        pairs = synth.banded_tasks(rng, [int(x) for x in
                                         rng.integers(200, 1500, 4)])
        calls.append(([p[0] for p in pairs], [p[1] for p in pairs],
                      sorted(CONFIGS)[k % len(CONFIGS)]))

    def run(call):
        qs, rs, cfg = call
        return [pa_key(p) for p in pw.align_pairs(
            qs, rs, pw.Scoring(*SCORING_T), pw.AlignConfig(*CONFIGS[cfg]),
            device=dev)]

    serial = [run(c) for c in calls]
    before = cuda_lib.LAUNCHES['pairwise']
    with ThreadPoolExecutor(8) as pool:
        threaded = list(pool.map(run, calls))
    assert threaded == serial
    assert cuda_lib.LAUNCHES['pairwise'] > before


@pytest.mark.parametrize('cfg', sorted(CONFIGS))
def test_gpu_batch_align_full_route_matches_cpu(cfg):
    """dispatch.batch_align with every pair under MAX_FULL_DP_CELLS: the
    full-matrix route on the card (csrc/pairwise.cu) equals its CPU route,
    with and without CIGARs."""
    dev = _cuda()
    from unicycler_tpu_torch.ops import cuda_lib, dispatch
    from unicycler_tpu_torch.ops.pairwise import AlignConfig, Scoring
    qs, rs = _full_dp_pairs('mixed')
    for need_cigar in (True, False):
        args = (Scoring(*SCORING_T), AlignConfig(*CONFIGS[cfg]), 1000,
                need_cigar)
        cuda_lib.reset_launches()
        got = dispatch.batch_align(qs, rs, *args, device=dev)
        assert cuda_lib.LAUNCHES['pairwise'] == 1
        assert cuda_lib.LAUNCHES['tape_fwd'] == 0
        want = dispatch.batch_align(qs, rs, *args, device='cpu')
        assert [pa_key(p) for p in got] == [pa_key(p) for p in want]
