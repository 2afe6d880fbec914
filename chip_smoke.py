#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicycler_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py [--seed 0] [--reads 200]

Phases (every failed check raises, so the exit code is nonzero):
  1. device: the card's name and power limit;
  2. build: nvcc builds the kernels of csrc/ (build seconds and the
     -Xptxas -v register / shared-memory lines);
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the main path's widths (W = 512 and 1024, 8 and 32 tracks),
     with shortened tasks; outputs must be bit-equal; CUDA-event times;
  4. the slice: align_jobs on a synthetic 5 Mbp chromosome + 100 kbp
     plasmid with 200 long reads (N50 ~15 kb, ~8% errors) at sensitivity 0
     plus 20 reads at sensitivity 2; checks true placement and that every
     CIGAR re-tallies to its raw score; counts kernel launches;
  5. the retry path: _align_banded_moves_path on the card against the CPU
     route, counting the banded kernel's launches;
  6. summary: one {"kernels": [...]} line, then the card's line.

Prints nothing of the result and exits nonzero without a CUDA device or
without the package beside this script. Details go to
chiprun_out/chip_smoke.json.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the 67 TFLOP/s
# fp32 CUDA-core rate as the ceiling for the kernels' scalar int32 work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# int32 operations per DP cell / walker step, counted from the kernels'
# inner loops (loads and stores excluded)
OPS_PER_CELL_WAVE = 45
OPS_PER_STEP_WALK = 30
OPS_PER_CELL_BANDED = 45


def log(msg=''):
    print(msg, flush=True)


def bound_ms(n_bytes, n_ops):
    return 1e3 * max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_OPS_S)


def cuda_time(fn, reps=1):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def exact(name, a, b):
    """Max |a - b| over int arrays; raises unless shapes match and a == b."""
    import torch
    if a.shape != b.shape:
        raise AssertionError('%s: shape %s vs %s' % (name, tuple(a.shape),
                                                     tuple(b.shape)))
    err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0
    if err != 0:
        raise AssertionError('%s: kernel and plain version differ '
                             '(max |diff| %d)' % (name, err))
    return err


def walk_steps(records):
    """Path steps a walk took, from its records: one per M record, a run
    record op | len << 2 stands for len steps."""
    import torch
    rec = records.to(torch.int64)
    return int((rec == 1).sum()) + int((rec[rec >= 6] >> 2).sum())


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('error: no CUDA device')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log('== phase 1: device')
    log('torch %s, CUDA %s, %d device(s): %s'
        % (torch.__version__, torch.version.cuda, torch.cuda.device_count(),
           name))
    return name, smi[0]


def phase_build():
    from unicycler_tpu_torch.ops import cuda_lib
    log('== phase 2: build')
    t0 = time.time()
    path = cuda_lib.build()
    cuda_lib.lib()
    secs = time.time() - t0
    log('built %s in %.1f s' % (os.path.relpath(path, HERE), secs))
    with open(os.path.join(os.path.dirname(path), 'ptxas.log')) as f:
        ptxas = f.read()
    for line in ptxas.splitlines():
        if 'Compiling entry' in line or 'registers' in line \
                or line.startswith('=='):
            log('  ' + line.strip())
    return secs


def phase_kernels(rng, dev, results):
    """Each kernel against its plain version on the card."""
    import torch
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import wavetape_kernels as wk
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    from unicycler_tpu_torch.ops.wavetape import (G, build_wavetapes,
                                                  forward_inputs)

    log('== phase 3: kernels against their plain versions')
    scoring = Scoring(3, -6, -5, -2)
    config = SEMI_GLOBAL
    for W, bt, size in ((512, 8, 1500), (512, 32, 1500), (1024, 8, 1200),
                        (1024, 32, 1200)):
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, [size] * bt, drift=True)]
        tp = build_wavetapes(tasks, W, bo.build_corridor, bt=bt)[0]
        up = [torch.from_numpy(x).to(dev) for x in forward_inputs(tp)]
        q, r = up[0], up[1]
        plane, dbase_g = wk.group_plane(*up[2:11], q.shape[1], r.shape[1], W)
        fwd = lambda: wk.wavetape_forward_cuda(q, r, plane, scoring, config,
                                               W, True)
        fwd()
        ms, (mv_k, best_k) = cuda_time(fwd, reps=5)
        plain_ms, (mv_p, best_p) = cuda_time(
            lambda: wk.wavetape_forward_plain(q, r, plane, scoring, config,
                                              W, True))
        err = max(exact('wavetape_fwd moves', mv_k, mv_p),
                  exact('wavetape_fwd best', best_k, best_p))
        B, NG = plane.shape[:2]
        cells = B * NG * G * W
        nbytes = sum(x.numel() * x.element_size()
                     for x in (q, r, plane, mv_k, best_k))
        results.append({'name': 'wavetape_fwd', 'W': W, 'bt': bt,
                        'ms': ms, 'plain_ms': plain_ms,
                        'bound_ms': bound_ms(nbytes,
                                             cells * OPS_PER_CELL_WAVE),
                        'bytes': nbytes, 'cells': cells,
                        'max_abs_err': err})

        score, ei, ej, _, db_rows = wk.wavetape_forward(
            *up, scoring=scoring, config=config, W=W, need_moves=False)
        valid = up[4] > 0
        zero = torch.zeros_like(ei)
        wargs = [x.to(torch.int32).contiguous() for x in
                 (mv_k, db_rows, torch.from_numpy(tp.n_tasks).to(dev),
                  torch.where(valid, ei, zero), torch.where(valid, ej, zero),
                  torch.where(valid, torch.from_numpy(tp.abase).to(dev),
                              zero))]
        walk = lambda: wk.wavetape_traceback_cuda(*wargs, W)
        walk()
        wms, (rec_k, fin_k) = cuda_time(walk, reps=3)
        wplain_ms, (rec_p, fin_p) = cuda_time(
            lambda: wk.wavetape_traceback_plain(*wargs, W))
        werr = max(exact('wavetape_walk records', rec_k, rec_p),
                   exact('wavetape_walk fin', fin_k, fin_p))
        steps = walk_steps(rec_k)
        wbytes = steps * 8 + int((rec_k != 0).sum()) * 4 \
            + fin_k.numel() * 4
        results.append({'name': 'wavetape_walk', 'W': W, 'bt': bt,
                        'ms': wms, 'plain_ms': wplain_ms,
                        'bound_ms': bound_ms(wbytes,
                                             steps * OPS_PER_STEP_WALK),
                        'bytes': wbytes, 'steps': steps,
                        'max_abs_err': werr})
        log('W=%4d bt=%2d  fwd %.3f ms (plain %.0f ms)  walk %.3f ms '
            '(plain %.0f ms, %d steps)  bit-equal'
            % (W, bt, ms, plain_ms, wms, wplain_ms, steps))

    for W, size in ((512, 1500), (1024, 1200)):
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, [size] * bk.BT, drift=True)]
        idxs = list(range(len(tasks)))
        n_pad = bo.bucket_length(max(len(t.q) for t in tasks))
        m_pad = bo.bucket_length(max(len(t.r) for t in tasks))
        host = bo._pack_bucket(tasks, idxs, n_pad, m_pad, W, bk.BT)
        args = [torch.from_numpy(x).to(dev) for x in host]
        run = lambda: bk.banded_batch_cuda(*args, scoring, config, W, True)
        run()
        ms, out_k = cuda_time(run, reps=3)
        plain_ms, out_p = cuda_time(
            lambda: bk.banded_batch_plain(*args, scoring, config, W, True))
        err = max(exact('banded ' + n, a, b) for n, a, b in
                  zip(('score', 'end_i', 'end_j', 'moves'), out_k, out_p))
        cells = bk.BT * n_pad * W
        nbytes = sum(x.numel() * x.element_size() for x in args) \
            + sum(x.numel() * x.element_size() for x in out_k)
        results.append({'name': 'banded', 'W': W, 'bt': bk.BT, 'ms': ms,
                        'plain_ms': plain_ms,
                        'bound_ms': bound_ms(nbytes,
                                             cells * OPS_PER_CELL_BANDED),
                        'bytes': nbytes, 'cells': cells,
                        'max_abs_err': err})
        log('W=%4d B=%2d n_pad=%d  banded %.3f ms (plain %.0f ms)  bit-equal'
            % (W, bk.BT, n_pad, ms, plain_ms))


def _load_genome(args):
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.io.fastx import Read, Reference
    rng = __import__('numpy').random.default_rng(args.seed)
    reps = synth.random_replicons(rng, [5_000_000, 100_000])
    sim = synth.simulate_reads(rng, reps, args.reads)
    refs = [Reference('chromosome', reps[0]), Reference('plasmid', reps[1])]
    return refs, sim, Read


def phase_slice(args, dev, report):
    import torch
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import AlignJob, align_jobs
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.wavetape import G
    from unicycler_tpu_torch.utils import trace

    log('== phase 4: the slice (align_jobs on %s)' % dev)
    t0 = time.time()
    refs, sim, Read = _load_genome(args)
    reads0 = [Read(n, s, None) for n, s, _ in sim]
    n_sens2 = min(20, len(sim))
    reads2 = [Read(n, s, None) for n, s, _ in sim[:n_sens2]]
    lens = sorted((len(s) for _, s, _ in sim), reverse=True)
    half, acc, n50 = sum(lens) / 2, 0, 0
    for length in lens:
        acc += length
        if acc >= half:
            n50 = length
            break
    log('genome %s bp, %d reads, %d bp, N50 %d (set-up %.1f s)'
        % ('+'.join(str(r.get_length()) for r in refs), len(sim), sum(lens),
           n50, time.time() - t0))
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    jobs = [AlignJob(reads0, refs, scheme, sensitivity_level=0),
            AlignJob(reads2, refs, scheme, sensitivity_level=2)]
    random.seed(args.seed)
    trace.reset()
    trace.enable()
    cuda_lib.TIMINGS = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.time()
    align_jobs(jobs, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    timings, cuda_lib.TIMINGS = cuda_lib.TIMINGS, None
    trace.disable()
    peak = torch.cuda.max_memory_allocated()

    per_kernel = {}
    cells = 0
    for name, ev0, ev1, outs in timings:
        agg = per_kernel.setdefault(name, {'ms': 0.0, 'bytes': 0, 'ops': 0})
        agg['ms'] += ev0.elapsed_time(ev1)
        if name == 'wavetape_fwd':
            q, r, plane, moves, best = outs
            B, NG = plane.shape[:2]
            W = moves.shape[2]
            c = B * NG * G * W
            cells += c
            agg['ops'] += c * OPS_PER_CELL_WAVE
            agg['bytes'] += sum(x.numel() * x.element_size()
                                for x in (q, r, plane, moves, best))
        elif name == 'wavetape_walk':
            records, fin = outs
            steps = walk_steps(records)
            agg['ops'] += steps * OPS_PER_STEP_WALK
            agg['bytes'] += steps * 8 + int((records != 0).sum()) * 4 \
                + fin.numel() * 4
    for agg in per_kernel.values():
        agg['bound_ms'] = bound_ms(agg['bytes'], agg['ops'])

    # checks: placement of each read's best alignment, CIGAR tallies
    placed, tally_bad, n_aln = 0, 0, 0
    for read, (_, _, truth) in zip(reads0, sim):
        for a in read.alignments:
            n_aln += 1
            if a.raw_score != a._pair.score:
                tally_bad += 1
        if not read.alignments:
            continue
        best = max(read.alignments, key=lambda a: a.raw_score)
        if best.ref is refs[truth.replicon] \
                and bool(best.rev_comp) == truth.rev_comp \
                and abs(best.ref_start_pos - truth.start) <= 100:
            placed += 1
    for read in reads2:
        for a in read.alignments:
            n_aln += 1
            if a.raw_score != a._pair.score:
                tally_bad += 1
    frac = placed / len(reads0)
    n_reads = len(reads0) + len(reads2)
    log('align_jobs: %.2f s wall, %.2f reads/s, %.3g DP cells/s of wall '
        '(%d cells), peak device memory %.1f MiB'
        % (wall, n_reads / wall, cells / wall, cells, peak / 2 ** 20))
    log('kernel launches: %s' % json.dumps(launches))
    for name, agg in sorted(per_kernel.items()):
        log('  %s: %.2f ms device time over %d launches (bound %.3f ms)'
            % (name, agg['ms'], launches[name], agg['bound_ms']))
    log('placement: %d/%d best alignments on the true replicon and strand '
        'within 100 bp (%.1f%%); %d alignments, %d CIGAR tally mismatches'
        % (placed, len(reads0), 100 * frac, n_aln, tally_bad))
    spans = trace.as_dict()['spans']
    log('host spans (s): %s' % json.dumps(
        {k: v['seconds'] for k, v in spans.items()}))
    counters = trace.as_dict()['counters']
    log('trace counters: %s' % json.dumps(
        {k: v for k, v in sorted(counters.items())
         if k.startswith(('wave.', 'tape.'))}))
    if launches['wavetape_fwd'] <= 0 or launches['wavetape_walk'] <= 0:
        raise AssertionError('the slice did not go through the wave kernels')
    if frac < 0.95:
        raise AssertionError('only %.1f%% of reads placed correctly'
                             % (100 * frac))
    if tally_bad:
        raise AssertionError('%d CIGARs do not re-tally to their score'
                             % tally_bad)
    report.update({'wall_s': wall, 'reads': n_reads, 'reads_per_s':
                   n_reads / wall, 'cells': cells, 'cells_per_s':
                   cells / wall, 'peak_bytes': peak, 'placed_fraction': frac,
                   'alignments': n_aln, 'launches': launches,
                   'per_kernel': per_kernel, 'n50': n50, 'spans': spans,
                   'counters': counters})
    return launches, per_kernel


def phase_small_reference(dev):
    """The wave route on the card against the same route on the CPU (the
    kernels' plain versions) on a few small tasks."""
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    import numpy as np
    rng = np.random.default_rng(5)
    tasks = [bo.BandedTask(*t) for t in
             synth.banded_tasks(rng, [300, 900, 1700, 2500], drift=True)]
    scoring = Scoring(3, -6, -5, -2)
    got = bo.align_banded_tape(tasks, scoring, SEMI_GLOBAL, 512, True,
                               device=dev)
    want = bo.align_banded_tape(tasks, scoring, SEMI_GLOBAL, 512, True,
                                device='cpu')
    for g, w in zip(got, want):
        if g != w:
            raise AssertionError('wave route differs from the CPU route: '
                                 '%r vs %r' % (g[:5], w[:5]))
    log('small reference: %d tasks, wave route on the card == CPU route'
        % len(tasks))


def phase_retry(args, dev, report):
    import torch
    import numpy as np
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring

    log('== phase 5: retry path (_align_banded_moves_path)')
    rng = np.random.default_rng(args.seed + 1)
    tasks = [bo.BandedTask(*t) for t in
             synth.banded_tasks(rng, [3000, 2600, 3400, 1800, 2200, 3100,
                                      900, 2900], drift=True)]
    scoring = Scoring(3, -6, -5, -2)
    cuda_lib.reset_launches()
    t0 = time.time()
    got = bo._align_banded_moves_path(tasks, scoring, SEMI_GLOBAL, 512,
                                      True, device=dev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = cuda_lib.LAUNCHES['banded']
    want = bo._align_banded_moves_path(tasks, scoring, SEMI_GLOBAL, 512,
                                       True, device='cpu')
    for g, w in zip(got, want):
        if g != w:
            raise AssertionError('retry path differs from the CPU route')
    log('retry path: %d tasks, %d banded launches, %.2f s, equal to the '
        'CPU route' % (len(tasks), launches, wall))
    if launches <= 0:
        raise AssertionError('the retry path did not launch the banded '
                             'kernel')
    report['retry'] = {'tasks': len(tasks), 'launches': launches,
                       'wall_s': wall}
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reads', type=int, default=200)
    ap.add_argument('--out', default=os.path.join(HERE, 'chiprun_out',
                                                  'chip_smoke.json'))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('error: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import unicycler_tpu_torch  # noqa: F401
    except ImportError as exc:
        print('error: unicycler_tpu_torch not found beside chip_smoke.py '
              '(%s)' % exc, file=sys.stderr)
        return 2
    import numpy as np
    assert 'jax' not in sys.modules

    name, smi_line = phase_device()
    dev = torch.device('cuda', 0)
    report = {'device': name, 'nvidia_smi': smi_line}
    report['build_s'] = phase_build()
    kres = []
    phase_kernels(np.random.default_rng(args.seed), dev, kres)
    launches, per_kernel = phase_slice(args, dev, report)
    phase_small_reference(dev)
    retry_launches = phase_retry(args, dev, report)
    assert 'jax' not in sys.modules

    sources = {'wavetape_fwd': ('unicycler_tpu_torch/csrc/wavetape_fwd.cu',
                                'unicycler_tpu/ops/pallas_wavetape.py:430'),
               'wavetape_walk': ('unicycler_tpu_torch/csrc/wavetape_walk.cu',
                                 'unicycler_tpu/ops/pallas_wavetape.py:608'),
               'banded': ('unicycler_tpu_torch/csrc/banded.cu',
                          'unicycler_tpu/ops/pallas_banded.py:333')}
    kernels = []
    for kname, (src, replaces) in sources.items():
        rows = [r for r in kres if r['name'] == kname]
        # the summary row is the widest main-path shape measured (W=1024)
        row = max(rows, key=lambda r: (r['W'], r['bt']))
        n_launch = retry_launches if kname == 'banded' else launches[kname]
        entry = {'name': kname, 'route': 'cuda', 'source': src,
                 'replaces': replaces, 'launches': n_launch,
                 'max_abs_err': max(r['max_abs_err'] for r in rows),
                 'ms': row['ms'], 'plain_ms': row['plain_ms'],
                 'bound_ms': row['bound_ms'],
                 'bound_by': 'operations' if row['bound_ms'] * 1e-3
                 > row['bytes'] / PEAK_BYTES_S else 'bytes',
                 'library_ms': None, 'shape': {'W': row['W'],
                                               'bt': row['bt']}}
        if kname in per_kernel:
            entry['main_path_ms'] = per_kernel[kname]['ms']
            entry['main_path_bound_ms'] = per_kernel[kname]['bound_ms']
        kernels.append(entry)
    report['kernels'] = kernels
    report['kernel_rows'] = kres
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(report, f, indent=1)
    log('== phase 6: summary')
    log(json.dumps({'kernels': kernels}))
    log(smi_line)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
