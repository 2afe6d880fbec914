#!/usr/bin/env python3
"""Run one cell of the benchmark of unicycler_tpu_torch once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. The cell (BENCHMARK.json) names a configuration and a traffic
mix; the traffic names a stage (stages/<stage>.py). The run makes the
stage's data from --seed, sets up the program and warms it up with one
job of the cell's shapes (set-up), runs jobs back to back until
--seconds have passed (the window; the job running then is finished and
counts), checks the outputs against the plain reference (reference/),
and prints one JSON line last on standard output. With --trace 0 it
reports the cell's end-to-end metrics; with --trace 1 it records spans,
launches, work and the profiler's device trace in the window and
reports the per-layer metrics and a breakdown.

It exits with a code other than 0, printing no result, where CUDA is
missing or has fewer cards than the cell asks for, where the program
cannot be imported, and where JAX or the JAX package was loaded.
"""

import os
import time


def _process_start():
    """Host time at which this process started (from /proc), else now."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf('SC_CLK_TCK'))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0 if _p == HERE else 1, _p)

# build and kernel caches at fixed paths inside the checkout (the
# program's own nvcc build goes to unicycler_tpu_torch/_build/)
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = os.path.join(HERE, '.cache', _sub)
os.environ['USE_FLAX'] = '0'
os.environ['USE_JAX'] = '0'

from harness import isolation, spec  # noqa: E402


class Run(object):
    """What the metric readers read."""

    def __init__(self, setup_s, jobs, record):
        self.setup_s, self.jobs, self.record = setup_s, jobs, record


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def main(argv=None, device=None, bench=None, root=spec.ROOT):
    """Run the cell; returns (exit code, result dict or None). `device`,
    `bench` and `root` are for the tests: a CPU device skips the look for
    a card and the device trace."""
    args = parse(argv)
    cell = spec.Cell(args.workload, bench, root)
    import numpy as np
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            log('error: the cell needs %d CUDA device(s); %s'
                % (cell.chips, '%d found' % torch.cuda.device_count()
                   if torch.cuda.is_available() else 'CUDA is not available'))
            return 2, None
        device = torch.device('cuda', 0)
    device = torch.device(device)
    cuda = device.type == 'cuda'
    import unicycler_tpu_torch  # noqa: F401  (fails where it is absent)
    random.seed(args.seed)
    np.random.seed(args.seed % 2 ** 32)
    torch.manual_seed(args.seed)

    stage = cell.stage().Stage({'config': cell.config,
                                'traffic': cell.traffic, 'seed': args.seed,
                                'device': device})
    stage.setup()
    _sync(device)
    setup_s = time.time() - T_START
    log('%s: set-up %.3f s' % (cell.name, setup_s))

    recorder = None
    if args.trace:
        from harness.tracing import Recorder
        recorder = Recorder(device)
        t0 = recorder.start()
    else:
        t0 = time.perf_counter()
    jobs, i = [], 0
    while True:
        a = time.perf_counter()
        ok, bases = True, 0
        try:
            with recorder.job() if recorder else contextlib.nullcontext():
                bases = stage.job(i)
            _sync(device)
        except Exception:   # a failed job is counted, and the run goes on
            traceback.print_exc()
            ok = False
        b = time.perf_counter()
        jobs.append({'start': a - t0, 'end': b - t0, 'bases': bases,
                     'ok': ok})
        i += 1
        if b - t0 >= args.seconds:
            break
    record = recorder.stop(b) if recorder else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(not j['ok'] for j in jobs)
    log('%s: %d jobs in %.3f s (%d failed)' % (cell.name, len(jobs),
                                               jobs[-1]['end'], failed))

    bad = isolation.forbidden()
    if bad:
        log('error: the run loaded %s' % ', '.join(bad))
        return 3, None

    run = Run(setup_s, jobs, record)
    kind = 'layer_metrics' if args.trace else 'end_to_end'
    units = {m['name']: m['unit']
             for m in (cell.per_layer if args.trace else cell.end_to_end)}
    metrics = {}
    for name, read in cell.readers(kind).items():
        value = read(run)
        if value is not None:
            metrics[name] = {'value': value, 'unit': units[name]}

    claims = stage.claims()
    stage.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = stage.check(claims)
    log('%s: check %.3f s' % (cell.name, time.perf_counter() - t_check))
    correct = failed == 0 and all(limit is not None and value <= limit
                                  for _, value, limit in checks)

    result = {'correct': correct, 'attempted': len(jobs), 'failed': failed,
              'metrics': metrics,
              'device': {'platform': 'gpu' if cuda else device.type,
                         'kind': torch.cuda.get_device_name(device)
                         if cuda else device.type,
                         'count': cell.chips if cuda else 0,
                         'memory_peak_bytes': peak}}
    if record is not None:
        busy = record.device_busy()
        if busy:
            result['device']['busy_s'] = busy[0]
            result['device']['window_s'] = busy[1]
            log('%s: device busy from %s' % (cell.name, busy[2]))
        from harness.tracing import breakdown
        parts = breakdown(record)
        if parts:
            result['breakdown'] = parts
    result['info'] = dict(stage.info(),
                          job_s=[j['end'] - j['start'] for j in jobs])
    if record is not None:
        result['info']['job_spans'] = record.job_spans(
            [(j['start'], j['end']) for j in jobs])
    result['checks'] = {name: {'value': value, 'limit': limit}
                        for name, value, limit in checks}
    for name, value, limit in checks:
        log('check %s: %s (limit %s)%s' % (
            name, value, limit, '' if value <= limit else '  FAILS'))
    return 0, result


if __name__ == '__main__':
    code, result = main()
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    sys.exit(code)
