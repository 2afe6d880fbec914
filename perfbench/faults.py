#!/usr/bin/env python3
"""Faults planted under a cell's timed path, to read what the check
gives for each at the cell's own size, on the card:

    python3 perfbench/faults.py --workload <name> --fault <fault> \
        --seeds 1,2,3 [--seconds 1]

runs the cell (run.py, --trace 0) once a seed with the fault in place
and prints one JSON line a seed: the numbers compared, their limits and
`correct`, which has to come out false. The benchmark's runs never plant
a fault; the CPU tests plant the same ones at a tiny size.

Faults, by the stage that a cell's traffic names:
- half_reads: the entry gets the first half of its reads (the rest are
  left unaligned, or give no votes), as a batch cut in half would.
"""

import argparse
import functools
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _first_half_of(position):
    """A wrapper of fn that hands it the first half of its reads, the
    argument at `position`; reads of the second half keep no
    alignments."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            args = list(args)
            reads = args[position]
            for read in reads[len(reads) // 2:]:
                read.alignments = []
            args[position] = reads[:len(reads) // 2]
            return fn(*args, **kwargs)
        return wrapped
    return wrap


# stage -> fault -> (module, attribute, wrapper)
FAULTS = {
    'semi_global_align': {
        'half_reads': ('unicycler_tpu_torch.align.semi_global',
                       'align_reads_to_refs', _first_half_of(0)),
    },
    'polish_round': {
        'half_reads': ('unicycler_tpu_torch.asm.polish', 'polish_round',
                       _first_half_of(1)),
    },
}


def plant(stage, fault):
    """Put the fault in place; returns a function that takes it out."""
    module, attr, wrap = FAULTS[stage][fault]
    mod = importlib.import_module(module)
    inner = getattr(mod, attr)
    setattr(mod, attr, wrap(inner))
    return lambda: setattr(mod, attr, inner)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--fault', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', default='1')
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE]
    import run
    from harness import spec
    stage = spec.Cell(args.workload).traffic['stage']
    for seed in args.seeds.split(','):
        t0 = time.time()
        undo = plant(stage, args.fault)
        try:
            code, res = run.main(['--workload', args.workload, '--seed', seed,
                                  '--seconds', args.seconds, '--trace', '0'])
        finally:
            undo()
        print(json.dumps({'seed': int(seed), 'fault': args.fault,
                          'code': code,
                          'correct': res and res['correct'],
                          'checks': res and res['checks'],
                          'seconds': time.time() - t0}), flush=True)


if __name__ == '__main__':
    main()
