#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the
program's place in the next precision below the configuration's, read
on the sample that a run's check compares, on several seeds.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --jobs <jobs a run completes>

Prints one JSON line per seed: the numbers the control reads and the
cell's limits. A control that passes a limit it should fail means the
check cannot tell the precision apart. The benchmark's runs never run
this; it is for setting and re-checking the limits (PERF.md).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

from harness import spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--jobs', type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    cell = spec.Cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(',')]:
        t0 = time.time()
        stage = cell.stage().Stage({'config': cell.config,
                                    'traffic': cell.traffic, 'seed': seed,
                                    'device': torch.device('cuda')})
        stage.make_data()
        read = stage.control(args.jobs)
        limits = cell.traffic['check']['limits']
        print(json.dumps({'seed': seed, 'control': read,
                          'limits': {k: limits[k] for k in read},
                          'fails': {k: v > limits[k] for k, v in read.items()},
                          'seconds': time.time() - t0}), flush=True)


if __name__ == '__main__':
    main()
