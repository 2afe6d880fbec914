"""The full-matrix DP's share of chip_smoke.py's bridging, hybrid and
default command line phases, for a before / after comparison of two
checkouts on one card.

    python unicycler_tpu_torch/tools/full_dp_ab.py [--root DIR]
        [--phases 7,11,12] [--label L]

imports chip_smoke.py and unicycler_tpu_torch from DIR (default: the
checkout holding this file), builds its kernels, runs the checkout's own
phase 7 (phase_bridging), 11 (phase_hybrid) and 12 (phase_shortread) at
their defaults (every gate of the checkout's phase applies), and prints
one line `FULL_DP_AB {json}`: for each phase its wall, the sum of its
`.../full_dp` spans (they add up over bridging's finalisation threads),
its `long_read_bridges` span, the full-matrix DP kernel's launches and
device time where the checkout has one, and a digest of what the phase
made (the bridges, or assembly.fasta), so that two checkouts can be
shown to give the same result. The workloads come from --seed, so two
checkouts run the same inputs. Compare two checkouts in one call, in
turns (parent, change, change, parent). Needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def span_sums(spans):
    full = sum(v['seconds'] for k, v in spans.items()
               if k.endswith('/full_dp'))
    bridges = spans.get('long_read_bridges', {}).get('seconds')
    return full, bridges


def file_digest(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument('--phases', default='7,11,12')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--label', default='')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit('chip_smoke.py was not imported from %s' % root)
    from unicycler_tpu_torch.ops import cuda_lib
    _, smi = cs.phase_device()
    cs.phase_build()
    dev = torch.device('cuda', 0)
    smoke_args = argparse.Namespace(
        seed=args.seed, reads=200,
        out=os.path.join(root, 'chiprun_out', 'chip_smoke.json'))
    runs = {'7': ('bridging', cs.phase_bridging, None),
            '11': ('hybrid', cs.phase_hybrid, 'hybrid'),
            '12': ('shortread', cs.phase_shortread, 'shortread')}
    out = {'root': root, 'label': args.label, 'device': smi}
    for ph in args.phases.split(','):
        key, fn, out_dir = runs[ph]
        report = {}
        launches, per_kernel = fn(smoke_args, dev, report)
        rec = report[key]
        full, bridges = span_sums(rec['spans'])
        row = {'wall_s': rec['wall_s'], 'full_dp_span_s': full,
               'long_read_bridges_s': bridges,
               'pairwise_launches': launches.get('pairwise'),
               'pairwise_ms': per_kernel.get('pairwise', {}).get('ms')}
        if out_dir is None:
            row['bridges_sha256'] = rec['bridges_sha256']
        else:
            row['assembly_sha256'] = file_digest(os.path.join(
                root, 'chiprun_out', out_dir, 'assembly.fasta'))
        out['phase ' + ph] = row
    cuda_lib.reset_launches()
    print('FULL_DP_AB ' + json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
