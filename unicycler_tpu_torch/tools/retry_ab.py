"""The retry pair (kernels 3 and 6) timed at chip_smoke.py's phase 3 and 5
shapes, for a before / after comparison of two checkouts on one card.

    python unicycler_tpu_torch/tools/retry_ab.py [--root DIR] [--label L]

imports unicycler_tpu_torch from DIR (default: the checkout holding this
file), builds its kernels, and prints one line `RETRY_AB {json}`: for each
shape, each kernel's mean device time over 5 launches, each timed alone
(CUDA events from the package's cuda_lib.TIMINGS), with the launch's real
rows (its longest n_act) and the walk's steps. The tasks come from fixed
seeds, so two checkouts time the same inputs. Compare two checkouts in
one call, in turns (parent, change, change, parent). Needs a CUDA card.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, W, task sizes, seed): kernel 3's launches; the walker walks each
# launch's moves
SHAPES = (
    ('phase3 W512', 512, [1500] * 32, 11),
    ('phase3 W1024', 1024, [1200] * 32, 12),
    ('phase3 W128', 128, [1500] * 32, 13),
    ('phase3 W2048', 2048, [1200] * 32, 14),
    ('phase5 W512', 512, [3000, 2600, 3400, 1800, 2200, 3100, 900, 2900], 1),
    ('phase5 W1024', 1024, [3000, 2600, 3400, 1800, 2200, 3100, 900, 2900],
     1),
    ('phase5 W2048', 2048, [3000, 2600, 3400, 1800, 2200, 3100, 900, 2900],
     1),
)


def device_ms(cuda_lib, fn, reps=5):
    import torch
    cuda_lib.TIMINGS = []
    try:
        out = None
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        ms = [e0.elapsed_time(e1) for _, e0, e1, _ in cuda_lib.TIMINGS]
    finally:
        cuda_lib.TIMINGS = None
    return sum(ms) / len(ms), out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument('--label', default='')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops import banded_kernel as bk
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import traceback_kernels as tbk
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    dev = torch.device('cuda', 0)
    scoring = Scoring(3, -6, -5, -2)
    cuda_lib.lib()
    rows = []
    for label, W, sizes, seed in SHAPES:
        rng = np.random.default_rng(seed)
        tasks = [bo.BandedTask(*t) for t in
                 synth.banded_tasks(rng, sizes, drift=True)]
        n_pad = bo.bucket_length(max(len(t.q) for t in tasks))
        m_pad = bo.bucket_length(max(len(t.r) for t in tasks))
        host = bo._pack_bucket(tasks, list(range(len(tasks))), n_pad, m_pad,
                               W, bk.BT)
        up = [torch.from_numpy(x).to(dev) for x in host]
        fwd = lambda: bk.banded_batch_cuda(*up, scoring, SEMI_GLOBAL, W,
                                           True)
        fwd()
        ms, (_, ei, ej, moves) = device_ms(cuda_lib, fwd)
        crow = up[2][:, 1:].contiguous()
        walk = lambda: tbk.banded_traceback_cuda(moves, crow, ei, ej, W)
        walk()
        wms, (rec, _) = device_ms(cuda_lib, walk)
        r = rec.to(torch.int64)
        steps = int(((r & 7) != 0).sum()) + int((r >> 3).sum())
        rows.append({'shape': label, 'W': W, 'tasks': len(tasks),
                     'n_pad': n_pad, 'rows': int(host[3].max()),
                     'banded_ms': ms, 'walk_ms': wms, 'steps': steps})
        del moves, up
    print('RETRY_AB ' + json.dumps({'label': args.label,
                                    'root': os.path.abspath(args.root),
                                    'device': torch.cuda.get_device_name(0),
                                    'rows': rows}), flush=True)


if __name__ == '__main__':
    main()
