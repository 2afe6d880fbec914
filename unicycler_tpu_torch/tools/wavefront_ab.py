"""Kernel 7 (the per-task wavefront forward) timed at chip_smoke.py's
phase 9 shapes, for a before / after comparison of two checkouts on one
card.

    python unicycler_tpu_torch/tools/wavefront_ab.py [--root DIR] [--label L]
        [--plans]

imports unicycler_tpu_torch from DIR (default: the checkout holding this
file), builds its kernels, and prints one line `WAVEFRONT_AB {json}`: for
each shape, the kernel's mean device time over 5 launches, each timed
alone (CUDA events from the package's cuda_lib.TIMINGS), its time a DP row
(the shape's read length), and a digest of its outputs (hatn, lcv, lci),
so two checkouts can be seen to compute the same. A shape the checkout
refuses (the parent's W > 2048) is listed with its error. The tasks come
from fixed seeds (the tasks of scripts/wavefront_microbench.py), so two
checkouts time the same inputs. Compare two checkouts in one call, in
turns (parent, change, change, parent). --plans also times every
cluster size of this checkout's launch plan at each shape. Needs a CUDA
card.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, W, drift a 16 rows, rows a task, tasks)
SHAPES = (
    ('W512 d0', 512, 0, 2048, 8),
    ('W512 d4', 512, 4, 2048, 8),
    ('W1024 d0', 1024, 0, 2048, 8),
    ('W1024 d4', 1024, 4, 2048, 8),
    ('W2048 d4', 2048, 4, 2048, 8),
    ('W1024 d4 x160', 1024, 4, 1024, 160),
    ('W4096 d4 short', 4096, 4, 256, 8),
    ('W16384 d4 short', 16384, 4, 256, 8),
)


def microbench_tasks(n, W, drift, B, seed=0):
    """B reads of n bases planted at 90% identity W/2 diagonals into their
    references, with per-row band starts c[i] = i + drift * i // 16:
    (q, r, c_rows, n_acts, m_acts)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    m = n + W + (drift * n) // 16 + 16
    q = rng.randint(0, 4, (B, n)).astype(np.int8)
    r = rng.randint(0, 4, (B, m)).astype(np.int8)
    r[:, W // 2:W // 2 + n] = np.where(rng.rand(B, n) < 0.9, q,
                                       r[:, W // 2:W // 2 + n])
    rows = np.arange(n + 1, dtype=np.int64)
    c_rows = [rows + (drift * rows) // 16 for _ in range(B)]
    return (q, r, c_rows, np.full(B, n, np.int32), np.full(B, m, np.int32))


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
    ap.add_argument('--plans', action='store_true',
                    help='also time every cluster size (this checkout)')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import wavefront as wf
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    dev = torch.device('cuda', 0)
    scoring = Scoring(3, -6, -5, -2)
    cuda_lib.lib()
    rows = []
    for label, W, drift, n, B in SHAPES:
        q, r, c_rows, n_acts, m_acts = microbench_tasks(n, W, drift, B)
        staged = wf._prepare(q, r, c_rows, n_acts, m_acts, W)
        up = [torch.from_numpy(x).to(dev) for x in staged[:4]]
        fwd = lambda: wf.wavefront_forward_cuda(
            *up, W=W, Wcap=staged[6], a_lo=staged[4], scoring=scoring,
            config=SEMI_GLOBAL)
        row = {'shape': label, 'W': W, 'tasks': B, 'rows': n,
               'groups': staged[5]}
        try:
            fwd()
        except RuntimeError as exc:
            row['refused'] = str(exc)[:200]
            rows.append(row)
            continue
        ms, out = device_ms(cuda_lib, fwd)
        digest = hashlib.sha256()
        for x in out:
            digest.update(x.cpu().numpy().tobytes())
        row.update(ms=ms, us_per_row=1e3 * ms / n,
                   digest=digest.hexdigest()[:16])
        if args.plans and hasattr(wf, 'launch_plan'):
            # every cluster size at one segment a warp, beside the plan's
            row['plan'] = wf.launch_plan(B, W)
            nseg = -(-(W // 2) // wf.SEG)
            row['by_C'] = {}
            for C in wf.CLUSTER_SIZES:
                NW = -(-nseg // C)
                if NW > wf.MAX_WARPS:
                    continue
                row['by_C'][C] = device_ms(cuda_lib, lambda: (
                    wf.wavefront_forward_cuda(
                        *up, W=W, Wcap=staged[6], a_lo=staged[4],
                        scoring=scoring, config=SEMI_GLOBAL,
                        plan=(C, NW, 1, False))))[0]
        rows.append(row)
    print('WAVEFRONT_AB ' + json.dumps({
        'label': args.label, 'root': os.path.abspath(args.root),
        'device': torch.cuda.get_device_name(0), 'rows': rows}), flush=True)


if __name__ == '__main__':
    main()
