"""The full-matrix DP kernel (and its walker, where the checkout has one)
at chip_smoke.py phase 6's probe shapes, for a before / after comparison
of two checkouts on one card.

    python unicycler_tpu_torch/tools/full_dp_probe.py [--root DIR]
        [--label L] [--seed 0] [--reps 5] [--sweep]

imports unicycler_tpu_torch from DIR (default: the checkout holding this
file), builds its kernels and times align_batch_cuda at each shape: a
1,300 bp repeat's consensus (12 pairs; SEMI_GLOBAL with and without
moves, FULLY_GLOBAL at band 20), 12 pairs of 100-2,000 bp, four pairs
with empty sides, and the widest pairs the full DP takes (2 x 131,072 x
128 and 2 x 128 x 131,072). Each launch is timed alone by CUDA events
(cuda_lib.TIMINGS) after a warm-up, over --reps launches; where the
checkout has walk_full_cuda, the walker over the forward's outputs is
timed the same way. Prints one line `FULL_DP_PROBE {json}` with each
shape's mean and min ms and a digest of the outputs (score, ends, and
the moves over each pair's real region), so that two checkouts can be
shown to compute the same thing. The inputs come from --seed alone, so
two checkouts run the same inputs. Compare two checkouts in one call, in
turns (parent, change, change, parent). Needs a CUDA card.

--sweep (a checkout whose align_batch_cuda takes a plan) times the
consensus, mixed, wide and tall shapes under every plan of rows a thread
R in (1, 2, 4) and blocks a cluster C in (1, 2, 4, 8), threads a block
as the kernel derives them (full_plan's rule for that R and C), each
held to the kernel's own plan's digest, and prints `FULL_DP_SWEEP
{json}`.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def shapes(rng, synth):
    """(name, q_list, r_list, config name, band, need_moves) of the probe."""
    pairs = synth.banded_tasks(rng, [1300] * 12)
    consensus = [p[0] for p in pairs], [p[1] for p in pairs]
    mixed = synth.sized_pairs(rng, [(int(x), int(x * rng.uniform(0.9, 1.1)))
                                    for x in rng.integers(100, 2000, 12)])
    empty = synth.sized_pairs(rng, [(0, 500), (500, 0), (0, 0), (300, 320)])
    tall = synth.sized_pairs(rng, [(131072, 128), (131000, 120)])
    wide = synth.sized_pairs(rng, [(128, 131072), (120, 131000)])
    return [('consensus', consensus, 'semi', None, True),
            ('consensus', consensus, 'semi', None, False),
            ('consensus', consensus, 'global', 20, True),
            ('mixed', mixed, 'semi', None, True),
            ('empty', empty, 'semi', None, True),
            ('tall', tall, 'semi', None, True),
            ('wide', wide, 'semi', None, True),
            ('wide', wide, 'global', 20, True)]


def sweep_plans(n_pad, max_threads=256):
    """(R, threads, C) for every R in (1, 2, 4) and C in (1, 2, 4, 8):
    threads = n_pad / (C R) rounded up to 32, at most max_threads (fewer
    rows than n_pad run in stripes)."""
    plans = []
    for R in (1, 2, 4):
        for C in (1, 2, 4, 8):
            T = -(-max(n_pad, 1) // (C * R))
            plans.append((R, min(max_threads, -(-T // 32) * 32), C))
    return plans


def digest_of(out, qs, rs):
    digest = hashlib.sha256()
    for x in out[:3]:
        digest.update(x.cpu().numpy().tobytes())
    if out[3] is not None:
        moves = out[3].cpu().numpy()
        for b, (q, r) in enumerate(zip(qs, rs)):
            digest.update(moves[b, :len(q), :len(r) + 1].tobytes())
    return digest.hexdigest()[:16]


def timed(cuda_lib, torch, fn, reps):
    """Per-launch CUDA-event times (ms) of fn's kernel launches over reps
    calls after one warm-up, and fn's last output."""
    fn()
    cuda_lib.TIMINGS = []
    try:
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        times = [e0.elapsed_time(e1) for _, e0, e1, _ in cuda_lib.TIMINGS]
    finally:
        cuda_lib.TIMINGS = None
    return times, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument('--label', default='')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--sweep', action='store_true')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import unicycler_tpu_torch
    if os.path.dirname(os.path.dirname(
            os.path.abspath(unicycler_tpu_torch.__file__))) != root:
        raise SystemExit('unicycler_tpu_torch was not imported from %s'
                         % root)
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    from unicycler_tpu_torch.ops.encode import pack_pairs
    cuda_lib.lib()
    dev = torch.device('cuda', 0)
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit '
                   '--format=csv,noheader').read().strip()
    configs = {'semi': pw.SEMI_GLOBAL, 'global': pw.FULLY_GLOBAL}
    scoring = pw.Scoring(3, -6, -5, -2)
    has_walk = hasattr(pw, 'walk_full_cuda')
    out = {'root': root, 'label': args.label, 'device': smi, 'shapes': []}
    for name, (qs, rs), cname, band, need_moves in shapes(
            np.random.default_rng(args.seed), synth):
        host = pack_pairs(qs, rs, max(max(len(q) for q in qs), 1),
                          max(max(len(r) for r in rs), 1))
        diags = [None, None]
        if band is not None:
            diffs = host[3].astype('int64') - host[1].astype('int64')
            diags = [torch.from_numpy(x).to(dev) for x in (
                (-band - diffs.clip(0)).astype('int32'),
                (band + (-diffs).clip(0)).astype('int32'))]
        up = [torch.from_numpy(x).to(dev) for x in host] + diags
        fwd = lambda: pw.align_batch_cuda(*up[:4], scoring, configs[cname],
                                          need_moves, *up[4:])
        times, got = timed(cuda_lib, torch, fwd, args.reps)
        row = {'shape': name, 'config': cname, 'band': band,
               'need_moves': need_moves, 'pairs': len(qs),
               'n_pad': host[0].shape[1], 'm_pad': host[2].shape[1],
               'ms': sum(times) / len(times), 'min_ms': min(times),
               'digest': digest_of(got, qs, rs)}
        if args.sweep and cname == 'semi' and need_moves \
                and name in ('consensus', 'mixed', 'wide', 'tall'):
            row['sweep'] = []
            for plan in sweep_plans(host[0].shape[1]):
                run = lambda: pw.align_batch_cuda(
                    *up[:4], scoring, configs[cname], need_moves, *up[4:],
                    plan=plan)
                ptimes, pout = timed(cuda_lib, torch, run, 2)
                row['sweep'].append({
                    'plan': plan, 'ms': min(ptimes),
                    'same': digest_of(pout, qs, rs) == row['digest']})
                del pout
        if has_walk and need_moves:
            walk = lambda: pw.walk_full_cuda(got[3], got[0], got[1], got[2],
                                             configs[cname])
            wtimes, wout = timed(cuda_lib, torch, walk, args.reps)
            row['walk_ms'] = sum(wtimes) / len(wtimes)
            row['walk_min_ms'] = min(wtimes)
            row['walk_digest'] = hashlib.sha256(json.dumps(
                pw.walk_records(wout)).encode()).hexdigest()[:16]
        del got
        out['shapes'].append(row)
    print('FULL_DP_PROBE ' + json.dumps(out), flush=True)
    if args.sweep:
        print('FULL_DP_SWEEP ' + json.dumps(
            [{k: r[k] for k in ('shape', 'n_pad', 'm_pad', 'ms', 'sweep')}
             for r in out['shapes'] if 'sweep' in r]), flush=True)


if __name__ == '__main__':
    main()
