"""The full-matrix DP's share of chip_smoke.py's bridging, hybrid and
default command line phases, for a before / after comparison of two
checkouts on one card.

    python unicycler_tpu_torch/tools/full_dp_ab.py [--root DIR]
        [--phases 7,11,12] [--label L] [--base-spans]

imports chip_smoke.py and unicycler_tpu_torch from DIR (default: the
checkout holding this file), builds its kernels, runs the checkout's own
phase 7 (phase_bridging), 11 (phase_hybrid) and 12 (phase_shortread) at
their defaults (every gate of the checkout's phase applies), and prints
one line `FULL_DP_AB {json}`: for each phase its wall, the sum of its
`.../full_dp` spans (they add up over bridging's finalisation threads)
and of the `.../full_dp/pack`, `/fetch` and `/decode` spans inside them
(padding and upload; the copy to the host; PairAlignments from what came
back), the counter `full_dp.fetch_bytes`, its `long_read_bridges` span,
the full-matrix DP kernel's and its walker's launches and device time
where the checkout has them, and a digest of what the phase made (the
bridges, or assembly.fasta), so that two checkouts can be shown to give
the same result. The workloads come from --seed, so two checkouts run
the same inputs. Compare two checkouts in one call, in turns (parent,
change, change, parent). Needs a CUDA card.

--base-spans runs a checkout whose align_pairs has no such spans (the
forward kernel of csrc/pairwise.cu with the moves copied to the host and
decoded there) through host_route_pairs below: that route, with the
spans, on the checkout's own forward, traceback decoder and types.
"""

import argparse
import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def span_sums(spans, leaf='full_dp'):
    return sum(v['seconds'] for k, v in spans.items()
               if k.endswith('/' + leaf) or k == leaf)


def host_route_pairs(pw):
    """An align_pairs for the module pw that copies the whole moves array
    to the host and decodes it pair by pair there (the route before the
    walk on the card), with the spans pack, fetch and decode and the
    counter full_dp.fetch_bytes."""
    import numpy as np
    import torch
    from unicycler_tpu_torch.device import resolve_device
    from unicycler_tpu_torch.ops.encode import pack_pairs
    from unicycler_tpu_torch.utils import trace

    def align_pairs(q_list, r_list, scoring=pw.DEFAULT_SCORING,
                    config=pw.SEMI_GLOBAL, need_cigar=True, band=None,
                    device=None):
        if not q_list:
            return []
        dev = resolve_device(device)
        with trace.span('pack'):
            q_batch, q_lens, r_batch, r_lens = pack_pairs(
                q_list, r_list, max(max(len(q) for q in q_list), 1),
                max(max(len(r) for r in r_list), 1))
            if band is not None:
                diffs = r_lens.astype(np.int64) - q_lens.astype(np.int64)
                lower = (-band - np.maximum(0, diffs)).astype(np.int32)
                upper = (band + np.maximum(0, -diffs)).astype(np.int32)
                lower, upper = (torch.from_numpy(x).to(dev)
                                for x in (lower, upper))
            else:
                lower = upper = None
            inputs = [torch.from_numpy(x).to(dev)
                      for x in (q_batch, q_lens, r_batch, r_lens)]
        score, end_i, end_j, moves = pw.align_batch_device(
            *inputs, scoring, config, need_cigar, lower, upper)
        with trace.span('fetch'):
            score = score.cpu().numpy()
            end_i = end_i.cpu().numpy()
            end_j = end_j.cpu().numpy()
            if need_cigar:
                moves = moves.cpu().numpy()
        trace.add('full_dp.fetch_bytes', 12 * len(score) + (
            moves.nbytes if need_cigar else 0))
        results = []
        with trace.span('decode'):
            for b in range(len(q_list)):
                if need_cigar:
                    cigar, si, sj = pw.decode_traceback(
                        moves[b], end_i[b], end_j[b], config)
                else:
                    cigar, si, sj = [], 0, 0
                results.append(pw.PairAlignment(
                    score=int(score[b]), s1_start=si, s1_end=int(end_i[b]),
                    s2_start=sj, s2_end=int(end_j[b]), cigar=cigar,
                    s1_len=int(q_lens[b]), s2_len=int(r_lens[b])))
        return results

    return align_pairs


def file_digest(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument('--phases', default='7,11,12')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--label', default='')
    ap.add_argument('--base-spans', action='store_true')
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        raise SystemExit('chip_smoke.py was not imported from %s' % root)
    from unicycler_tpu_torch.ops import cuda_lib
    from unicycler_tpu_torch.ops import pairwise as pw
    if args.base_spans:
        pw.align_pairs = host_route_pairs(pw)
    _, smi = cs.phase_device()
    cs.phase_build()
    dev = torch.device('cuda', 0)
    smoke_args = argparse.Namespace(
        seed=args.seed, reads=200,
        out=os.path.join(root, 'chiprun_out', 'chip_smoke.json'))
    runs = {'7': ('bridging', cs.phase_bridging, None),
            '11': ('hybrid', cs.phase_hybrid, 'hybrid'),
            '12': ('shortread', cs.phase_shortread, 'shortread')}
    out = {'root': root, 'label': args.label, 'device': smi,
           'base_spans': args.base_spans}
    for ph in args.phases.split(','):
        key, fn, out_dir = runs[ph]
        report = {}
        launches, per_kernel = fn(smoke_args, dev, report)
        rec = report[key]
        spans = rec['spans']
        row = {'wall_s': rec['wall_s'],
               'full_dp_span_s': span_sums(spans),
               'pack_s': span_sums(spans, 'full_dp/pack'),
               'fetch_s': span_sums(spans, 'full_dp/fetch'),
               'decode_s': span_sums(spans, 'full_dp/decode'),
               'fetch_bytes': rec['counters'].get('full_dp.fetch_bytes'),
               'long_read_bridges_s': spans.get(
                   'long_read_bridges', {}).get('seconds')}
        for name in ('pairwise', 'pairwise_walk'):
            row[name + '_launches'] = launches.get(name)
            row[name + '_ms'] = per_kernel.get(name, {}).get('ms')
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
