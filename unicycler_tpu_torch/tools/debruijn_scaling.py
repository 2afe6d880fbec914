"""Host cost of the de Bruijn build (asm/debruijn.build_best_short_read_graph)
against the genome's size.

For each chromosome size, makes chip_smoke.py phase 12's workload shape
from --seed (a circular chromosome with two 5,000 bp and four 1,300 bp
repeat copies planted, a circular 30 kbp plasmid, 2 x 150 bp pairs at
40x from synth.short_read_pairs), writes the pairs to FASTQ under --out,
runs the build with the command line's defaults (8 k values, read
correction) and prints one JSON line a size: its pairs, wall, peak host
memory and the build's trace spans, and seconds per Mbp of genome. The
build runs on the host only: no card is needed.

    python -m unicycler_tpu_torch.tools.debruijn_scaling \\
        --sizes 300000,825000 --out chiprun_out/debruijn_scaling
"""

import argparse
import json
import os
import re
import resource
import shutil
import sys
import time


def repeat_replicons(rng, genome, plasmid, families):
    """chip_smoke.repeat_replicons' replicons: the chromosome with the
    families' copies planted between equal unique stretches, and the
    plasmid."""
    from unicycler_tpu_torch import synth
    n_copies = sum(c for _, c, _ in families)
    unique = (genome - sum(n * c for n, c, _ in families)) // (n_copies + 1)
    chrom, _, _ = synth.repeat_genome(rng, [unique] * (n_copies + 1),
                                      list(families))
    return [chrom, synth.random_replicons(rng, [plasmid])[0]]


def build_once(size, seed, out, depth=40.0, plasmid=30_000,
               families=((5000, 2, 250), (1300, 4, 250))):
    import numpy as np
    from unicycler_tpu_torch import log, synth
    from unicycler_tpu_torch.asm.debruijn import build_best_short_read_graph
    from unicycler_tpu_torch.pipeline.main import get_arguments
    from unicycler_tpu_torch.utils import trace
    rng = np.random.default_rng(seed)
    reps = repeat_replicons(rng, size, plasmid, families)
    pairs_1, pairs_2 = synth.short_read_pairs(rng, reps, depth)
    run_dir = os.path.join(out, str(size))
    os.makedirs(run_dir, exist_ok=True)
    files = []
    for name, pairs in (('r1.fastq', pairs_1), ('r2.fastq', pairs_2)):
        files.append(os.path.join(run_dir, name))
        with open(files[-1], 'w') as f:
            f.write(''.join('@%s\n%s\n+\n%s\n' % p for p in pairs))
    args = get_arguments(['-1', files[0], '-2', files[1], '-o', run_dir,
                          '--verbosity', '0'])
    log.logger = log.Log(None, stdout_verbosity_level=0)
    trace.reset()
    trace.enable()
    t0 = time.time()
    try:
        graph = build_best_short_read_graph(args)
    finally:
        trace.disable()
        shutil.rmtree(run_dir)
    wall = time.time() - t0
    genome = sum(len(s) for s in reps)
    spans = {k: v['seconds'] for k, v in trace.as_dict()['spans'].items()
             if '/' not in k}
    # the k ladder's spans (k<k>, resolution_k<k>) summed
    parts = {}
    for name, secs in spans.items():
        key = 'k_ladder' if re.fullmatch(r'(resolution_)?k\d+', name) \
            else name
        parts[key] = parts.get(key, 0.0) + secs
    return {'chromosome': size, 'genome': genome, 'pairs': len(pairs_1),
            'wall_s': wall, 's_per_mbp': wall / (genome / 1e6),
            'segments': len(graph.segments),
            'host_peak_mib': resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024,
            'spans': spans, 'parts': parts,
            'parts_s_per_mbp': {k: v / (genome / 1e6)
                                for k, v in parts.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--sizes', default='300000,825000',
                    help='comma-separated chromosome sizes (bp)')
    ap.add_argument('--seed', type=int, default=5)
    ap.add_argument('--out', default=os.path.join('chiprun_out',
                                                  'debruijn_scaling'))
    args = ap.parse_args(argv)
    for size in (int(x) for x in args.sizes.split(',')):
        print(json.dumps(build_once(size, args.seed, args.out)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
