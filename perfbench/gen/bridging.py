"""Frozen copies of chip_smoke.py's repeat-genome workload (phase 7),
for a bridging cell: a chromosome with repeat families planted between
unique stretches, a circular plasmid, the collapsed overlap-0 GFA and
long reads around each copy. Not used by a cell yet (PERF.md, Open
questions)."""

import numpy as np

from . import synth


def repeat_replicons(seed, genome, plasmid, families):
    """The replicons from `seed`: the chromosome with the families' copies
    planted (synth.repeat_genome) and the plasmid, with their collapsed
    overlap-0 GFA (the plasmid one segment linked to itself). Returns
    (the generator, to draw reads from next; chromosome; plasmid;
    gfa_text; copies; anchor segment numbers)."""
    rng = np.random.default_rng(seed)
    n_copies = sum(c for _, c, _ in families)
    unique = (genome - sum(n * c for n, c, _ in families)) // (n_copies + 1)
    chrom, gfa, copies = synth.repeat_genome(rng, [unique] * (n_copies + 1),
                                             list(families))
    lines = gfa.splitlines(keepends=True)
    n_seg = sum(line.startswith('S\t') for line in lines)
    pnum = n_seg + 1
    pseq = synth.random_replicons(rng, [plasmid])[0]
    gfa = ''.join(lines[:n_seg]) + 'S\t%d\t%s\tDP:f:1.0\n' % (pnum, pseq) \
        + ''.join(lines[n_seg:]) + 'L\t%d\t+\t%d\t+\t0M\n' % (pnum, pnum)
    return (rng, chrom, pseq, gfa, copies,
            list(range(1, n_copies + 2)) + [pnum])


def bridging_workload(seed, genome=5_000_000, plasmid=100_000,
                      families=((5000, 7, 250), (1300, 12, 250)),
                      per_copy=12, min_flank=1000):
    """The repeat genome of phase 7 with `per_copy` reads of the long-read
    model around each copy. Returns (gfa_text, copies, reads, anchor
    segment numbers)."""
    rng, chrom, _, gfa, copies, anchors = repeat_replicons(
        seed, genome, plasmid, families)
    reads = synth.reads_around(rng, chrom, copies, per_copy,
                               min_flank=min_flank)
    return gfa, copies, reads, anchors
