"""Hybrid assembly on a synth.repeat_genome graph: the port's command line
against the JAX package's.

A chromosome of unique stretches with three planted repeat copies (a
family of two with a 200 bp indel allele, and one more), its collapsed
overlap-0 GFA with copy counts as depths as the short-read graph, and
long reads of the slice's error model (synth.simulate_read_set) over the
chromosome. Both packages run `--short_read_graph G.gfa -l long.fastq`
(the port on its CPU route) with the JAX defaults: assembly.gfa and
assembly.fasta are byte-equal, and every planted copy is resolved in the
port's output.
"""

import os

import numpy as np
import pytest

from torch_parity import read_bytes, run_both_mains

from unicycler_tpu_torch import synth
from unicycler_tpu_torch.io.fastx import load_fasta
from unicycler_tpu_torch.misc import reverse_complement


@pytest.fixture(scope='module')
def repeat_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('hybrid_repeat')
    rng = np.random.default_rng(21)
    chrom, gfa, copies = synth.repeat_genome(
        rng, [2600, 2200, 3000, 2400], [(1400, 2, 200), (900, 1, 0)])
    graph_file = tmp / 'short_read_graph.gfa'
    graph_file.write_text(gfa)
    sim = synth.simulate_read_set(rng, [chrom], 5.0, n50=5000,
                                  min_len=2500, max_len=9000)
    reads = tmp / 'long.fastq'
    reads.write_text(''.join('@%s\n%s\n+\n%s\n' % (n, s, ',' * len(s))
                             for n, s, _ in sim))
    jout, tout = str(tmp / 'jax'), str(tmp / 'port')
    run_both_mains(['--short_read_graph', str(graph_file), '-l', str(reads),
                    '--verbosity', '0', '--keep', '0'], jout, tout)
    return {'chrom': chrom, 'copies': copies, 'jax': jout, 'port': tout}


@pytest.mark.parametrize('name', ['assembly.gfa', 'assembly.fasta'])
def test_repeat_graph_output_matches_jax(repeat_run, name):
    assert read_bytes(os.path.join(repeat_run['port'], name)) == \
        read_bytes(os.path.join(repeat_run['jax'], name))


def test_repeat_graph_copies_resolved(repeat_run):
    """Each planted copy lies in one assembled sequence with 300 bases of
    unique sequence on both sides, on its true allele."""
    chrom = repeat_run['chrom']
    seqs = [s for _, s in load_fasta(os.path.join(repeat_run['port'],
                                                  'assembly.fasta'))]
    doubled = [s + s for s in seqs]
    doubled += [reverse_complement(s) for s in doubled]
    for cp in repeat_run['copies']:
        window = chrom[cp.start - 300:cp.end + 300]
        assert any(window in s for s in doubled), cp
