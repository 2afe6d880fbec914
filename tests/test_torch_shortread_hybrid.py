"""Unicycler's default hybrid command line (`-1 R1 -2 R2 -l long`): the
port against the JAX package.

The 9 kbp genome of tests/test_pipeline_end_to_end.py's
test_hybrid_assembly_with_repeat (a 500 bp repeat twice, longer than the
pairs' inserts), its perfect tiled pairs and long reads, with `--kmers
21,41`. Both packages (the port on its CPU route) build the de Bruijn
graph, bridge the collapsed repeat with the long reads and polish the
result with the pairs where the last bridging round made bridges (here
round 2 makes none, so neither package polishes): assembly.gfa and
assembly.fasta are byte-equal, and the JAX test's gates hold on the
port's output.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_pipeline_end_to_end import rand_genome, sequence_matches_any_rotation

from unicycler_tpu.pipeline.fake_reads import (make_fake_long_reads,
                                               make_fake_short_reads,
                                               write_fastq)

from unicycler_tpu_torch.io.fastx import load_fasta
from unicycler_tpu_torch.utils import trace


@pytest.fixture(scope='module')
def hybrid_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('shortread_hybrid')
    repeat = rand_genome(500, 8)
    part_a = rand_genome(5000, 9)
    part_b = rand_genome(3000, 10)
    genome = part_a + repeat + part_b + repeat
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    r1, r2 = str(tmp / 'reads_1.fastq'), str(tmp / 'reads_2.fastq')
    rl = str(tmp / 'long.fastq')
    write_fastq(r1, pairs_1)
    write_fastq(r2, pairs_2)
    write_fastq(rl, make_fake_long_reads(genome, read_length=4000, step=400))
    jout, tout = str(tmp / 'jax'), str(tmp / 'port')
    trace.reset()
    trace.enable()
    try:
        graph = run_both_mains(['-1', r1, '-2', r2, '-l', rl, '--verbosity',
                                '0', '--keep', '0', '--min_fasta_length',
                                '100', '--kmers', '21,41'], jout, tout)
    finally:
        trace.disable()
    return {'genome': genome, 'part_a': part_a, 'jax': jout, 'port': tout,
            'graph': graph, 'trace': trace.as_dict()}


@pytest.mark.parametrize('name', ['assembly.gfa', 'assembly.fasta'])
def test_hybrid_output_matches_jax(hybrid_run, name):
    assert read_bytes(os.path.join(hybrid_run['port'], name)) == \
        read_bytes(os.path.join(hybrid_run['jax'], name))


def test_hybrid_gates_hold_on_the_port(hybrid_run):
    """The JAX test's gates: the whole genome (the repeat twice) is
    assembled, and a single contig is a rotation of the truth."""
    genome = hybrid_run['genome']
    fasta = load_fasta(os.path.join(hybrid_run['port'], 'assembly.fasta'))
    assert sum(len(seq) for _, seq in fasta) >= len(genome) - 100
    longest = max((seq for _, seq in fasta), key=len)
    if len(fasta) == 1:
        assert sequence_matches_any_rotation(longest, genome)
    else:
        assert len(longest) >= len(hybrid_run['part_a'])


def test_hybrid_run_built_and_bridged(hybrid_run):
    """The de Bruijn graph collapsed the repeat and long-read bridges
    joined it; the final short-read polish follows the last bridging
    round's bridges, which round 2 leaves empty."""
    spans = hybrid_run['trace']['spans']
    for name in ('short_read_graph', 'short_read_graph/correct_reads',
                 'short_read_graph/k21/count_kmers',
                 'short_read_graph/k41/count_kmers',
                 'short_read_graph/pair_resolution', 'long_read_assembly',
                 'long_read_bridges', 'apply_bridges', 'rotation'):
        assert name in spans, name
    assert hybrid_run['trace']['counters']['bridges.long_read'] > 0
    assert spans['apply_bridges']['calls'] == 1
    assert 'final_polish' not in spans
