"""Hybrid assembly on a supplied short-read graph: the port's command line
against the JAX package's.

The 9 kbp genome of tests/test_pipeline_end_to_end.py's
test_hybrid_assembly_with_repeat (a 500 bp repeat twice), its fake short
reads assembled into a de Bruijn graph by the JAX package's own
assembler (k = 51, so the graph has 50 bp overlaps and
remove_all_overlaps runs) and saved as GFA, and its fake long reads. Both
packages run `--short_read_graph G.gfa -l long.fastq` (the port on its
CPU route): assembly.gfa and assembly.fasta are byte-equal, and the JAX
test's gates hold on the port's output.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_pipeline_end_to_end import rand_genome, sequence_matches_any_rotation

from unicycler_tpu.asm.debruijn import assemble_short_reads, save_graph_gfa
from unicycler_tpu.io.fastx import encode_sequence
from unicycler_tpu.pipeline.fake_reads import (make_fake_long_reads,
                                               make_fake_short_reads,
                                               write_fastq)

from unicycler_tpu_torch.io.fastx import load_fasta
from unicycler_tpu_torch.utils import trace


@pytest.fixture(scope='module')
def hybrid_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('hybrid')
    repeat = rand_genome(500, 8)
    part_a = rand_genome(5000, 9)
    part_b = rand_genome(3000, 10)
    genome = part_a + repeat + part_b + repeat
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    unitigs, links = assemble_short_reads(
        [encode_sequence(s) for _, s, _ in pairs_1 + pairs_2], 51)
    graph_file = str(tmp / 'short_read_graph.gfa')
    save_graph_gfa(unitigs, links, 51, graph_file)
    rl = str(tmp / 'long.fastq')
    write_fastq(rl, make_fake_long_reads(genome, read_length=4000, step=400))
    jout, tout = str(tmp / 'jax'), str(tmp / 'port')
    trace.reset()
    trace.enable()
    try:
        graph = run_both_mains(['--short_read_graph', graph_file, '-l', rl,
                                '--verbosity', '0', '--keep', '0',
                                '--min_fasta_length', '100'], jout, tout)
    finally:
        trace.disable()
    return {'genome': genome, 'part_a': part_a, 'jax': jout, 'port': tout,
            'graph': graph, 'unitigs': unitigs, 'trace': trace.as_dict()}


@pytest.mark.parametrize('name', ['assembly.gfa', 'assembly.fasta'])
def test_hybrid_output_matches_jax(hybrid_run, name):
    assert read_bytes(os.path.join(hybrid_run['port'], name)) == \
        read_bytes(os.path.join(hybrid_run['jax'], name))


def test_hybrid_gates_hold_on_the_port(hybrid_run):
    """The JAX test's gates: the whole genome (the repeat twice) is
    assembled, and a single contig is a rotation of the truth."""
    genome = hybrid_run['genome']
    fasta = load_fasta(os.path.join(hybrid_run['port'], 'assembly.fasta'))
    total = sum(len(seq) for _, seq in fasta)
    assert total >= len(genome) - 100
    longest = max((seq for _, seq in fasta), key=len)
    if len(fasta) == 1:
        assert sequence_matches_any_rotation(longest, genome)
    else:
        assert len(longest) >= len(hybrid_run['part_a'])


def test_hybrid_run_bridges_the_collapsed_repeat(hybrid_run):
    """The short-read graph holds the repeat once (three segments with
    k - 1 overlaps); the port's run bridged it with long reads into one
    circular sequence, through every stage's trace span."""
    assert len(hybrid_run['unitigs']) == 3
    graph = hybrid_run['graph']
    assert graph.overlap == 0
    assert graph.completed_circular_replicons() == sorted(graph.segments)
    spans = hybrid_run['trace']['spans']
    for name in ('short_read_graph', 'copy_depth', 'clean',
                 'long_read_assembly', 'long_read_assembly/place_contigs',
                 'simple_long_read_bridges', 'long_read_alignment',
                 'long_read_bridges', 'apply_bridges', 'merge',
                 'final_clean', 'rotation'):
        assert name in spans, name
    assert hybrid_run['trace']['counters']['bridges.long_read'] > 0
