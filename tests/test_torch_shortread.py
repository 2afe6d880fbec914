"""Unicycler's default command line on short reads alone (`-1 R1 -2 R2`):
the port against the JAX package.

The 8 kbp circular genome of tests/test_pipeline_end_to_end.py's
test_short_read_only_assembly and its perfect tiled pairs. Both packages
run `-1 reads_1.fastq -2 reads_2.fastq` (the port on its CPU route): the
de Bruijn build (read correction, the 8-k ladder, pair resolution), the
graph stages, the final short-read polish and the rotation.
assembly.gfa and assembly.fasta are byte-equal, and the JAX test's gate
holds on the port's output.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_pipeline_end_to_end import rand_genome, sequence_matches_any_rotation

from unicycler_tpu.pipeline.fake_reads import (make_fake_short_reads,
                                               write_fastq)

from unicycler_tpu_torch.io.fastx import load_fasta
from unicycler_tpu_torch.utils import trace


@pytest.fixture(scope='module')
def short_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('short')
    genome = rand_genome(8000, 42)
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    r1, r2 = str(tmp / 'reads_1.fastq'), str(tmp / 'reads_2.fastq')
    write_fastq(r1, pairs_1)
    write_fastq(r2, pairs_2)
    jout, tout = str(tmp / 'jax'), str(tmp / 'port')
    trace.reset()
    trace.enable()
    try:
        graph = run_both_mains(['-1', r1, '-2', r2, '--verbosity', '0',
                                '--keep', '0', '--min_fasta_length', '100'],
                               jout, tout)
    finally:
        trace.disable()
    return {'genome': genome, 'jax': jout, 'port': tout, 'graph': graph,
            'trace': trace.as_dict()}


@pytest.mark.parametrize('name', ['assembly.gfa', 'assembly.fasta'])
def test_short_read_output_matches_jax(short_run, name):
    assert read_bytes(os.path.join(short_run['port'], name)) == \
        read_bytes(os.path.join(short_run['jax'], name))


def test_short_read_gate_holds_on_the_port(short_run):
    """The JAX test's gate: one contig, a rotation of the truth."""
    fasta = load_fasta(os.path.join(short_run['port'], 'assembly.fasta'))
    assert len(fasta) == 1
    assert sequence_matches_any_rotation(fasta[0][1], short_run['genome'])


def test_short_read_run_went_through_every_stage(short_run):
    """The de Bruijn spans (correction, each k of the ladder with its
    k-mer count, the pair resolution) and the final short-read polish."""
    spans = short_run['trace']['spans']
    counters = short_run['trace']['counters']
    ks = [int(name.split('/k')[1]) for name in spans
          if name.startswith('short_read_graph/k') and name.count('/') == 1]
    assert len(ks) == 8
    for k in ks:
        for part in ('count_kmers', 'unitigs', 'clean_unitigs', 'score'):
            assert 'short_read_graph/k%d/%s' % (k, part) in spans
        assert 'debruijn.k%d.score' % k in counters
    for name in ('short_read_graph/correct_reads',
                 'short_read_graph/insert_size',
                 'short_read_graph/pair_resolution', 'copy_depth', 'clean',
                 'final_clean', 'final_polish', 'final_polish/align_banded',
                 'rotation'):
        assert name in spans, name
    assert counters['debruijn.best_k'] in ks
