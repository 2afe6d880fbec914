"""The port's command line (unicycler_tpu_torch.pipeline.main) against the
JAX package's.

A long-read-only run of both packages on the 12 kbp genome of
tests/test_pipeline_end_to_end.py (the port on its CPU route) writes the
same assembly.gfa and assembly.fasta, byte for byte, and the JAX test's
identity gates hold on the port's unitigs. get_arguments gives the same
Namespace for the same argv; short reads with no graph raise
NotImplementedError;
the start-gene search and the canonical rotation equal the JAX package's
on a replicon with a planted start gene.
"""

import os
import random

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_pipeline_end_to_end import rand_genome

from unicycler_tpu.pipeline import main as jmain
from unicycler_tpu.pipeline import rotation as jrot
from unicycler_tpu.pipeline.fake_reads import (make_fake_long_reads,
                                               write_fastq)

from unicycler_tpu_torch.pipeline import main as tmain
from unicycler_tpu_torch.pipeline import rotation as trot


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def test_long_read_only_assembly_matches_jax(tmp_path):
    genome = rand_genome(12000, 77)
    rl = str(tmp_path / 'long.fastq')
    write_fastq(rl, make_fake_long_reads(genome, read_length=5000, step=300))
    argv = ['-l', rl, '--verbosity', '0', '--keep', '0']
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    jmain.main(argv + ['-o', jout])
    tmain.main(argv + ['-o', tout], device='cpu')
    for name in ('assembly.gfa', 'assembly.fasta'):
        assert _read(os.path.join(tout, name)) == \
            _read(os.path.join(jout, name)), name

    # the JAX test's gates, on the port's output and alignment
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import align_reads_to_refs
    from unicycler_tpu_torch.io.fastx import Read, Reference, load_fasta
    fasta = load_fasta(os.path.join(tout, 'assembly.fasta'))
    assert fasta
    longest = max((seq for _, seq in fasta), key=len)
    assert len(longest) >= len(genome) * 0.9
    read = Read('contig', longest, None)
    align_reads_to_refs([read], [Reference('truth', genome + genome)],
                        AlignmentScoringScheme('3,-6,-5,-2'),
                        low_score_threshold=70.9, device='cpu')
    assert read.alignments
    assert max(a.percent_identity for a in read.alignments) > 99.0


@pytest.mark.parametrize('argv', [
    ['--mode', 'conservative'], ['--mode', 'bold'], ['--mode', 'normal'],
    ['-l', 'reads.fq', '--min_fasta_length', '500', '--no_rotate',
     '--start_gene_id', '80', '--scores', '2,-4,-4,-1', '--keep', '2'],
    ['-l', 'reads.fq', '--reference_defaults', '--min_bridge_qual', '3.5',
     '--contamination', 'lambda', '--linear_seqs', '1'],
    ['-1', 'a.fq', '-2', 'b.fq', '-s', 'c.fq', '--kmers', '21,41',
     '--depth_filter', '0.5', '--short_read_graph', 'g.gfa'],
], ids=['conservative', 'bold', 'normal', 'long', 'lambda', 'short'])
def test_cli_surface_matches_jax(tmp_path, argv):
    argv = argv + ['-o', str(tmp_path)]
    got, want = tmain.get_arguments(argv), jmain.get_arguments(argv)
    got, want = vars(got), vars(want)
    # the bundled lambda genome is each package's own copy
    for ns in (got, want):
        if (ns.get('contamination') or '').endswith('lambda_phage.fasta'):
            ns['contamination'] = os.path.basename(ns['contamination'])
    assert got == want
    args = tmain.get_arguments(['-o', str(tmp_path), '--mode', 'conservative'])
    assert args.mode == 0 and args.min_bridge_qual == 25.0
    args = tmain.get_arguments(['-o', str(tmp_path), '--mode', 'bold'])
    assert args.mode == 2 and args.min_bridge_qual == 1.0
    with pytest.raises(SystemExit):
        tmain.get_arguments(['--version'])
    with pytest.raises(SystemExit):
        tmain.get_arguments([])          # missing required -o


@pytest.mark.parametrize('argv', [['-1', 'a.fq', '-2', 'b.fq'],
                                  ['-s', 'c.fq', '-l', 'reads.fq']],
                         ids=['pairs', 'unpaired'])
def test_short_read_input_raises_not_implemented(tmp_path, argv):
    """Short reads with no graph to use or resume need the de Bruijn
    assembler, and pairs the final short-read polish: both come with the
    port's de Bruijn slice."""
    with pytest.raises(NotImplementedError, match='de Bruijn slice'):
        tmain.main(argv + ['-o', str(tmp_path / 'out')], device='cpu')


_CODONS = {}
for _c, _aa in jrot._CODON_TABLE.items():
    _CODONS.setdefault(_aa, []).append(_c)


@pytest.mark.parametrize('flip', [False, True], ids=['forward', 'reverse'])
def test_start_gene_search_matches_jax(flip):
    """A start gene of gene_data back-translated into a random replicon
    (on either strand): both packages find the same hit, and the
    canonical rotation of the replicon is the same."""
    from unicycler_tpu_torch.io.fastx import load_fasta
    from unicycler_tpu_torch.misc import reverse_complement
    rng = random.Random(5 + flip)
    names_seqs = load_fasta(trot.BUNDLED_START_GENES)
    name, protein = names_seqs[123]
    gene = ''.join(rng.choice(_CODONS[aa]) for aa in protein
                   if aa in _CODONS)
    left = rand_genome(9000, 11)
    right = rand_genome(11000, 12)
    seq = left + (reverse_complement(gene) if flip else gene) + right
    want = jrot.find_start_gene(seq, jrot.BUNDLED_START_GENES, 90.0, 95.0)
    got = trot.find_start_gene(seq, trot.BUNDLED_START_GENES, 90.0, 95.0)
    assert got == want
    assert got.qseqid == name and got.flip == flip
    assert got.start_pos == (len(left) + len(gene) if flip else len(left))
    assert trot.canonical_rotation(seq) == jrot.canonical_rotation(seq)
    assert trot.canonical_rotation(left) == jrot.canonical_rotation(left)
    assert np.array_equal(trot.encode_protein(protein),
                          jrot.encode_protein(protein))
