"""The `--keep 1` resume of a `-1 R1 -2 R2` run: the port against the JAX
package.

tests/test_pipeline_end_to_end.py's test_depth_filter_resume: a 6 kbp
circular genome and its perfect tiled pairs, `--kmers 21,41 --keep 1`.
Both packages build the de Bruijn graph and write their checkpoints
(the port on its CPU route; assembly.gfa, assembly.fasta and
002_depth_filter.gfa byte-equal); a second port run over its output
directory resumes from 002_depth_filter.gfa instead of assembling and
writes the same assembly.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_pipeline_end_to_end import rand_genome

from unicycler_tpu.pipeline.fake_reads import (make_fake_short_reads,
                                               write_fastq)

from unicycler_tpu_torch.pipeline import main as tmain
from unicycler_tpu_torch.utils import trace


@pytest.fixture(scope='module')
def resume_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('resume')
    genome = rand_genome(6000, 9)
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    r1, r2 = str(tmp / 'r1.fastq'), str(tmp / 'r2.fastq')
    write_fastq(r1, pairs_1)
    write_fastq(r2, pairs_2)
    jout, tout = str(tmp / 'jax'), str(tmp / 'port')
    argv = ['-1', r1, '-2', r2, '--verbosity', '1', '--keep', '1',
            '--kmers', '21,41']
    run_both_mains(argv, jout, tout)
    first = {name: read_bytes(os.path.join(tout, name))
             for name in ('assembly.gfa', 'assembly.fasta')}
    trace.reset()
    trace.enable()
    try:
        tmain.main(argv + ['-o', tout], device='cpu')
    finally:
        trace.disable()
    return {'jax': jout, 'port': tout, 'first': first,
            'trace': trace.as_dict()}


@pytest.mark.parametrize('name', ['assembly.gfa', 'assembly.fasta',
                                  '002_depth_filter.gfa'])
def test_fresh_run_matches_jax(resume_run, name):
    want = read_bytes(os.path.join(resume_run['jax'], name))
    if name.startswith('assembly'):
        assert resume_run['first'][name] == want
    assert read_bytes(os.path.join(resume_run['port'], name)) == want


def test_second_run_resumes_instead_of_assembling(resume_run):
    spans = resume_run['trace']['spans']
    assert 'short_read_graph' in spans
    assert not any(name.startswith('short_read_graph/') for name in spans)
    with open(os.path.join(resume_run['port'],
                           'unicycler_tpu_torch.log')) as f:
        log_text = f.read()
    assert 'Resuming from existing graph' in log_text
