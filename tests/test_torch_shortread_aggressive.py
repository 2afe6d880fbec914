"""`--aggressive_resolution` on Unicycler's default command line: the port
against the JAX package, and the flag read per call.

A 4 kbp circular genome (tests/test_pipeline_end_to_end.py's
test_verbosity_monotonic_stdout) and its perfect tiled pairs, `--kmers
21,41`. An aggressive run of both packages (the port on its CPU route)
writes byte-equal outputs. The JAX package keeps the flag in a module
global that one aggressive run leaves set for the rest of the process
(held False here around its runs, as in a fresh process); the port
decides it per call, so a plain port run after the aggressive one in the
same process equals a fresh plain run.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_pipeline_end_to_end import rand_genome

from unicycler_tpu.asm import debruijn as jdb
from unicycler_tpu.pipeline import main as jmain
from unicycler_tpu.pipeline.fake_reads import (make_fake_short_reads,
                                               write_fastq)

from unicycler_tpu_torch.pipeline import main as tmain
from unicycler_tpu_torch.utils import trace

_NAMES = ('assembly.gfa', 'assembly.fasta')


def _traced(fn, *args, **kwargs):
    trace.reset()
    trace.enable()
    try:
        fn(*args, **kwargs)
    finally:
        trace.disable()
    return trace.as_dict()['spans']


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('aggressive')
    genome = rand_genome(4000, 7)
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    r1, r2 = str(tmp / 'r1.fastq'), str(tmp / 'r2.fastq')
    write_fastq(r1, pairs_1)
    write_fastq(r2, pairs_2)
    argv = ['-1', r1, '-2', r2, '--verbosity', '0', '--keep', '0',
            '--kmers', '21,41']
    out = {k: str(tmp / k) for k in ('jax_aggr', 'port_aggr', 'jax_plain',
                                     'port_plain')}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('UNICYCLER_TPU_AGGRESSIVE', raising=False)
        mp.setattr(jdb, 'AGGRESSIVE_RESOLUTION', False)
        aggr_spans = _traced(run_both_mains,
                             argv + ['--aggressive_resolution'],
                             out['jax_aggr'], out['port_aggr'])
        mp.setattr(jdb, 'AGGRESSIVE_RESOLUTION', False)
        plain_spans = _traced(tmain.main, argv + ['-o', out['port_plain']],
                              device='cpu')
        jmain.main(argv + ['-o', out['jax_plain']])
    out['aggr_spans'], out['plain_spans'] = aggr_spans, plain_spans
    return out


@pytest.mark.parametrize('name', _NAMES)
def test_aggressive_output_matches_jax(runs, name):
    assert read_bytes(os.path.join(runs['port_aggr'], name)) == \
        read_bytes(os.path.join(runs['jax_aggr'], name))


@pytest.mark.parametrize('name', _NAMES)
def test_plain_run_after_aggressive_equals_a_fresh_run(runs, name):
    assert read_bytes(os.path.join(runs['port_plain'], name)) == \
        read_bytes(os.path.join(runs['jax_plain'], name))


def test_flag_is_decided_per_call(runs):
    """Only the aggressive run built the resolution ladder above the best
    k."""
    assert any(name.startswith('short_read_graph/resolution_k')
               for name in runs['aggr_spans'])
    assert not any('resolution_k' in name for name in runs['plain_spans'])
    assert 'short_read_graph/pair_resolution' in runs['plain_spans']
