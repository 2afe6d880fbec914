"""A run on a short-read graph alone, and the resume of a run from its
002_depth_filter.gfa checkpoint: the port's command line against the JAX
package's.

With no long reads, only the SPAdes-contig and loop-unrolling bridges
apply (tests/test_torch_graph_ops.py's repeat graph, with a path across
each copy of a family, and its loop graph, with a path through the loop).
With --keep 1 both packages write the same checkpoint GFAs; a second run
with short reads (-s) and no graph resumes from 002_depth_filter.gfa in
both, and the outputs stay byte-equal.
"""

import os

import pytest

from torch_parity import read_bytes, run_both_mains
from test_torch_graph_ops import _write_loop, _write_repeat

OUTPUTS = ['assembly.gfa', 'assembly.fasta']
CHECKPOINTS = ['002_depth_filter.gfa', '003_overlaps_removed.gfa',
               '004_bridges_applied.gfa', '005_final_clean.gfa']


def _run(tmp_path, writer, argv):
    graph_file = str(tmp_path / 'short_read_graph.gfa')
    writer(graph_file)
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'port')
    graph = run_both_mains(['--short_read_graph', graph_file,
                            '--verbosity', '0'] + argv, jout, tout)
    return jout, tout, graph


@pytest.mark.parametrize('writer', [_write_repeat, _write_loop],
                         ids=['repeat', 'loop'])
def test_graph_alone_matches_jax(tmp_path, writer):
    jout, tout, graph = _run(tmp_path, writer, ['--keep', '0'])
    for name in OUTPUTS:
        assert read_bytes(os.path.join(tout, name)) == \
            read_bytes(os.path.join(jout, name)), name
    # the paths bridged the repeat copies (repeat graph) or the loop
    # (loop graph, one circular sequence A R M R D B)
    assert len(graph.segments) < 10
    if writer is _write_loop:
        assert graph.completed_circular_replicons() == \
            sorted(graph.segments)


def test_keep_1_checkpoints_and_resume_match_jax(tmp_path):
    jout, tout, _ = _run(tmp_path, _write_repeat, ['--keep', '1'])
    for name in CHECKPOINTS + OUTPUTS:
        assert read_bytes(os.path.join(tout, name)) == \
            read_bytes(os.path.join(jout, name)), name
    first = {name: read_bytes(os.path.join(tout, name)) for name in OUTPUTS}
    for out in (jout, tout):
        os.remove(os.path.join(out, 'assembly.gfa'))
        os.remove(os.path.join(out, 'assembly.fasta'))
    short = tmp_path / 'short.fastq'
    short.write_text('@r\nACGT\n+\nIIII\n')
    run_both_mains(['-s', str(short), '--verbosity', '1', '--keep', '1'],
                   jout, tout)
    for name in CHECKPOINTS + OUTPUTS:
        assert read_bytes(os.path.join(tout, name)) == \
            read_bytes(os.path.join(jout, name)), name
    log = (tmp_path / 'port' / 'unicycler_tpu_torch.log').read_text()
    assert 'Resuming from existing graph: ' + \
        os.path.join(tout, '002_depth_filter.gfa') in log
    # the resumed graph bridges and merges as the first run did
    for name in OUTPUTS:
        assert read_bytes(os.path.join(tout, name)) == first[name], name
