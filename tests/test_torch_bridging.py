"""(f) The slice: long-read bridging of the port against the JAX package.

A small synthetic genome (five unique stretches of 3 kb, which are the
anchors, and two repeat families of two copies each, one of them with a
60 bp length-variant bubble, so that both of its paths fall within path
search's length window) is written as an overlap-0 GFA; 16 long reads
span the repeat copies. Each package loads the GFA with its own
AssemblyGraph, aligns the reads with its own semi_global_align_long_reads
and runs create_long_read_bridges (the port with device='cpu').
MAX_FULL_DP_CELLS is lowered in both packages so that consensus and path
scoring take the full-matrix DP for some pairs and the banded DP (W =
4096) for others. Every bridge agrees exactly (tolerance 0): start, end,
graph path, consensus sequence and quality; each bridge takes the true
allele's path.
"""

import importlib
import random

import numpy as np

import torch_parity  # noqa: F401  (one torch thread per process)

from unicycler_tpu import settings as jset
from unicycler_tpu_torch import settings as tset
from unicycler_tpu_torch import synth


def _bridges(pkg, gfa_path, reads, anchor_nums, **kw):
    graph = importlib.import_module(
        pkg + '.graph.assembly_graph').AssemblyGraph(gfa_path, 0)
    fx = importlib.import_module(pkg + '.io.fastx')
    sg = importlib.import_module(pkg + '.align.semi_global')
    scheme = importlib.import_module(
        pkg + '.align.scoring').AlignmentScoringScheme('3,-6,-5,-2')
    lr = importlib.import_module(pkg + '.bridges.long_read')
    misc = importlib.import_module(pkg + '.misc')
    refs = [fx.Reference(str(n), s.forward_sequence)
            for n, s in sorted(graph.segments.items())]
    read_dict = {n: fx.Read(n, s, None) for n, s, _ in reads}
    names = [n for n, _, _ in reads]
    random.seed(0)
    sg.semi_global_align_long_reads(refs, None, read_dict, names, None, 1,
                                    scheme, [None], False, 50, None, None, 0,
                                    0, None, **kw)
    min_scaled = misc.get_percentile(
        [a.scaled_score for n in names for a in read_dict[n].alignments], 5.0)
    anchors = [graph.segments[n] for n in anchor_nums]
    bridges = lr.create_long_read_bridges(graph, read_dict, names, anchors, 0,
                                          min_scaled, 1, scheme, 50, False,
                                          10.0, **kw)
    return [(b.start_segment, b.end_segment, list(b.graph_path),
             b.consensus_sequence, b.quality) for b in bridges]


def test_long_read_bridges_match_jax(tmp_path, monkeypatch):
    for s in (jset, tset):
        monkeypatch.setattr(s, 'MAX_FULL_DP_CELLS', 1 << 20)
    rng = np.random.default_rng(3)
    chrom, gfa, copies = synth.repeat_genome(rng, [3000] * 5,
                                             [(500, 2, 0), (800, 2, 60)])
    reads = synth.reads_around(rng, chrom, copies, 4, n50=1500,
                               min_flank=400, max_len=2000)
    path = tmp_path / 'repeats.gfa'
    path.write_text(gfa)
    want = _bridges('unicycler_tpu', str(path), reads, range(1, 6))
    got = _bridges('unicycler_tpu_torch', str(path), reads, range(1, 6),
                   device='cpu')
    assert got == want
    truth = {(cp.left, cp.right): list(cp.path) for cp in copies}
    assert len(got) == len(copies)
    for start, end, graph_path, consensus, quality in got:
        if start < 0:
            start, end = -end, -start
            graph_path = [-x for x in reversed(graph_path)]
        assert truth[(start, end)] == graph_path
        assert consensus and quality > 0
