"""The port's graph stages of a hybrid run against the JAX package's.

Each graph goes through the stages pipeline/main.py runs on a short-read
graph, in both packages: load, determine_copy_depth,
clean_up_spades_graph (overlap removal, junction repair, merging),
get_anchor_segments, the SPAdes-contig and loop-unrolling bridges,
apply_bridges, the two clean-ups, merge_all_possible and final_clean. The
GFA text after each stage, the anchors and the bridges must be identical.
The graphs: the JAX package's de Bruijn graphs (k - 1 overlaps) of a
repeat-rich genome at two k, a synth.repeat_genome graph (overlap 0,
copy counts as depths) with SPAdes-style P-lines across its copies, one
whose depths carry noise, a hand-made loop graph with a path through the loop, and a FASTG written
from a de Bruijn graph with a sibling .paths file. A SAM file the port
wrote loads into the same alignments in both packages.
"""

import os
import random

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per process)
from test_overlap_removal_property import make_repeaty_sequence

from unicycler_tpu import log as jlog
from unicycler_tpu.asm.debruijn import assemble_short_reads, save_graph_gfa
from unicycler_tpu.bridges.loop_unroll import \
    create_loop_unrolling_bridges as j_loop
from unicycler_tpu.bridges.spades_contig import \
    create_spades_contig_bridges as j_spades
from unicycler_tpu.graph.assembly_graph import AssemblyGraph as JGraph
from unicycler_tpu.graph.copy_depth import determine_copy_depth as j_depth
from unicycler_tpu.io.fastx import encode_sequence
from unicycler_tpu.pipeline import main as jmain
from unicycler_tpu.pipeline.fake_reads import make_fake_short_reads

from unicycler_tpu_torch import log as tlog
from unicycler_tpu_torch import synth
from unicycler_tpu_torch.bridges.loop_unroll import \
    create_loop_unrolling_bridges as t_loop
from unicycler_tpu_torch.bridges.spades_contig import \
    create_spades_contig_bridges as t_spades
from unicycler_tpu_torch.graph.assembly_graph import AssemblyGraph as TGraph
from unicycler_tpu_torch.graph.copy_depth import determine_copy_depth as t_depth
from unicycler_tpu_torch.misc import reverse_complement
from unicycler_tpu_torch.pipeline import main as tmain

PACKAGES = {
    'jax': (JGraph, j_depth, jmain, j_spades, j_loop, jlog),
    'port': (TGraph, t_depth, tmain, t_spades, t_loop, tlog),
}
STAGES = ['load', 'copy_depth', 'clean', 'anchors', 'bridges', 'applied',
          'merged', 'final']
GRAPHS = ['debruijn_k21', 'debruijn_k41', 'repeat', 'noisy', 'loop',
          'fastg']


def _debruijn(k):
    genome = make_repeaty_sequence(6000, 12, random.Random(k))
    pairs_1, pairs_2 = make_fake_short_reads(genome)
    return assemble_short_reads(
        [encode_sequence(s) for _, s, _ in pairs_1 + pairs_2], k)


def _write_debruijn(path, k):
    unitigs, links = _debruijn(k)
    save_graph_gfa(unitigs, links, k, path)


def _write_repeat(path):
    """A repeat_genome graph with one SPAdes-style path across each copy
    of the first family (left unique, the copy's allele, right unique)."""
    rng = np.random.default_rng(3)
    _, text, copies = synth.repeat_genome(
        rng, [2500, 3100, 1800, 2700, 2200, 1900],
        [(1400, 3, 250), (700, 2, 0)])
    for i, cp in enumerate(c for c in copies if c.family == 0):
        path_segs = [cp.left] + list(cp.path) + [cp.right]
        text += 'P\tPATH_%d\t%s\t%s\n' % (
            i + 1, ','.join('%d+' % s for s in path_segs),
            ','.join(['0M'] * (len(path_segs) - 1)))
    with open(path, 'w') as f:
        f.write(text)


def _write_noisy(path):
    """A repeat_genome graph of three families whose depths carry
    read-depth noise (each scaled by 0.7-1.35), so copy depth has to
    propagate and tolerate, not read off exact multiples."""
    rng = np.random.default_rng(9)
    _, text, _ = synth.repeat_genome(
        rng, [2100, 2900, 1700, 2500, 2300, 1900, 2700, 1600, 2200],
        [(1500, 3, 250), (800, 3, 0), (500, 2, 0)])
    lines = []
    for line in text.splitlines(keepends=True):
        if line.startswith('S\t'):
            head, depth = line.rstrip('\n').rsplit('DP:f:', 1)
            line = '%sDP:f:%.3f\n' % (head, float(depth)
                                       * rng.uniform(0.7, 1.35))
        lines.append(line)
    with open(path, 'w') as f:
        f.write(''.join(lines))


def _write_loop(path):
    """A circular genome A R M R D (R a repeat around a middle M) as its
    collapsed overlap-0 graph, with a path joining A, R and M."""
    rng = np.random.default_rng(5)
    a, r, m, d, b = synth.random_replicons(rng, [2600, 400, 500, 2300, 1700])
    segs = [(1, a, 1.0), (2, r, 2.0), (3, m, 1.0), (4, d, 1.0), (5, b, 1.0)]
    lines = ['S\t%d\t%s\tDP:f:%.1f\n' % s for s in segs]
    lines += ['L\t%d\t+\t%d\t+\t0M\n' % e
              for e in ((1, 2), (2, 3), (3, 2), (2, 4), (4, 5), (5, 1))]
    lines.append('P\tPATH_1\t1+,2+,3+\t0M,0M\n')
    with open(path, 'w') as f:
        f.write(''.join(lines))


def _write_fastg(path, k=41):
    """A SPAdes-style FASTG of a de Bruijn graph (edge headers carry
    length, depth and links) and its .paths file, one path split at a
    scaffold gap."""
    unitigs, links = _debruijn(k)
    fwd = {}
    for a, b in links:
        fwd.setdefault(a, []).append(b)
        fwd.setdefault(-b, []).append(-a)

    def name(num):
        seq, depth = unitigs[abs(num) - 1]
        return 'EDGE_%d_length_%d_cov_%.4f%s' % (
            abs(num), len(seq), depth, "'" if num < 0 else '')

    with open(path, 'w') as f:
        for num in range(1, len(unitigs) + 1):
            for signed in (num, -num):
                ends = sorted(set(fwd.get(signed, [])))
                seq = unitigs[num - 1][0]
                f.write('>%s%s;\n%s\n' % (
                    name(signed),
                    (':' + ','.join(name(e) for e in ends)) if ends else '',
                    seq if signed > 0 else reverse_complement(seq)))
    walks = [list(x) for x in links[:3]]
    with open(path + '.paths', 'w') as f:
        for i, walk in enumerate(walks):
            text = ','.join('%d%s' % (abs(x), '+' if x > 0 else '-')
                            for x in walk)
            f.write('NODE_%d_length_1000_cov_10\n%s\n' % (i + 1, text))
            f.write("NODE_%d_length_1000_cov_10'\n%s\n" % (i + 1, text))
        gap = '%s;%s' % (','.join('%d+' % abs(x) for x in walks[0]),
                           ','.join('%d+' % abs(x) for x in walks[1]))
        f.write('NODE_9_length_1000_cov_10\n%s\n' % gap)


WRITERS = {'debruijn_k21': lambda p: _write_debruijn(p, 21),
           'debruijn_k41': lambda p: _write_debruijn(p, 41),
           'repeat': _write_repeat, 'noisy': _write_noisy,
           'loop': _write_loop,
           'fastg': _write_fastg}


def _gfa_text(graph, path, **kw):
    graph.save_to_gfa(path, verbosity=3, **kw)
    with open(path) as f:
        return f.read()


def _bridge_key(b):
    return (type(b).__name__, b.start_segment, b.end_segment,
            list(b.graph_path), b.bridge_sequence, repr(float(b.quality)),
            repr(b))


def _run_stages(package, graph_file, work):
    """Every stage's output of one package on one graph."""
    Graph, depth, main, spades, loop, log = PACKAGES[package]
    log.logger = log.Log(None, stdout_verbosity_level=0)
    out = {}
    g = Graph(graph_file, None)
    text = os.path.join(work, package + '.gfa')
    out['load'] = _gfa_text(g, text, include_insert_size=True)
    depth(g)
    out['copy_depth'] = _gfa_text(g, text, save_copy_depth_info=True,
                                  include_insert_size=True)
    main.clean_up_spades_graph(g)
    out['clean'] = _gfa_text(g, text, save_copy_depth_info=True,
                             include_insert_size=True)
    anchors = main.get_anchor_segments(g, None)
    out['anchors'] = [s.number for s in anchors]
    bridges = spades(g, anchors) + loop(g, anchors)
    out['bridges'] = [_bridge_key(b) for b in bridges]
    used = g.apply_bridges(bridges, 2, 10.0)
    out['applied'] = (sorted(used), _gfa_text(
        g, text, save_seg_type_info=True, save_copy_depth_info=True))
    g.clean_up_after_bridging_1(anchors, used)
    g.clean_up_after_bridging_2(used, 1000, 1000, g, anchors)
    g.merge_all_possible(anchors, 1)
    out['merged'] = _gfa_text(g, text)
    g.final_clean()
    out['final'] = (_gfa_text(g, text), g.completed_circular_replicons(),
                    g.get_contig_stats())
    return out


_CACHE = {}


@pytest.fixture(scope='module')
def staged(tmp_path_factory):
    def get(graph):
        if graph not in _CACHE:
            work = str(tmp_path_factory.mktemp(graph))
            ext = '.fastg' if graph == 'fastg' else '.gfa'
            graph_file = os.path.join(work, 'graph' + ext)
            WRITERS[graph](graph_file)
            _CACHE[graph] = {p: _run_stages(p, graph_file, work)
                             for p in PACKAGES}
        return _CACHE[graph]
    return get


@pytest.mark.parametrize('graph', GRAPHS)
@pytest.mark.parametrize('stage', STAGES)
def test_graph_stage_matches_jax(staged, graph, stage):
    got = staged(graph)
    assert got['port'][stage] == got['jax'][stage]


@pytest.mark.parametrize('graph', GRAPHS)
def test_graph_stages_do_real_work(staged, graph):
    """The stages change each graph: overlaps go, anchors are found and,
    on the graphs with paths, bridges are made and applied."""
    got = staged(graph)['port']
    assert got['anchors']
    assert got['final'][0] != got['load']
    if graph.startswith('debruijn') or graph == 'fastg':
        assert '\t0M\n' in got['clean'] and '\t0M\n' not in got['load']
    if graph in ('repeat', 'loop'):
        kinds = {b[0] for b in got['bridges']}
        assert kinds == {'repeat': {'SpadesContigBridge'},
                         'loop': {'LoopUnrollingBridge'}}[graph]
        assert got['applied'][0]


def test_fastg_and_paths_load_as_in_jax(tmp_path):
    fastg = str(tmp_path / 'graph.fastg')
    _write_fastg(fastg)
    jg, tg = JGraph(fastg, None), TGraph(fastg, None)
    assert tg.overlap == jg.overlap == 40
    assert sorted(tg.segments) == sorted(jg.segments)
    for num, seg in jg.segments.items():
        assert tg.segments[num].forward_sequence == seg.forward_sequence
        assert tg.segments[num].reverse_sequence == seg.reverse_sequence
        assert tg.segments[num].depth == seg.depth
    assert tg.forward_links == jg.forward_links
    assert tg.reverse_links == jg.reverse_links
    assert tg.paths == jg.paths
    assert sorted(tg.paths) == ['NODE_%s_length_1000_cov_10%s' % x
                                for x in ((1, ''), (2, ''), (3, ''),
                                          (9, '_1'), (9, '_2'))]


def test_load_sam_alignments_round_trip(tmp_path):
    """Reads aligned by the port (CPU route) to a SAM file load back into
    the same alignments in both packages (a --keep 2 rerun's reuse)."""
    from unicycler_tpu.align.scoring import AlignmentScoringScheme as JS
    from unicycler_tpu.align.semi_global import load_sam_alignments as jload
    from unicycler_tpu.io.fastx import Read as JRead
    from unicycler_tpu.io.fastx import Reference as JRef
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.align.semi_global import (
        load_sam_alignments, semi_global_align_long_reads)
    from unicycler_tpu_torch.io.fastx import Read, Reference
    rng = np.random.default_rng(11)
    refs = synth.random_replicons(rng, [6000, 4000])
    sim = synth.simulate_reads(rng, refs, 6, n50=2500, min_len=1200,
                               max_len=3500)
    references = [Reference(str(i + 1), s) for i, s in enumerate(refs)]
    read_dict = {n: Read(n, s, None) for n, s, _ in sim}
    names = [n for n, _, _ in sim]
    scheme = AlignmentScoringScheme('3,-6,-5,-2')
    sam = str(tmp_path / 'reads.sam')
    tlog.logger = tlog.Log(None, stdout_verbosity_level=0)
    semi_global_align_long_reads(references, None, read_dict, names, None,
                                 1, scheme, [None], False, 50, sam, None, 0,
                                 0, None, verbosity=0, device='cpu')
    written = [(a.read.name, a.ref.name, a.read_start_pos, a.read_end_pos,
                a.ref_start_pos, a.ref_end_pos, a.rev_comp, a.raw_score,
                a.scaled_score, a.percent_identity, "".join(a.cigar_parts))
               for n in names for a in read_dict[n].alignments]
    assert len(written) >= len(names)

    def key(alignments):
        return sorted((a.read.name, a.ref.name, a.read_start_pos,
                       a.read_end_pos, a.ref_start_pos, a.ref_end_pos,
                       a.rev_comp, a.raw_score, a.scaled_score,
                       a.percent_identity, "".join(a.cigar_parts)) for a in alignments)

    got = load_sam_alignments(
        sam, {n: Read(n, s, None) for n, s, _ in sim},
        {r.name: r for r in references}, scheme)
    want = jload(sam, {n: JRead(n, s, None) for n, s, _ in sim},
                 {str(i + 1): JRef(str(i + 1), s)
                  for i, s in enumerate(refs)}, JS('3,-6,-5,-2'))
    assert key(got) == key(want) == sorted(written)


def test_miniasm_bridge_with_several_paths_applies(tmp_path):
    """A miniasm bridge keeps every path its search found; with more than
    one, the JAX package's apply_bridges asks it to re-choose by
    availability, which only long-read bridges can, and stops with an
    AttributeError. The port applies it with its own sequence."""
    from unicycler_tpu.bridges.miniasm import MiniasmBridge as JBridge
    from unicycler_tpu_torch.bridges.miniasm import MiniasmBridge as TBridge
    graph_file = str(tmp_path / 'graph.gfa')
    _write_repeat(graph_file)
    applied = {}
    for Graph, Bridge, name in ((JGraph, JBridge, 'jax'),
                                (TGraph, TBridge, 'port')):
        g = Graph(graph_file, None)
        paths = [[6], [7]]
        bridge = Bridge(g, 1, 2, 'ACGT' * 300, 0, 0, None,
                        do_path_search=False)
        bridge.all_paths = [(p, 0, 0, 90.0) for p in paths]
        bridge.graph_path = paths[0]
        if name == 'jax':
            with pytest.raises(AttributeError,
                               match='set_path_based_on_availability'):
                g.apply_bridges([bridge], 0, 0.5)
            continue
        used = g.apply_bridges([bridge], 0, 0.5)
        applied = (used, g.forward_links[1], g.segments[max(g.segments)])
    used, links, seg = applied
    assert used == {6}
    assert seg.forward_sequence == 'ACGT' * 300 and links == [seg.number]


def test_zero_depth_segment_used_in_a_bridge(tmp_path):
    """A segment that an earlier bridging round left at depth 0 and a
    later round uses in a bridge: the JAX package's get_usedupness_score
    divides by that depth and stops with a ZeroDivisionError; the port
    counts none of it used up and cleans up as for any other segment."""
    graph_file = str(tmp_path / 'graph.gfa')
    _write_repeat(graph_file)
    for Graph, name in ((JGraph, 'jax'), (TGraph, 'port')):
        g = Graph(graph_file, None)
        seg = max(g.segments)
        g.segments[seg].depth = 0.0
        anchors = [g.segments[n] for n in sorted(g.segments)[:6]]
        if name == 'jax':
            with pytest.raises(ZeroDivisionError):
                g.clean_up_after_bridging_2({seg}, 1000, 1000, g, anchors)
            continue
        assert g.get_usedupness_score(seg, g) == 0.0
        jg = JGraph(graph_file, None)
        for other in sorted(g.segments)[:-1]:
            assert g.get_usedupness_score(other, jg) == \
                jg.get_usedupness_score(other, g)
        g.clean_up_after_bridging_2({seg}, 1000, 1000, g, anchors)
        assert sorted(g.segments)[:6] == [a.number for a in anchors]
