"""The long-read-only assembler of the port against the JAX package's.

On a 12 kbp circular genome with long reads from synth (15x, the slice's
error model), in the manner of tests/test_pipeline_end_to_end.py's
long-read-only case: map_reads gives the same hits, ava_overlaps the same
overlaps, OLCAssembler.assemble the same string graph (GFA text) and trim
ranges, and make_miniasm_string_graph(None, ...) with device='cpu' the
same polished unitig graph (GFA text: segments, sequences, links, depths),
with every polish round giving the same polished sequences, mapping
quality and depths. All exact.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)

from unicycler_tpu import settings as jset
from unicycler_tpu.align import minimap_like as jmm
from unicycler_tpu.align.scoring import AlignmentScoringScheme as JScheme
from unicycler_tpu.asm import hybrid as jhy
from unicycler_tpu.asm import olc as jolc
from unicycler_tpu.asm import polish as jpol
from unicycler_tpu.io.fastx import Read as JRead
from unicycler_tpu.io.fastx import Reference as JReference

from unicycler_tpu_torch import settings as tset
from unicycler_tpu_torch import synth
from unicycler_tpu_torch.align import minimap_like as tmm
from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme as TScheme
from unicycler_tpu_torch.asm import hybrid as thy
from unicycler_tpu_torch.asm import olc as tolc
from unicycler_tpu_torch.asm import polish as tpol
from unicycler_tpu_torch.io.fastx import Read as TRead
from unicycler_tpu_torch.io.fastx import Reference as TReference


@pytest.fixture(scope='module')
def workload():
    rng = np.random.default_rng(1)
    genome = synth.random_replicons(rng, [12000])[0]
    reads = synth.simulate_read_set(rng, [genome], 15, n50=4500,
                                    min_len=2200, max_len=6500)
    return genome, [(n, s) for n, s, _ in reads]


def _mm_key(alignments):
    return {name: [(a.read_start, a.read_end, a.read_strand, a.ref_name,
                    a.ref_start, a.ref_end, a.matching_bases, a.num_bases,
                    a.minimiser_count, a.read_length, a.ref_length)
                   for a in hits]
            for name, hits in alignments.items()}


def _hit_key(hits):
    return [(h.qn, h.qs, h.qe, h.rev, h.tn, h.ts, h.te, h.ml, h.bl)
            for h in hits]


def _gfa(graph, path):
    graph.save_to_gfa(str(path), verbosity=3)
    with open(str(path)) as f:
        return f.read()


@pytest.mark.parametrize('preset', ['polish', 'ava'])
def test_map_reads_matches_jax(workload, preset):
    genome, reads = workload
    kwargs = dict(k=12, w=10, filter_overlaps=True, allowed_overlap=10,
                  filter_by_minimisers=True) if preset == 'polish' else \
        dict(k=15, w=5)
    want = jmm.map_reads([JReference('g', genome + genome[:3000])],
                         [JRead(n, s, None) for n, s in reads], **kwargs)
    got = tmm.map_reads([TReference('g', genome + genome[:3000])],
                        [TRead(n, s, None) for n, s in reads], **kwargs)
    assert _mm_key(got) == _mm_key(want)
    assert len(got) >= len(reads) - 1


def test_ava_overlaps_and_olc_match_jax(workload, tmp_path):
    _, reads = workload
    seqs = dict(reads)
    want_hits = jolc.ava_overlaps(seqs)
    got_hits = tolc.ava_overlaps(seqs)
    assert _hit_key(got_hits) == _hit_key(want_hits)
    assert len(got_hits) > 10 * len(reads)
    want_graph, want_trim = jolc.OLCAssembler(seqs, min_dp=3).assemble(
        want_hits)
    got_graph, got_trim = tolc.OLCAssembler(seqs, min_dp=3).assemble(
        got_hits)
    assert got_trim == want_trim
    want_gfa = _gfa(want_graph, tmp_path / 'jax.gfa')
    assert _gfa(got_graph, tmp_path / 'port.gfa') == want_gfa
    assert want_gfa.count('\nL\t') >= 4


def _recorded(module, rounds):
    inner = module.polish_round

    def record(*args, **kwargs):
        out = inner(*args, **kwargs)
        rounds.append(out)
        return out
    return record


def test_make_miniasm_string_graph_matches_jax(workload, tmp_path,
                                              monkeypatch):
    genome, reads = workload
    # two polish rounds in each package instead of five, for test time
    monkeypatch.setattr(jset, 'RACON_POLISH_LOOP_COUNT_LONG_ONLY', 1)
    monkeypatch.setattr(tset, 'RACON_POLISH_LOOP_COUNT_LONG_ONLY', 1)
    want_rounds, got_rounds = [], []
    monkeypatch.setattr(jpol, 'polish_round',
                        _recorded(jpol, want_rounds))
    monkeypatch.setattr(tpol, 'polish_round', _recorded(tpol, got_rounds))
    want = jhy.make_miniasm_string_graph(
        None, {n: JRead(n, s, None) for n, s in reads}, None,
        JScheme('3,-6,-5,-2'), None, None, None, [])
    got = thy.make_miniasm_string_graph(
        None, {n: TRead(n, s, None) for n, s in reads}, None,
        TScheme('3,-6,-5,-2'), None, None, None, [], device='cpu')
    assert len(got_rounds) == len(want_rounds) == 2
    for g, w in zip(got_rounds, want_rounds):
        assert g == w
    want_gfa = _gfa(want, tmp_path / 'jax.gfa')
    assert _gfa(got, tmp_path / 'port.gfa') == want_gfa
    # one circular unitig covering the genome
    assert len(got.segments) == 1 and got.segment_is_circular('1')
    assert abs(got.segments['1'].get_length() - len(genome)) < 300
