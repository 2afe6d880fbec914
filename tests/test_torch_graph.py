"""(e) The port's assembly graph against the JAX package's.

A GFA loaded and saved by both AssemblyGraph classes gives identical
files, and the graph queries that bridging makes agree: path sequences,
lengths, dead ends, the estimated sequence length, and the exhaustive
path search between anchors (bridges/path_finding.all_paths).
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per process)

from unicycler_tpu.bridges import path_finding as jpf
from unicycler_tpu.graph.assembly_graph import AssemblyGraph as JGraph

from unicycler_tpu_torch import synth
from unicycler_tpu_torch.bridges import path_finding as tpf
from unicycler_tpu_torch.graph.assembly_graph import AssemblyGraph as TGraph


@pytest.fixture(params=[0, 1])
def gfa(request, tmp_path):
    rng = np.random.default_rng(request.param)
    _, text, copies = synth.repeat_genome(
        rng, [900, 1200, 700, 1500, 800, 1000],
        [(300, 3, 0), (600, 2, 250)])
    path = tmp_path / 'graph.gfa'
    path.write_text(text)
    return str(path), copies


def test_gfa_round_trip_is_identical(gfa, tmp_path):
    path, _ = gfa
    outs = []
    for cls, name in ((JGraph, 'jax.gfa'), (TGraph, 'port.gfa')):
        out = tmp_path / name
        cls(path, 0).save_to_gfa(str(out), verbosity=0)
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert outs[0].count('\nL\t') > 10


def test_graph_queries_agree(gfa):
    path, copies = gfa
    jg, tg = JGraph(path, 0), TGraph(path, 0)
    assert jg.forward_links == tg.forward_links
    assert jg.reverse_links == tg.reverse_links
    assert jg.get_estimated_sequence_len() == tg.get_estimated_sequence_len()
    for cp in copies:
        full = [cp.left] + list(cp.path) + [cp.right]
        rev = [-x for x in reversed(full)]
        for p in (full, rev, list(cp.path)):
            assert jg.get_path_sequence(p) == tg.get_path_sequence(p)
            assert jg.get_path_length(p) == tg.get_path_length(p)
            assert jg.get_path_availability(p) == tg.get_path_availability(p)
        for s, e in ((cp.left, cp.right), (-cp.right, -cp.left)):
            want = jpf.all_paths(jg, s, e, 0, 3000)
            got = tpf.all_paths(tg, s, e, 0, 3000)
            assert got == want
            true_path = list(cp.path) if s > 0 else \
                [-x for x in reversed(cp.path)]
            assert true_path in got
        assert jg.ends_with_dead_end(cp.left) == tg.ends_with_dead_end(cp.left)
        assert jg.starts_with_dead_end(cp.right) == \
            tg.starts_with_dead_end(cp.right)
