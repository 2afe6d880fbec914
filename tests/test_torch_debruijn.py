"""The port's de Bruijn assembler (unicycler_tpu_torch.asm.debruijn)
against the JAX package's, exactly: the same numpy inputs made from a
seed go through both, and the integers, lists and GFA text must be equal
(no tolerance).
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)
from test_debruijn import rand_genome

from unicycler_tpu.asm import debruijn as jdb
from unicycler_tpu.io.fastx import encode_sequence
from unicycler_tpu.pipeline.fake_reads import make_fake_short_reads

from unicycler_tpu_torch.asm import debruijn as tdb


def _codes(pairs):
    return [encode_sequence(seq) for _, seq, _ in pairs]


@pytest.fixture(scope='module')
def noisy_reads():
    """Pairs over a 3 kbp circular genome at 0.2% error (substitutions and
    short indels), as code arrays."""
    genome = rand_genome(3000, 101)
    p1, p2 = make_fake_short_reads(genome, error_rate=0.002, seed=5)
    return _codes(p1) + _codes(p2)


@pytest.fixture(scope='module')
def repeat_pairs():
    """TestRepeatSplitting's genome (a R b R c with a 100 bp repeat R), its
    tiled pairs and the k = 63 assembly (JAX package)."""
    genome = rand_genome(2500, 22) + rand_genome(100, 21) \
        + rand_genome(1800, 23) + rand_genome(100, 21) \
        + rand_genome(2100, 24)
    p1, p2 = make_fake_short_reads(genome)
    p1, p2 = _codes(p1), _codes(p2)
    unitigs, links = jdb.assemble_short_reads(p1 + p2, 63)
    mean, dev = jdb.estimate_insert_size(p1, p2, unitigs, 63)
    return unitigs, links, p1, p2, mean, dev


@pytest.mark.parametrize('lengths,args', [
    ([100] * 50, ()), ([150] * 30 + [90] * 10, ()), ([250] * 20, (4,)),
    ([75, 80, 120, 300], (1,)), ([150] * 9, (8, 0.3, 0.8)),
    ([40] * 12, ()), ([600] * 5, ())])
def test_get_kmer_range_matches_jax(lengths, args):
    assert tdb.get_kmer_range(lengths, *args) == \
        jdb.get_kmer_range(lengths, *args)


@pytest.mark.parametrize('k', [21, 33, 63])
def test_count_kmers_matches_jax(noisy_reads, k):
    want = jdb.count_kmers(noisy_reads, k)
    got = tdb.count_kmers(noisy_reads, k)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert len(got[0]) > 1000


def test_count_kmers_with_carry_matches_jax(noisy_reads):
    """The S0 carry of k = 21's unitigs into k = 33: carried k-mers skip
    the solidity threshold and keep the larger of their two counts."""
    unitigs, links = jdb.assemble_short_reads(noisy_reads, 21)
    carried = jdb.make_carry('S0', unitigs, links, 21, 33)
    assert carried
    assert [(c.tolist(), d) for c, d in
            tdb.make_carry('S0', unitigs, links, 21, 33)] == \
        [(c.tolist(), d) for c, d in carried]
    # reads at 1/40 of the depth (~5x), so the carry adds k-mers the reads
    # alone leave under the threshold
    thin = noisy_reads[::40]
    want = jdb.count_kmers(thin, 33, carried=carried)
    got = tdb.count_kmers(thin, 33, carried=carried)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert len(got[0]) > len(jdb.count_kmers(thin, 33)[0])


@pytest.mark.parametrize('k', [21, 41])
def test_unitigs_and_links_match_jax(noisy_reads, k):
    kmers, counts = jdb.count_kmers(noisy_reads, k)
    want = jdb.build_unitigs(kmers, counts, k)
    got = tdb.build_unitigs(kmers, counts, k)
    assert got == want
    want = jdb.dedupe_unitigs(want)
    assert tdb.dedupe_unitigs(got) == want
    assert tdb.link_unitigs(want, k) == jdb.link_unitigs(want, k)
    assert tdb.assemble_short_reads(noisy_reads, k) == \
        jdb.assemble_short_reads(noisy_reads, k)


def test_save_graph_gfa_text_matches_jax(repeat_pairs, tmp_path):
    unitigs, links, p1, p2, mean, dev = repeat_pairs
    paths = jdb.resolve_paths_with_pairs(unitigs, links, p1, p2, 63, mean,
                                         dev)
    hk = [[1, -2], [3, 2, -1]]
    jdb.save_graph_gfa(unitigs, links, 63, str(tmp_path / 'j.gfa'), paths,
                       hk_paths=hk)
    tdb.save_graph_gfa(unitigs, links, 63, str(tmp_path / 't.gfa'), paths,
                       hk_paths=hk)
    text = (tmp_path / 't.gfa').read_text()
    assert text == (tmp_path / 'j.gfa').read_text()
    assert '\nP\tPATH_1\t' in text and '\nP\tHKPATH_2\t' in text


@pytest.mark.parametrize('aggressive', [False, True],
                         ids=['default', 'aggressive'])
def test_pair_votes_match_jax(repeat_pairs, monkeypatch, aggressive):
    unitigs, links, p1, p2, mean, dev = repeat_pairs
    monkeypatch.setattr(jdb, 'AGGRESSIVE_RESOLUTION', aggressive)
    want = jdb.collect_pair_votes(unitigs, links, p1, p2, 63, mean)
    got = tdb.collect_pair_votes(unitigs, links, p1, p2, 63, mean,
                                 aggressive=aggressive)
    assert dict(got) == dict(want)
    assert sum(len(v) for v in got.values()) > 100


def test_insert_size_matches_jax(repeat_pairs):
    unitigs, links, p1, p2, mean, dev = repeat_pairs
    assert tdb.estimate_insert_size(p1, p2, unitigs, 63) == (mean, dev)
    assert 250 < mean < 350


def test_split_repeats_with_pairs_matches_jax(repeat_pairs):
    unitigs, links, p1, p2, mean, dev = repeat_pairs
    want = jdb.split_repeats_with_pairs(list(unitigs), list(links), p1, p2,
                                        63, mean, dev)
    got = tdb.split_repeats_with_pairs(list(unitigs), list(links), p1, p2,
                                       63, mean, dev)
    assert got == want
    assert got[2] >= 1


def test_resolve_paths_with_pairs_matches_jax(repeat_pairs):
    unitigs, links, p1, p2, mean, dev = repeat_pairs
    want = jdb.resolve_paths_with_pairs(unitigs, links, p1, p2, 63, mean,
                                        dev)
    assert tdb.resolve_paths_with_pairs(unitigs, links, p1, p2, 63, mean,
                                        dev) == want
    assert any(len(p) >= 3 for p in want)


@pytest.fixture(scope='module')
def thread_graph():
    """test_highk_resolution.py's repeat graph: a 40 bp repeat between two
    pairs of flanks, collapsed into one unitig at k = 31."""
    from test_highk_resolution import _random_seq, _reads_from
    rng = np.random.default_rng(11)
    fa, fb, fc, fd = (_random_seq(rng, 400) for _ in range(4))
    repeat = _random_seq(rng, 40)
    g1, g2 = fa + repeat + fb, fc + repeat + fd
    reads = _reads_from(g1, 100, 3) + _reads_from(g2, 100, 3)
    unitigs, links = jdb.assemble_short_reads(reads * 2, 31)
    return unitigs, links, g1, g2


@pytest.mark.parametrize('witnesses', ['true', 'chimera'])
def test_split_repeats_with_threads_matches_jax(thread_graph, witnesses):
    unitigs, links, g1, g2 = thread_graph
    hk = [g1[300:700], g2[300:700]]
    if witnesses == 'chimera':
        hk.append(g1[300:440] + g2[440:700])
    assert tdb.resolve_paths_with_higher_k(unitigs, links, hk, 31) == \
        jdb.resolve_paths_with_higher_k(unitigs, links, hk, 31)
    want = jdb.split_repeats_with_threads(list(unitigs), list(links), hk, 31)
    got = tdb.split_repeats_with_threads(list(unitigs), list(links), hk, 31)
    assert got == want
    assert got[2] == (1 if witnesses == 'true' else 0)


def test_carry_material_matches_jax(noisy_reads):
    """The S1 / S2 junction-window carries (not the pipeline's S0, but
    part of the module)."""
    unitigs, links = jdb.assemble_short_reads(noisy_reads, 21)
    for strategy in ('S1', 'S2'):
        want = jdb.make_carry(strategy, unitigs, links, 21, 41)
        got = tdb.make_carry(strategy, unitigs, links, 21, 41)
        assert [(c.tolist(), d) for c, d in got] == \
            [(c.tolist(), d) for c, d in want]
    with pytest.raises(ValueError):
        tdb.make_carry('S9', unitigs, links, 21, 41)


def test_score_graph_matches_jax(repeat_pairs):
    unitigs, links = repeat_pairs[:2]
    assert tdb.score_graph(unitigs, links, 63) == \
        jdb.score_graph(unitigs, links, 63)
    assert tdb.score_graph([], [], 63) == 0.0


def test_aggressive_resolution_is_read_per_call(monkeypatch):
    import argparse
    monkeypatch.delenv('UNICYCLER_TPU_AGGRESSIVE', raising=False)
    assert not tdb.aggressive_resolution(argparse.Namespace())
    assert tdb.aggressive_resolution(
        argparse.Namespace(aggressive_resolution=True))
    assert not tdb.aggressive_resolution(
        argparse.Namespace(aggressive_resolution=False))
    monkeypatch.setenv('UNICYCLER_TPU_AGGRESSIVE', '1')
    assert tdb.aggressive_resolution(argparse.Namespace())
    assert not hasattr(tdb, 'AGGRESSIVE_RESOLUTION')
