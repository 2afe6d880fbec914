"""The port's minimiser lookup (one native pass over a read set,
native/seedmap.cpp) against the JAX package's MinimizerIndex.lookup and
lookup_many.

References with tandem and interspersed repeats on both strands; reads
from them with errors, runs of N, lengths below w + k - 1, none at all,
none from them, inside the tandem repeat (so diagonals tie) and over
elements of many copies (so hit counts tie); several min_hits, radii, k
and w, and k >= 32, which takes the numpy fallback.
Every SeedHitCluster field, both anchor arrays and the order of the
lists must be equal. Then map_reads against the JAX package's with each
filter, and the counters that say which path looked the reads up.
"""

import zlib

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per test process)

from unicycler_tpu.align import minimap_like as jmm
from unicycler_tpu.io import fastx as jfastx
from unicycler_tpu.ops import minimizer as jmz

from unicycler_tpu_torch import native, settings
from unicycler_tpu_torch.align import minimap_like as tmm
from unicycler_tpu_torch.io import fastx as tfastx
from unicycler_tpu_torch.ops import minimizer as tmz
from unicycler_tpu_torch.utils import trace

BASES = np.array(list('ACGTN'))


@pytest.fixture
def lib():
    if native.get_lib() is None:
        pytest.skip('no C++ toolchain for the native library')


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _revcomp(codes):
    return (3 - codes[::-1]).astype(np.int8)


def _references(rng):
    """Three references: a 1,200 bp element planted four times in the
    first (twice reverse-complemented) and twice in the second, a
    tandem run of a 37 bp unit in the first, and a short third."""
    element = rng.integers(0, 4, 1200).astype(np.int8)
    unit = rng.integers(0, 4, 37).astype(np.int8)

    def unique(n):
        return rng.integers(0, 4, n).astype(np.int8)

    first = np.concatenate([
        unique(3000), element, unique(2500), _revcomp(element),
        unique(1500), np.tile(unit, 30), unique(2000), element,
        unique(1800), _revcomp(element), unique(2200)])
    second = np.concatenate([unique(2600), _revcomp(element), unique(3100),
                             element, unique(1900)])
    third = unique(2500)
    return [first, second, third], unit


def _copies(rng):
    """Two 800 bp elements, A and B, each planted ten times (the index's
    occurrence cap) apart over three references on both strands, and
    reads of A then B: a read finds twenty clusters, ten of each hit
    count, whose order only a stable sort keeps."""
    a, b = (rng.integers(0, 4, 800).astype(np.int8) for _ in range(2))
    refs = [[], [], []]
    for i, element in enumerate([a, b] * 10):
        copy = _revcomp(element) if i % 3 == 0 else element
        refs[i % 3] += [rng.integers(0, 4, 1500).astype(np.int8), copy]
    refs = [np.concatenate(r) for r in refs]
    ab = np.concatenate([a, b])
    reads = [ab, _revcomp(ab), _mutated(rng, ab, 0.01)]
    return refs, reads + _from_refs(rng, refs, 6, 1000, 5000)


def _mutated(rng, codes, rate):
    """Substitutions, insertions and deletions at `rate` each third."""
    out = []
    for c in codes:
        r = rng.random()
        if r < rate / 3:
            out.append(rng.integers(0, 4))
        elif r < 2 * rate / 3:
            out.extend([c, rng.integers(0, 4)])
        elif r >= rate:
            out.append(c)
    return np.array(out, np.int8)


def _from_refs(rng, refs, n, lo, hi, rate=0.05):
    reads = []
    for _ in range(n):
        ref = refs[rng.integers(len(refs))]
        length = int(rng.integers(lo, min(hi, len(ref))))
        start = int(rng.integers(0, len(ref) - length + 1))
        read = _mutated(rng, ref[start:start + length], rate)
        reads.append(_revcomp(read) if rng.random() < 0.5 else read)
    return reads


def _reads(kind, rng, refs, unit, k, w):
    if kind == 'mapped':
        return _from_refs(rng, refs, 24, 300, 6000)
    if kind == 'n_runs':
        reads = _from_refs(rng, refs, 16, 800, 5000)
        for read in reads:
            for _ in range(rng.integers(1, 4)):
                at = int(rng.integers(0, len(read)))
                read[at:at + int(rng.integers(1, 60))] = 4
        return reads
    if kind == 'short':
        # below w + k - 1 bases (fewer k-mers than a window), exactly
        # w + k - 1 (one window), and one window more; from the first two
        # references and from the tandem run, where one minimiser finds a
        # cluster
        reads = []
        tandem = np.tile(unit, 3)
        for length in list(range(1, w + k)) + [w + k - 1, w + k] * 3:
            for ref in (refs[rng.integers(2)], tandem):
                start = int(rng.integers(0, len(ref) - length))
                read = ref[start:start + length].copy()
                reads.append(_revcomp(read) if rng.random() < 0.5 else read)
        return reads
    if kind == 'empty':
        empty = np.zeros(0, np.int8)
        return ([empty] + _from_refs(rng, refs, 4, 500, 3000)
                + [empty, rng.integers(0, 4, 3000).astype(np.int8),
                   np.full(700, 4, np.int8), empty])
    if kind == 'tandem':
        reads = []
        for _ in range(10):
            read = _mutated(rng, np.tile(unit, int(rng.integers(4, 30))),
                            0.02)
            reads.append(_revcomp(read) if rng.random() < 0.5 else read)
        return reads + _from_refs(rng, refs, 6, 1000, 4000, rate=0.0)
    raise ValueError(kind)


def _key(clusters):
    """Every field of every cluster, with the anchors' values and types."""
    return [(c.ref_id, c.rev_comp, c.read_start, c.read_end, c.ref_start,
             c.ref_end, c.n_hits, c.anchors_read.dtype.str,
             c.anchors_read.tolist(), c.anchors_ref.dtype.str,
             c.anchors_ref.tolist()) for c in clusters]


def _types(clusters):
    return [tuple(type(v).__name__ for v in c[:7]) for c in clusters]


# id: (reads, k, w, min_hits, cluster_radius)
CASES = {
    'repeats-k15': ('mapped', 15, 10, 3, 500),
    'repeats-k12': ('mapped', 12, 10, 3, 500),
    'n-runs': ('n_runs', 15, 10, 3, 500),
    'short-reads': ('short', 15, 10, 2, 500),
    'short-reads-w5': ('short', 15, 5, 2, 500),
    'empty-and-no-hits': ('empty', 15, 10, 3, 500),
    'tandem-ties': ('tandem', 12, 10, 2, 500),
    'tandem-radius-37': ('tandem', 12, 10, 3, 37),     # the unit: steps tie it
    'many-copies': ('copies', 15, 10, 3, 500),
    'min-hits-2-radius-60-w5': ('mapped', 15, 5, 2, 60),
    'fallback-k32': ('mapped', 32, 10, 3, 500),
}


@pytest.mark.parametrize('case', list(CASES))
def test_lookup_equals_jax(case, lib, tracing):
    kind, k, w, min_hits, radius = CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if kind == 'copies':
        refs, reads = _copies(rng)
    else:
        refs, unit = _references(rng)
        reads = _reads(kind, rng, refs, unit, k, w)
    jidx = jmz.MinimizerIndex(refs, k=k, w=w)
    tidx = tmz.MinimizerIndex(refs, k=k, w=w)
    kw = dict(cluster_radius=radius, min_hits=min_hits)

    want = [jidx.lookup(r, **kw) for r in reads]
    assert [_key(c) for c in jidx.lookup_many(reads, **kw)] == \
        [_key(c) for c in want]
    one = [tidx.lookup(r, **kw) for r in reads]
    many = tidx.lookup_many(reads, **kw)
    for got in (one, many):
        assert [_key(c) for c in got] == [_key(c) for c in want]
        assert [_types(c) for c in got] == [_types(c) for c in want]
    # the cases find clusters (short reads seldom have min_hits hits)
    least = {'empty': 0, 'short': 1}.get(kind, len(reads) // 3)
    assert sum(map(len, want)) >= least

    counters = trace.as_dict()['counters']
    native_route = k < 32
    assert counters.get('seed.native_reads', 0) == \
        (2 * len(reads) if native_route else 0)
    assert counters.get('seed.python_reads', 0) == \
        (0 if native_route else 2 * len(reads))


def _read_set(rng):
    """A polish-shaped set: two drafts, ~8x of 500-6,000 bp reads with 8%
    errors, a few of them chimeras of both drafts."""
    refs, _ = _references(rng)
    drafts = refs[:2]
    reads = _from_refs(rng, drafts, 60, 500, 6000, rate=0.08)
    for _ in range(4):
        a, b = _from_refs(rng, drafts, 2, 800, 2500, rate=0.08)
        reads.append(np.concatenate([a, b]))
    return drafts, reads


def _text(codes):
    return ''.join(BASES[codes])


def _mapped(mm, fastx, drafts, reads, **kw):
    references = [fastx.Reference(str(i + 1), _text(d))
                  for i, d in enumerate(drafts)]
    read_objs = [fastx.Read('read_%d' % i, _text(r), ',' * len(r))
                 for i, r in enumerate(reads)]
    got = mm.map_reads(references, read_objs, k=settings.SEED_KMER_SIZES[3],
                       w=10, **kw)
    return {name: [dict(vars(a)) for a in alns]
            for name, alns in got.items()}


@pytest.mark.parametrize('filters', [(False, False), (True, False),
                                     (False, True), (True, True)],
                         ids=['none', 'minimisers', 'overlaps', 'both'])
def test_map_reads_equals_jax(filters, lib):
    by_minimisers, overlaps = filters
    drafts, reads = _read_set(np.random.default_rng(7))
    kw = dict(filter_by_minimisers=by_minimisers, filter_overlaps=overlaps,
              allowed_overlap=settings.ALLOWED_MINIMAP_OVERLAP)
    want = _mapped(jmm, jfastx, drafts, reads, **kw)
    got = _mapped(tmm, tfastx, drafts, reads, **kw)
    assert got == want
    assert len(got) >= len(reads) * 3 // 4


def test_polish_mapping_counts_its_route(lib, tracing, monkeypatch):
    """A polish round's mapping (map_reads as asm/polish.polish_round
    calls it) counts every read under seed.native_reads and none under
    seed.python_reads; without the native library the counts swap and
    the clusters and alignments are the same."""
    drafts, reads = _read_set(np.random.default_rng(11))

    def mapping():
        trace.reset()
        got = _mapped(tmm, tfastx, drafts, reads)
        index = tmz.MinimizerIndex(drafts, k=settings.SEED_KMER_SIZES[3],
                                   w=10)
        clusters = [_key(c) for c in index.lookup_many(reads)]
        counters = trace.as_dict()['counters']
        return got, clusters, {k: v for k, v in counters.items()
                               if k.startswith('seed.')}

    got, clusters, counted = mapping()
    assert counted == {'seed.native_reads': 2 * len(reads)}
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    got_np, clusters_np, counted_np = mapping()
    assert counted_np == {'seed.python_reads': 2 * len(reads)}
    assert clusters_np == clusters
    assert got_np == got
    assert sum(map(len, clusters)) >= len(reads)


def test_probe_table_equals_searchsorted(lib):
    """Each distinct hash's run in the probe table is searchsorted's
    [left, right) in the index, the occurrence cap included, and a hash
    the index lacks finds nothing."""
    refs, _ = _references(np.random.default_rng(3))
    # every hash eight times or more: the repeats' runs pass the cap
    index = tmz.MinimizerIndex(refs * 8, k=12, w=4)
    table, bits = native.native_seed_table(index.hashes)
    pairs = table.reshape(-1, 2)
    full = pairs[pairs[:, 0] != np.iinfo(np.uint64).max]
    keys = np.unique(index.hashes)
    assert 2 * len(keys) <= len(pairs) < 4 * len(keys)
    order = np.argsort(full[:, 0])
    assert np.array_equal(full[order, 0], keys)
    lo = np.searchsorted(index.hashes, keys, side='left')
    hi = np.searchsorted(index.hashes, keys, side='right')
    assert np.array_equal(full[order, 1] >> np.uint64(32), lo)
    assert np.array_equal(full[order, 1] & np.uint64(0xFFFFFFFF), hi - lo)
