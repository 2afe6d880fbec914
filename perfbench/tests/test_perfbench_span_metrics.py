"""The readers of the seeding pool's, the tape wait's and the indel
left-alignment's spans, on synthetic records: thread-seconds summed over
the pool's threads and clipped to the window, the pool's size as the
denominator, the union where spans overlap, and nothing where the spans
are absent."""

import pytest

from harness import spec, tracing

POOL = ('seed_pool_share', 'seed_lookup_share', 'fine_anchor_share')
NEW = POOL + ('tape_wait_share', 'left_align_share')


class Run(object):
    def __init__(self, record=None):
        self.record = record


def _read(name, cell='align.bact5m'):
    return spec.Cell(cell).readers('layer_metrics')[name]


def _record(spans, window=10.0):
    rec = tracing.Record()
    rec.window_s = window
    rec.spans = spans
    return rec


def _pool_spans(name):
    # three pool threads; the main thread's wait is another name
    return [(name, 11, 0.0, 4.0), (name, 12, 1.0, 3.0),
            (name, 13, 2.0, 6.0),
            (name, 11, 9.0, 12.0),              # clipped to 9-10
            (name, 12, -1.0, 0.5),              # clipped to 0-0.5
            ('seed_and_tasks', 1, 0.0, 10.0)]


@pytest.mark.parametrize('name,span', [('seed_pool_share', 'seed_read'),
                                       ('seed_lookup_share', 'seed_lookup'),
                                       ('fine_anchor_share', 'fine_anchors')])
def test_pool_share_sums_thread_seconds_over_the_pool(name, span,
                                                      monkeypatch):
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '3')
    read = _read(name)
    rec = _record(_pool_spans(span))
    # 4 + 2 + 4 + 1 + 0.5 thread-seconds of 3 threads x 10 s
    assert read(Run(rec)) == pytest.approx(100 * 11.5 / 30)
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '5')
    assert read(Run(rec)) == pytest.approx(100 * 11.5 / 50)
    # a pool busy on every thread all through the window reads 100%
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '3')
    full = _record([(span, t, 0.0, 10.0) for t in (11, 12, 13)])
    assert read(Run(full)) == pytest.approx(100.0)


@pytest.mark.parametrize('name', POOL)
def test_pool_share_counts_only_its_own_span(name, monkeypatch):
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '3')
    rec = _record([('seed_read', 11, 0.0, 3.0),
                   ('seed_lookup', 11, 0.0, 1.0),
                   ('fine_anchors', 11, 1.0, 3.0)])
    want = {'seed_pool_share': 3.0, 'seed_lookup_share': 1.0,
            'fine_anchor_share': 2.0}[name]
    assert _read(name)(Run(rec)) == pytest.approx(100 * want / 30)


@pytest.mark.parametrize('name', NEW)
def test_absent_without_its_spans(name):
    read = _read(name, 'polish.bact5m' if name == 'left_align_share'
                 else 'align.bact5m')
    assert read(Run(None)) is None
    assert read(Run(_record([('seed_and_tasks', 1, 0.0, 1.0),
                             ('votes', 1, 1.0, 2.0),
                             ('tape_fetch', 1, 2.0, 3.0)]))) is None


def test_pool_share_needs_the_pool(monkeypatch):
    """A program without a seeding pool (the parent of the pool's spans)
    gives no pool share."""
    from harness import pool
    monkeypatch.setattr(pool, 'size', lambda: None)
    rec = _record([('seed_read', 11, 0.0, 3.0)])
    assert _read('seed_pool_share')(Run(rec)) is None


def test_tape_wait_share_counts_the_union():
    rec = _record([('tape_fetch', 1, 0.0, 4.0),
                   ('tape_wait', 1, 0.0, 1.0),
                   ('tape_wait', 2, 0.5, 1.5),      # another thread
                   ('tape_copy', 1, 1.5, 4.0),
                   ('tape_wait', 1, 9.5, 11.0)], window=10.0)
    assert _read('tape_wait_share')(Run(rec)) == pytest.approx(20.0)


def test_left_align_share_counts_the_union():
    rec = _record([('votes', 1, 0.0, 6.0),
                   ('left_align', 1, 0.0, 1.0),
                   ('vote_add', 1, 1.0, 1.5),
                   ('left_align', 1, 1.5, 3.0),
                   ('consensus_call', 1, 5.0, 6.0)], window=5.0)
    assert _read('left_align_share', 'polish.bact5m')(Run(rec)) == \
        pytest.approx(50.0)


def test_cells_find_the_new_metrics():
    align = {m['name']: m for m in spec.Cell('align.bact5m').per_layer}
    polish = {m['name']: m for m in spec.Cell('polish.bact5m').per_layer}
    assert set(NEW) - {'left_align_share'} <= set(align)
    assert 'left_align_share' not in align
    assert {'tape_wait_share', 'left_align_share'} <= set(polish)
    assert not set(POOL) & set(polish)
    for m in list(align.values()) + list(polish.values()):
        if m['name'] in NEW:
            assert (m['source'], m['unit'], m['better'], m['moves']) == \
                ('program_span', '%', 'lower', 'read_kbp_per_s')
    assert align['seed_pool_share']['layer'] == \
        align['seed_share']['layer'] == 'seeding and mapping (host)'
    assert align['tape_wait_share']['layer'] == \
        align['tape_host_share']['layer']
    assert polish['left_align_share']['layer'] == \
        polish['votes_share']['layer']
    for cell in ('align.bact5m', 'polish.bact5m'):
        readers = spec.Cell(cell).readers('layer_metrics')
        assert all(callable(readers[n]) for n in NEW if n in readers)
