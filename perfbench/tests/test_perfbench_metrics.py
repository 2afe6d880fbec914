"""Each metric's arithmetic on recorded spans, launches, work and device
activity, nested and threaded spans included."""

import pytest

from harness import intervals, spec, tracing


class Run(object):
    def __init__(self, record=None, jobs=(), setup_s=None):
        self.record, self.jobs, self.setup_s = record, list(jobs), setup_s


def _read(name, kind='layer_metrics'):
    cell = spec.Cell('align.bact5m')
    return cell.readers(kind)[name]


def _record(window=10.0):
    rec = tracing.Record()
    rec.window_s = window
    return rec


def test_intervals():
    assert intervals.union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == \
        [(0, 3), (5, 6)]
    assert intervals.covered([(0, 2), (1, 3), (5, 6)], 0.5, 5.5) == 3.0
    assert intervals.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert intervals.gaps([], 0, 2) == [(0, 2)]


def test_job_spans_split_the_spans_by_job():
    rec = _record(10.0)
    rec.spans = [('seed_and_tasks', 1, 0.0, 2.0),
                 ('seed_and_tasks', 2, 1.0, 3.0),     # another thread
                 ('votes', 1, 3.0, 4.5),              # across two jobs
                 ('tape_fetch', 1, 6.0, 6.5)]
    got = rec.job_spans([(0.0, 4.0), (4.0, 8.0)], top=2)
    assert got == [{'seed_and_tasks': 3.0, 'votes': 1.0},
                   {'seed_and_tasks': 0.0, 'votes': 0.5}]


def test_seed_share_counts_nested_and_threaded_spans_once():
    rec = _record(10.0)
    rec.spans = [('seed_index', 1, 0.0, 1.0),
                 ('seed_and_tasks', 1, 0.5, 2.0),     # overlaps the index
                 ('seed_and_tasks', 2, 1.5, 3.0),     # another thread
                 ('map_reads', 3, 2.5, 4.0),
                 ('seed_and_tasks', 1, 9.5, 11.0),    # past the window
                 ('tape_build', 1, 4.0, 6.0)]
    assert _read('seed_share')(Run(rec)) == pytest.approx(45.0)


def test_share_is_absent_without_its_spans():
    rec = _record()
    rec.spans = [('votes', 1, 0.0, 1.0)]
    assert _read('seed_share')(Run(rec)) is None
    assert _read('tape_host_share')(Run(rec)) is None
    assert _read('seed_share')(Run(None)) is None


def test_tape_host_share():
    rec = _record(4.0)
    rec.spans = [('tape_build', 1, 0.0, 1.0), ('tape_fetch', 1, 0.5, 1.5),
                 ('tape_decode', 1, 2.0, 2.5), ('dispatch', 1, 0.0, 4.0)]
    assert _read('tape_host_share')(Run(rec)) == pytest.approx(50.0)


def _work():
    from costs import banded
    work = banded.Work()

    class T(object):
        def __init__(self, n, m):
            self.q, self.r = [0] * n, [0] * m

    class P(object):
        def __init__(self, cigar):
            self.cigar = cigar

    work.add([T(1000, 1200), T(0, 50), T(500, 600)], 200,
             [P([(900, 'M'), (10, 'I'), (90, 'M')]), None,
              P([(500, 'M'), (3, 'D')])], True)
    return work


def test_work_counts_rows_times_width_and_steps():
    from costs import banded
    w = _work().by_route['wave']
    assert w['rows'] == 1500 and w['steps'] == 1503 and w['tasks'] == 3
    assert w['fwd_ops'] == 1500 * 512 * banded.OPS_PER_CELL
    assert w['fwd_bytes'] == 1500 + 1800 + 1500 * 512 // 2 + 3 * 12
    assert w['walk_ops'] == 1503 * banded.OPS_PER_STEP_WALK
    assert w['walk_bytes'] == 1503 * banded.BYTES_PER_STEP_WALK
    assert banded.band_width(200) == 512 and banded.band_width(300) == 1024
    assert banded.band_width(1500) == 4096
    assert banded.band_width(10) == 128


def test_roofline_wave():
    from costs import banded
    rec = _record(10.0)
    rec.work = {k: dict(v) for k, v in _work().by_route.items()}
    rec.launches = [('wavetape_fwd', 1.0, 1.002), ('wavetape_walk', 1.002,
                                                   1.003),
                    ('banded', 2.0, 3.0)]
    peak = banded.peaks()
    w = rec.work['wave']
    bound = max(w['fwd_ops'] / peak['int32_ops_per_s'],
                w['fwd_bytes'] / peak['bytes_per_s']) \
        + max(w['walk_ops'] / peak['int32_ops_per_s'],
              w['walk_bytes'] / peak['bytes_per_s'])
    got = _read('roofline.wave')(Run(rec))
    assert got == pytest.approx(100 * bound / 0.003)
    assert 0 < got < 100
    rec.launches = []
    assert _read('roofline.wave')(Run(rec)) is None


def test_device_idle_from_trace_and_from_launches():
    rec = _record(10.0)
    rec.trace_window_s = 8.0
    rec.device_ops = [('k1', 0.0, 1.0), ('k2', 0.5, 2.0), ('copy', 7.0,
                                                            9.0)]
    assert _read('device_idle')(Run(rec)) == pytest.approx(100 * 5 / 8)
    rec.device_ops = []
    rec.launches = [('wavetape_fwd', 1.0, 2.0), ('wavetape_walk', 1.5, 3.0)]
    assert _read('device_idle')(Run(rec)) == pytest.approx(80.0)
    assert rec.device_busy()[2] == 'launch_events'
    assert _read('device_idle')(Run(_record())) is None


def test_chrome_trace_and_breakdown():
    ev = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': tracing.WINDOW,
         'ts': 1000.0, 'dur': 10e6, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': tracing.JOB,
         'ts': 1000.0, 'dur': 9e6, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'seed_and_tasks',
         'ts': 1000.0, 'dur': 4e6, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'tape_fetch',
         'ts': 1000.0 + 5e6, 'dur': 1e6, 'tid': 1},
        {'ph': 'X', 'cat': 'kernel', 'name': 'wavetape_fwd',
         'ts': 1000.0 + 4e6, 'dur': 1.5e6},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoH',
         'ts': 1000.0 + 5.5e6, 'dur': 0.5e6},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::copy_',
         'ts': 1000.0 + 5.5e6, 'dur': 0.5e6},
        {'ph': 'i', 'cat': 'kernel', 'name': 'instant', 'ts': 1000.0},
    ]
    rec = tracing.read_chrome_trace({'traceEvents': ev}, tracing.Record())
    assert rec.trace_window_s == pytest.approx(10.0)
    assert sorted(n for n, _, _ in rec.device_ops) == ['Memcpy DtoH',
                                                        'wavetape_fwd']
    busy, window, source = rec.device_busy()
    assert (busy, window, source) == (pytest.approx(2.0), 10.0,
                                      'device_trace')
    parts = tracing.breakdown(rec)
    assert parts['device_ops'][0] == ['wavetape_fwd', pytest.approx(1.5)]
    idle = dict(parts['idle_gaps'])
    assert idle['seed_and_tasks'] == pytest.approx(4.0)
    # a gap is named by what was open at its middle: 6-10 s at 8 s
    assert idle['job, outside spans'] == pytest.approx(4.0)
    assert sum(idle.values()) == pytest.approx(8.0)


def test_end_to_end_readers():
    jobs = [{'start': 0.0, 'end': 4.0, 'bases': 2_000_000, 'ok': True},
            {'start': 4.0, 'end': 9.0, 'bases': 2_500_000, 'ok': True},
            {'start': 9.0, 'end': 12.0, 'bases': 0, 'ok': False}]
    rate = _read('read_kbp_per_s', 'end_to_end')
    assert rate(Run(jobs=jobs)) == pytest.approx(4500 / 9.0)
    assert rate(Run(jobs=jobs[2:])) is None
    assert _read('setup_s', 'end_to_end')(Run(setup_s=12.5)) == 12.5
