"""The port's trace module (unicycler_tpu_torch/utils/trace.py) and the
spans the aligner and the polish round open for it.

Spans nest into path totals, leave events with a thread, a start, an end,
CPU seconds and a parent, carry the submitting span into pool threads
that run in a copy of its context, appear in a torch.profiler trace, and
cost one shared no-op context when tracing is off. The file imports
nothing of JAX; its `gpu` test runs on the card with

    UNICYCLER_TPU_TESTS=1 python -m pytest tests/test_torch_trace.py -m gpu
"""

import contextvars
import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per test process)

from unicycler_tpu_torch.utils import trace


@pytest.fixture
def tracing():
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()


def _events(name=None):
    return [e for e in trace.as_dict()['events']
            if name is None or e['name'] == name]


def test_spans_nest_into_path_totals(tracing):
    with trace.span('outer'):
        with trace.span('inner'):
            pass
        with trace.span('inner'):
            trace.add('rows', 3)
    with trace.span('outer'):
        pass
    d = trace.as_dict()
    assert {p: s['calls'] for p, s in d['spans'].items()} == \
        {'outer': 2, 'outer/inner': 2}
    assert d['spans']['outer']['seconds'] >= \
        d['spans']['outer/inner']['seconds'] >= 0
    assert d['counters'] == {'rows': 3.0}
    text = trace.report()
    assert 'outer' in text and '  inner' in text and 'events: 4 kept' in text


def test_events_have_thread_start_end_cpu_and_parent(tracing):
    with trace.span('outer'):
        with trace.span('inner'):
            sum(range(10000))
    (outer,), (inner,) = _events('outer'), _events('inner')
    me = threading.get_ident()
    assert outer['thread'] == inner['thread'] == me
    assert outer['parent'] is None and inner['parent'] == outer['id']
    assert inner['path'] == 'outer/inner'
    assert outer['start'] <= inner['start'] <= inner['end'] <= outer['end']
    assert 0.0 <= inner['cpu_s'] and 0.0 <= outer['cpu_s']


def test_pool_thread_names_the_submitting_span_as_parent(tracing):
    def work():
        with trace.span('work'):
            return threading.get_ident()

    with ThreadPoolExecutor(max_workers=2) as pool:
        with trace.span('submit'):
            copied = pool.submit(contextvars.copy_context().run, work)
            worker = copied.result(timeout=30)
        bare = pool.submit(work).result(timeout=30)
    (submit,) = _events('submit')
    first, second = _events('work')
    assert worker != threading.get_ident() and first['thread'] == worker
    assert first['parent'] == submit['id'] and first['path'] == 'submit/work'
    # a thread that runs outside the submitter's context starts at the root
    assert second['thread'] == bare and second['parent'] is None
    assert trace.as_dict()['spans']['work']['calls'] == 1


def test_threads_lose_no_span_or_counter(tracing):
    threads, per = 12, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with trace.span('stress'):
                    trace.add('stress.calls')
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    d = trace.as_dict()
    assert d['spans']['stress']['calls'] == threads * per
    assert d['counters']['stress.calls'] == threads * per
    assert len(d['events']) == threads * per
    assert len({e['id'] for e in d['events']}) == threads * per


def test_disabled_records_nothing_through_one_shared_context():
    trace.reset()
    trace.disable()
    first, second = trace.span('a'), trace.span('b')
    assert first is second
    with first:
        with second:
            trace.add('rows', 5)
    assert trace.as_dict() == {'spans': {}, 'counters': {}, 'events': []}
    assert trace.report() == ''


def test_span_appears_in_a_profiler_trace(tracing, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('trace_probe_span'):
            torch.ones(8).add_(1)
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    assert any(e.get('name') == 'trace_probe_span'
               and e.get('cat') == 'user_annotation' for e in events)
    assert len(_events('trace_probe_span')) == 1


# -- the program's spans -------------------------------------------------

def _alignment_inputs():
    """Six 400 bp reads with ~2.7% substitutions over a 3 kbp reference."""
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.io.fastx import Read, Reference
    rng = np.random.RandomState(42)
    ref_seq = ''.join('ACGT'[b] for b in rng.randint(0, 4, 3000))
    reads = []
    for i in range(6):
        seq = list(ref_seq[200 * i:200 * i + 400])
        for p in range(0, 400, 37):
            seq[p] = 'ACGT'[('ACGT'.index(seq[p]) + 1) % 4]
        reads.append(Read('read_%d' % i, ''.join(seq),
                          '+' * len(seq)))
    return reads, [Reference('ref', ref_seq)], \
        AlignmentScoringScheme('3,-6,-5,-2')


def _align(device):
    from unicycler_tpu_torch.align.semi_global import align_reads_to_refs
    reads, refs, scheme = _alignment_inputs()
    align_reads_to_refs(reads, refs, scheme, low_score_threshold=60.0,
                        min_align_length=20, device=device)
    assert all(r.alignments for r in reads)


def test_host_route_spans_the_seeding(tracing):
    _align('cpu')
    spans = trace.as_dict()['spans']
    assert spans['seed_and_tasks/seed_lookup']['calls'] == 6
    assert spans['seed_and_tasks/fine_anchors']['calls'] >= 6


def test_device_driver_seeds_on_pool_threads(tracing, monkeypatch):
    """align_jobs' device driver on the CPU (the kernels' plain versions):
    each read's seeding runs on a pool thread under `seed_read`, whose
    parent is the span open where the reads were submitted, and the
    fetch splits into the wait and the copy."""
    from unicycler_tpu_torch.align import semi_global as sg
    from unicycler_tpu_torch.ops import banded as bo
    cpu = torch.device('cpu')
    monkeypatch.setattr(bo, 'has_device_traceback', lambda device=None: True)
    monkeypatch.setattr(
        bo, 'align_banded_async',
        lambda tasks, scoring, config, band, need_cigar, device:
        bo._AsyncAlign(tasks, scoring, config, bo.band_width(band),
                       need_cigar, cpu))
    with trace.span('call'):
        _align(cpu)
    (call,) = _events('call')
    reads = _events('seed_read')
    assert len(reads) == 6
    assert all(e['parent'] == call['id'] for e in reads)
    assert {e['thread'] for e in reads} <= {
        t.ident for t in sg._seed_pool()._threads}
    by_id = {e['id']: e for e in reads}
    for name in ('seed_lookup', 'fine_anchors'):
        inner = _events(name)
        assert inner and all(e['parent'] in by_id for e in inner)
    assert len(_events('seed_lookup')) == 6
    assert len(_events('seed_and_tasks')) == 6
    spans = trace.as_dict()['spans']
    fetch = [p for p in spans if p.endswith('tape_fetch')]
    assert fetch
    for p in fetch:
        assert spans[p + '/tape_wait']['calls'] == spans[p]['calls']
        assert spans[p + '/tape_copy']['calls'] == spans[p]['calls']
    assert sg.seed_threads() == sg._seed_pool()._max_workers


def test_seed_threads_reads_the_environment(monkeypatch):
    from unicycler_tpu_torch.align.semi_global import seed_threads
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '5')
    assert seed_threads() == 5
    monkeypatch.setenv('UNICYCLER_TPU_SEED_THREADS', '0')
    assert seed_threads() == 1
    monkeypatch.delenv('UNICYCLER_TPU_SEED_THREADS')
    assert seed_threads() == 3


class _Segment(object):
    def __init__(self, seq):
        self.forward_sequence = seq

    def get_length(self):
        return len(self.forward_sequence)


class _Graph(object):
    def __init__(self, segments):
        self.segments = segments


def _polish_round():
    from unicycler_tpu_torch import synth
    from unicycler_tpu_torch.align.scoring import AlignmentScoringScheme
    from unicycler_tpu_torch.asm.polish import polish_round
    from unicycler_tpu_torch.io.fastx import Read
    rng = np.random.default_rng(5)
    genome = synth.random_replicons(rng, [4000])[0]
    reads = [Read(n, s, '+' * len(s)) for n, s, _ in synth.simulate_read_set(
        rng, [genome], 6, n50=1500, min_len=1000, max_len=2000)]
    polished, _, _ = polish_round(
        _Graph({'1': _Segment(genome)}), reads,
        AlignmentScoringScheme('3,-6,-5,-2').to_ops(), device='cpu')
    assert set(polished) == {'1'}
    return trace.as_dict()


def test_polish_round_splits_the_votes(tracing):
    spans = _polish_round()['spans']
    assert spans['votes/left_align']['calls'] >= 1
    assert spans['votes/vote_add']['calls'] == \
        spans['votes/left_align']['calls']
    assert spans['votes/consensus_call']['calls'] == 1
    assert spans['votes']['calls'] == 1


def test_polish_round_counts_how_its_alignments_were_voted(tracing,
                                                         monkeypatch):
    """votes.native_alignments with the native library, one batch a
    round; votes.python_alignments without it, one left_align and one
    vote_add span an alignment: the same alignments either way."""
    from unicycler_tpu_torch import native
    if native.get_lib() is None:
        pytest.skip('no C++ toolchain for the native library')
    batch = _polish_round()
    assert batch['spans']['votes/left_align']['calls'] == \
        batch['spans']['votes/vote_add']['calls'] == \
        batch['spans']['votes/consensus_call']['calls'] == 1
    trace.reset()
    monkeypatch.setattr(native, 'get_lib', lambda: None)
    fallback = _polish_round()
    voted = fallback['spans']['votes/left_align']['calls']
    assert voted >= 2
    assert fallback['spans']['votes/vote_add']['calls'] == voted

    def counted(d):
        return {k: v for k, v in d['counters'].items()
                if k.startswith('votes.')}
    assert counted(fallback) == {'votes.python_alignments': voted}
    assert counted(batch) == {'votes.native_alignments': voted}


@pytest.mark.gpu
def test_gpu_tape_fetch_splits_into_wait_and_copy(tracing):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from torch_parity import SCORING_T, tasks_np
    from unicycler_tpu_torch.ops import banded as bo
    from unicycler_tpu_torch.ops.pairwise import SEMI_GLOBAL, Scoring
    tasks = [bo.BandedTask(*t)
             for t in tasks_np(11, [60, 120, 200, 330, 90, 170], True)]
    got = bo.align_banded(tasks, Scoring(*SCORING_T), SEMI_GLOBAL, 200,
                          True, device=torch.device('cuda'))
    assert all(pa is not None for pa in got)
    fetch = _events('tape_fetch')
    assert fetch
    for name in ('tape_wait', 'tape_copy'):
        inner = _events(name)
        assert len(inner) == len(fetch)
        assert {e['parent'] for e in inner} == {e['id'] for e in fetch}
    wait, copy = _events('tape_wait'), _events('tape_copy')
    for f, w, c in zip(fetch, wait, copy):
        assert f['start'] <= w['start'] <= w['end'] <= c['start'] \
            <= c['end'] <= f['end']
