"""Lightweight tracing of pipeline stages: a timeline of spans plus
accumulated counters, process-global, costing next to nothing when off.

Enable with UNICYCLER_TPU_TRACE=1 (or trace.enable()); read back with
trace.report() / trace.as_dict(), or let the pipeline print the report at
exit via report_at_exit().

- Spans nest. `as_dict()['spans']` holds each span path's total wall
  seconds and calls; the report prints them as a tree.
- Each span also leaves an event (`as_dict()['events']`): its name, path,
  thread, start and end on time.perf_counter, the thread CPU seconds it
  spent (time.thread_time), its own id and its parent's id. The open span
  lives in a contextvars.ContextVar, so work handed to a pool through
  contextvars.copy_context().run names the submitting span as its parent.
- While a torch.profiler is recording, a span also opens
  torch.profiler.record_function(name), so the device trace carries the
  program's spans on its own clock.
- Counters (`as_dict()['counters']`) add up named quantities: rows,
  bytes, launches.
"""

import atexit
import contextlib
import contextvars
import itertools
import os
import sys
import threading
import time
from collections import defaultdict

_enabled = os.environ.get('UNICYCLER_TPU_TRACE') == '1'
_current = contextvars.ContextVar('unicycler_tpu_torch_span', default=None)
_lock = threading.Lock()
_ids = itertools.count(1)
_spans = {}          # path -> [total seconds, calls]
_counters = defaultdict(float)
_events = []         # (id, parent id, name, path, thread, start, end, cpu)
_dropped = [0]
# a long traced pipeline keeps at most this many events (~150 MB); later
# spans still add to the path totals, and the report counts what was
# dropped
MAX_EVENTS = 1_000_000
_NOOP = contextlib.nullcontext()


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def reset():
    _current.set(None)
    with _lock:
        _spans.clear()
        _counters.clear()
        del _events[:]
        _dropped[0] = 0


def _profiler_recording():
    torch = sys.modules.get('torch')    # no torch imported: no profiler
    return torch is not None and torch.autograd._profiler_enabled()


class _Span(object):
    __slots__ = ('name', 'id', 'parent', 'path', 'token', 'annotation',
                 't0', 'c0')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        parent = _current.get()
        self.id = next(_ids)
        self.parent = parent
        self.path = self.name if parent is None \
            else parent.path + '/' + self.name
        self.token = _current.set(self)
        self.annotation = None
        if _profiler_recording():
            from torch.profiler import record_function
            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        cpu = time.thread_time() - self.c0
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _current.reset(self.token)
        parent = self.parent
        with _lock:
            ent = _spans.setdefault(self.path, [0.0, 0])
            ent[0] += t1 - self.t0
            ent[1] += 1
            if len(_events) < MAX_EVENTS:
                _events.append((self.id,
                                None if parent is None else parent.id,
                                self.name, self.path, threading.get_ident(),
                                self.t0, t1, cpu))
            else:
                _dropped[0] += 1
        return False


def span(name):
    """Time a (possibly nested) stage: `with trace.span('name'):`. When
    tracing is off this returns one shared no-op context manager."""
    if not _enabled:
        return _NOOP
    return _Span(name)


def add(counter, value=1.0):
    """Accumulate a named counter (rows aligned, bytes fetched, ...)."""
    if _enabled:
        with _lock:
            _counters[counter] += value


_EVENT_KEYS = ('id', 'parent', 'name', 'path', 'thread', 'start', 'end',
               'cpu_s')


def as_dict():
    with _lock:
        spans = sorted(_spans.items())
        counters = sorted(_counters.items())
        events = list(_events)
    return {
        'spans': {path: {'seconds': round(t, 4), 'calls': c}
                  for path, (t, c) in spans},
        'counters': dict(counters),
        'events': [dict(zip(_EVENT_KEYS, e)) for e in events],
    }


def report(out=None):
    """Human-readable tree of spans + counters."""
    with _lock:
        spans = sorted(_spans.items())
        counters = sorted(_counters.items())
        n_events, dropped = len(_events), _dropped[0]
    lines = []
    for path, (t, c) in spans:
        depth = path.count('/')
        name = path.rsplit('/', 1)[-1]
        lines.append('%s%-40s %8.3f s  x%d'
                     % ('  ' * depth, name, t, c))
    if counters:
        lines.append('counters:')
        for k, v in counters:
            lines.append('  %-40s %s' % (k, ('%d' % v) if v == int(v)
                                         else ('%.3f' % v)))
    if n_events or dropped:
        lines.append('events: %d kept, %d dropped' % (n_events, dropped))
    text = '\n'.join(lines)
    if out is not None:
        out(text)
    return text


def report_at_exit():
    """Print the trace when the process ends (used when the env var is
    set so `UNICYCLER_TPU_TRACE=1 unicycler ...` just works)."""
    def _dump():
        if _spans or _counters:
            print('\n=== unicycler_tpu trace ===')
            print(report())
    atexit.register(_dump)


if _enabled:
    report_at_exit()
