"""Lightweight tracing/profiling for pipeline stages and device launches.

The reference has no tracing subsystem beyond verbosity logging; for a
production TPU service the minimum is per-stage wall time plus per-launch
device metrics (rows, bytes moved, launch count). This module keeps a
process-global trace that costs ~nothing when disabled.

Enable with UNICYCLER_TPU_TRACE=1 (or trace.enable()); read back with
trace.report() / trace.as_dict(), or let the pipeline print it at exit
via report_at_exit(). Spans nest: the report shows a tree with wall
times, call counts, and accumulated counters (rows, bytes, launches).
"""

import atexit
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

_enabled = os.environ.get('UNICYCLER_TPU_TRACE') == '1'
_tls = __import__('threading').local()


def _get_stack():
    # per-thread span stacks: bridge finalisation runs span-bearing
    # device calls on a thread pool
    st = getattr(_tls, 'stack', None)
    if st is None:
        st = _tls.stack = []
    return st
_spans = {}          # path -> [total_time, calls]
_counters = defaultdict(float)


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def is_enabled():
    return _enabled


def reset():
    _get_stack().clear()
    _spans.clear()
    _counters.clear()


@contextmanager
def span(name):
    """Time a (possibly nested) stage. No-op when tracing is disabled."""
    if not _enabled:
        yield
        return
    _stack = _get_stack()
    _stack.append(name)
    path = '/'.join(_stack)
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        ent = _spans.setdefault(path, [0.0, 0])
        ent[0] += dt
        ent[1] += 1
        _stack.pop()


def add(counter, value=1.0):
    """Accumulate a named counter (rows aligned, bytes fetched, ...)."""
    if _enabled:
        _counters[counter] += value


def as_dict():
    return {
        'spans': {path: {'seconds': round(t, 4), 'calls': c}
                  for path, (t, c) in sorted(_spans.items())},
        'counters': {k: v for k, v in sorted(_counters.items())},
    }


def report(out=None):
    """Human-readable tree of spans + counters."""
    lines = []
    for path, (t, c) in sorted(_spans.items()):
        depth = path.count('/')
        name = path.rsplit('/', 1)[-1]
        lines.append('%s%-40s %8.3f s  x%d'
                     % ('  ' * depth, name, t, c))
    if _counters:
        lines.append('counters:')
        for k, v in sorted(_counters.items()):
            lines.append('  %-40s %s' % (k, ('%d' % v) if v == int(v)
                                         else ('%.3f' % v)))
    text = '\n'.join(lines)
    if out is not None:
        out(text)
    return text


def save_json(path):
    with open(path, 'w') as f:
        json.dump(as_dict(), f, indent=2)


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
