"""What a traced run (--trace 1) records, from the benchmark's own files.

- Spans: utils.trace.span of the program is replaced for the window by a
  span that keeps (name, thread, start, end) on the host clock and opens
  a torch.profiler.record_function of the same name, so that the device
  trace can name what the host was doing in each idle gap. The program's
  own span totals are not used.
- Launches: ops/cuda_lib.TIMINGS, the CUDA events the program records
  around each launch of its hand-written kernels when TIMINGS is a list.
- Work: ops/banded.align_banded and align_banded_async are wrapped, and
  the tasks handed to them and the alignments they gave are counted
  (costs/banded.py): the roofline's work, independent of launch layout.
- Device trace: torch.profiler over the window (CPU and CUDA activity),
  exported as a Chrome trace to TMPDIR, read, and deleted.
"""

import contextlib
import inspect
import json
import os
import tempfile
import threading
import time

from costs import banded as banded_costs

from . import intervals

WINDOW = 'perfbench.window'
JOB = 'perfbench.job'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Record(object):
    """What the layer metrics read. Times in seconds from the window's
    start: `spans` on the host clock, `launches` on the CUDA-event clock,
    `device_ops` and `annotations` on the profiler's clock."""

    def __init__(self):
        self.window_s = 0.0
        self.spans = []          # (name, thread id, start, end)
        self.launches = []       # (kernel name, start, end)
        self.work = {}           # route -> counts (costs/banded.Work)
        self.device_ops = []     # (name, start, end)
        self.annotations = []    # (name, thread id, start, end)
        self.trace_window_s = None

    def span_seconds(self, names):
        """Seconds of the window that spans of these names cover, counted
        once where they nest or run on several threads at once."""
        names = set(names)
        return intervals.covered(
            [(a, b) for n, _, a, b in self.spans if n in names],
            0.0, self.window_s)

    def job_spans(self, jobs, top=6):
        """Per job (start, end): {span name: seconds of the job that
        spans of that name cover}, for the `top` names that cover most
        of the window, so that slow jobs can be set against fast ones."""
        names = {}
        for n, _, a, b in self.spans:
            names[n] = names.get(n, 0.0) + (b - a)
        keep = sorted(names, key=lambda n: -names[n])[:top]
        return [{n: intervals.covered([(a, b) for m, _, a, b in self.spans
                                       if m == n], lo, hi) for n in keep}
                for lo, hi in jobs]

    def device_busy(self):
        """(busy seconds, window seconds, source) of the device: from the
        profiler's device activity where it recorded any, else from the
        union of the timed kernel launches."""
        if self.device_ops:
            return (intervals.covered([(a, b) for _, a, b in self.device_ops],
                                      0.0, self.trace_window_s),
                    self.trace_window_s, 'device_trace')
        if self.launches:
            return (intervals.covered([(a, b) for _, a, b in self.launches],
                                      0.0, self.window_s),
                    self.window_s, 'launch_events')
        return None


class Recorder(object):
    """Installs the recording for a window and takes it out again."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        self.profile = self.cuda
        self.record = Record()
        self._restore = []
        self._local = threading.local()
        self._work = banded_costs.Work()
        self._prof = None
        self._t0 = None

    # -- wrappers --------------------------------------------------------

    def _patch(self, obj, attr, value):
        self._restore.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def _span(self):
        spans, profile = self.record.spans, self.profile

        @contextlib.contextmanager
        def span(name):
            t0 = time.perf_counter()
            ctx = _record_function(name) if profile \
                else contextlib.nullcontext()
            with ctx:
                try:
                    yield
                finally:
                    spans.append((name, threading.get_ident(), t0,
                                  time.perf_counter()))
        return span

    def _counting(self, fn, handle=False):
        """fn wrapped so that the work of its outermost call on a thread
        is counted: a call made inside another (the CPU route of
        align_banded_async runs align_banded) is not counted twice."""
        sig = inspect.signature(fn)
        local, work = self._local, self._work

        def count(bound, results):
            a = bound.arguments
            work.add(a['tasks'], a['band'], results, a['need_cigar'])

        def run_outer(call):
            outer = not getattr(local, 'busy', False)
            local.busy = True
            try:
                return outer, call()
            finally:
                if outer:
                    local.busy = False

        class Handle(object):
            def __init__(self, inner, bound):
                self._inner, self._bound = inner, bound

            def collect(self):
                outer, res = run_outer(self._inner.collect)
                if outer:
                    count(self._bound, res)
                return res

        def wrapped(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            outer, res = run_outer(lambda: fn(*args, **kwargs))
            if handle:
                return Handle(res, bound) if outer else res
            if outer:
                count(bound, res)
            return res
        return wrapped

    # -- the window ------------------------------------------------------

    def start(self):
        """Install the wrappers and start recording; the window starts."""
        import torch
        from unicycler_tpu_torch.ops import banded, cuda_lib
        from unicycler_tpu_torch.utils import trace
        self._patch(trace, 'span', self._span())
        self._patch(banded, 'align_banded',
                    self._counting(banded.align_banded))
        self._patch(banded, 'align_banded_async',
                    self._counting(banded.align_banded_async, handle=True))
        self._patch(cuda_lib, 'TIMINGS', [])
        if self.cuda:
            torch.cuda.synchronize()
        if self.profile:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.start()
            self._window = _record_function(WINDOW)
            self._window.__enter__()
        if self.cuda:
            self._ev0 = torch.cuda.Event(enable_timing=True)
            self._ev0.record()
        self._t0 = time.perf_counter()
        return self._t0

    def job(self):
        """A context for one job (an annotation in the device trace)."""
        return _record_function(JOB) if self.profile \
            else contextlib.nullcontext()

    def stop(self, t_end):
        """End the window at host time t_end (after the last job and a
        synchronize), take the wrappers out, and read what was recorded."""
        import torch
        from unicycler_tpu_torch.ops import cuda_lib
        rec = self.record
        if self.cuda:
            torch.cuda.synchronize()
        if self.profile:
            self._window.__exit__(None, None, None)
            self._prof.stop()
        timings = cuda_lib.TIMINGS
        for obj, attr, value in reversed(self._restore):
            setattr(obj, attr, value)
        self._restore = []
        rec.window_s = t_end - self._t0
        rec.spans = [(n, tid, a - self._t0, b - self._t0)
                     for n, tid, a, b in rec.spans]
        rec.launches = [(name, self._ev0.elapsed_time(e0) / 1e3,
                         self._ev0.elapsed_time(e1) / 1e3)
                        for name, e0, e1, _ in timings] if self.cuda else []
        rec.work = {k: dict(v) for k, v in self._work.by_route.items()}
        if self.profile:
            fd, path = tempfile.mkstemp(suffix='.json')
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    read_chrome_trace(json.load(f), rec)
            finally:
                os.unlink(path)
            self._prof = None
        return rec


def _record_function(name):
    from torch.profiler import record_function
    return record_function(name)


def read_chrome_trace(doc, rec):
    """Fill rec.device_ops, rec.annotations and rec.trace_window_s from a
    Chrome trace of torch.profiler, with times from the window's start."""
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    window = [e for e in events if e.get('ph') == 'X'
              and e.get('name') == WINDOW
              and e.get('cat') == 'user_annotation']
    if not window:
        return rec
    w0 = float(window[0]['ts'])
    rec.trace_window_s = float(window[0]['dur']) / 1e6
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        a = (float(e['ts']) - w0) / 1e6
        b = a + float(e['dur']) / 1e6
        if e.get('cat') in DEVICE_CATS:
            rec.device_ops.append((e.get('name', '?'), a, b))
        elif e.get('cat') == 'user_annotation' and e['name'] != WINDOW:
            rec.annotations.append((e['name'], e.get('tid'), a, b))
    return rec


def breakdown(rec, top=10):
    """The traced window's `breakdown`: the device operations that took
    most time, by name, and the device's idle seconds by the innermost
    host span open in the middle of each gap."""
    if rec.trace_window_s is None:
        return None
    ops = {}
    for name, a, b in rec.device_ops:
        ops[name] = ops.get(name, 0.0) + (b - a)
    idle = {}
    spans = sorted(rec.annotations, key=lambda x: x[2])
    for a, b in intervals.gaps([(x, y) for _, x, y in rec.device_ops],
                               0.0, rec.trace_window_s):
        mid, name = (a + b) / 2, 'between jobs'
        for n, _, x, y in spans:
            if x > mid:
                break
            if y >= mid:
                if n != JOB:
                    name = n
                elif name == 'between jobs':
                    name = 'job, outside spans'
        idle[name] = idle.get(name, 0.0) + (b - a)
    return {'device_ops': sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:top],
            'idle_gaps': sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:top]}
