"""Share of the traced window in the host side of the banded route
(ops/banded.py): tape_build (laying tasks out), tape_fetch (copying the
kernels' outputs back, which includes waiting for the device to finish
them) and tape_decode (records to CIGARs). Counted once where spans nest
or overlap."""

NAMES = ('tape_build', 'tape_fetch', 'tape_decode')


def read(run):
    rec = run.record
    if rec is None or not any(s[0] in NAMES for s in rec.spans):
        return None
    return 100.0 * rec.span_seconds(NAMES) / rec.window_s
