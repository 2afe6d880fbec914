"""Share of the traced window in which the host blocks on the card
before copying the kernels' outputs back (span `tape_wait` of
ops/banded._tape_collect, inside tape_fetch). Near 0, the host sets the
pace."""

NAMES = ('tape_wait',)


def read(run):
    rec = run.record
    if rec is None or not any(s[0] in NAMES for s in rec.spans):
        return None
    return 100.0 * rec.span_seconds(NAMES) / rec.window_s
