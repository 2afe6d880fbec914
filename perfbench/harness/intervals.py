"""Arithmetic on time intervals (start, end), in any one clock."""


def union(intervals, lo=None, hi=None):
    """The disjoint, sorted union of the intervals, each clipped to
    [lo, hi] where given. Nested and overlapping intervals (spans of
    threads that run at once, a span inside another) count once."""
    out = []
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals, lo=None, hi=None):
    """Seconds (in the intervals' unit) that the union covers."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out
