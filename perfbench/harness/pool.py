"""Shares of a traced window spent in spans that run on the program's
seeding pool (align/semi_global.py): each span's seconds, clipped to the
window, summed over every thread, over the window times the pool's
worker count. A pool busy on every worker all through the window reads
100%."""


def size():
    """The seeding pool's worker count, or None where the program has no
    such pool."""
    try:
        from unicycler_tpu_torch.align.semi_global import seed_threads
    except ImportError:
        return None
    return seed_threads()


def share(rec, names):
    """Percent of the pool's thread-seconds in the window that spans of
    these names hold; None where the record has none of them."""
    if rec is None or not any(s[0] in names for s in rec.spans):
        return None
    workers = size()
    if not workers or rec.window_s <= 0:
        return None
    held = sum(max(0.0, min(b, rec.window_s) - max(a, 0.0))
               for n, _, a, b in rec.spans if n in names)
    return 100.0 * held / (rec.window_s * workers)
