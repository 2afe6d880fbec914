"""Share of the traced window in the program's seeding and mapping
spans: seed_index and seed_and_tasks (align/semi_global.py: the index
lookup, and the main thread's wait for each read's seeds and tasks) and
map_reads (asm/polish.py). Counted once where spans nest or overlap."""

NAMES = ('seed_index', 'seed_and_tasks', 'map_reads')


def read(run):
    rec = run.record
    if rec is None or not any(s[0] in NAMES for s in rec.spans):
        return None
    return 100.0 * rec.span_seconds(NAMES) / rec.window_s
