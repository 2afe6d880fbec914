"""Share of the seeding pool's thread-seconds in the traced window that
span `seed_read` holds (align/semi_global.py: one read's minimiser
lookup, fine anchors and task building, on a pool thread): how busy the
pool is. Beside seed_share it says whether the main thread waits on a
full pool or a starved one."""

from harness import pool

NAMES = ('seed_read',)


def read(run):
    return pool.share(run.record, NAMES)
