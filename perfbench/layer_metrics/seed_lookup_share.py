"""Share of the seeding pool's thread-seconds in the traced window that
span `seed_lookup` holds (the minimiser index lookup of a read:
sketch, searchsorted, hit clustering)."""

from harness import pool

NAMES = ('seed_lookup',)


def read(run):
    return pool.share(run.record, NAMES)
