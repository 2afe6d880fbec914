"""Share of the seeding pool's thread-seconds in the traced window that
span `fine_anchors` holds (the dense common k-mer pass of each cluster,
ops/minimizer.collect_common_kmers). What seed_pool_share holds beyond
this and seed_lookup_share is task building in Python."""

from harness import pool

NAMES = ('fine_anchors',)


def read(run):
    return pool.share(run.record, NAMES)
