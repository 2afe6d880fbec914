"""Shared helpers for the tests that hold unicycler_tpu_torch against
unicycler_tpu: the same numpy inputs go to both packages."""

import numpy as np
import torch

from unicycler_tpu_torch import synth

# The test run spreads files over several processes on a few cores. A
# pool of intra-op threads in each oversubscribes them, and the plain
# versions' many small ops then stall on the pools' barriers (tens of
# times slower). One thread per process keeps every file near its solo
# time.
torch.set_num_threads(1)

SCORING_T = (3, -6, -5, -2)

# (free_start_s1, free_start_s2, free_end_s1, free_end_s2)
CONFIGS = {
    'semi': (True, True, True, True),
    'global': (False, False, False, False),
    'path': (False, False, False, True),
    'overlap': (True, False, False, True),
    'end': (False, True, False, False),
}


def tasks_np(seed, sizes, drift):
    return synth.banded_tasks(np.random.default_rng(seed), sizes,
                              drift=drift)


def pa_key(pa):
    """Everything a PairAlignment says, with the CIGAR as plain tuples."""
    return (int(pa.score), int(pa.s1_start), int(pa.s1_end),
            int(pa.s2_start), int(pa.s2_end),
            [(int(c), str(op)) for c, op in pa.cigar],
            int(pa.s1_len), int(pa.s2_len))
