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


def zigzag_tasks(seed, n_tasks=24):
    """FULLY_GLOBAL tasks whose zigzag corridors make the wave route retry
    some of them, most with a real path in the per-row band."""
    rng = np.random.default_rng(seed)
    return synth.zigzag_tasks(
        rng, [int(x) for x in rng.integers(300, 1500, n_tasks)])


def retally(q, r, pa, scoring_t=SCORING_T):
    """Score of pa's CIGAR walked over the code arrays q (s1) and r (s2)
    from its start cell, or None when it does not end at its end cell."""
    match, mismatch, gap_open, gap_extend = scoring_t
    i, j, total = int(pa.s1_start), int(pa.s2_start), 0
    for count, op in pa.cigar:
        count = int(count)
        if op == 'M':
            same = int((q[i:i + count] == r[j:j + count]).sum())
            total += same * match + (count - same) * mismatch
            i += count
            j += count
        else:
            total += gap_open + (count - 1) * gap_extend
            if op == 'I':
                i += count
            else:
                j += count
    if (i, j) != (int(pa.s1_end), int(pa.s2_end)):
        return None
    return total


def run_both_mains(argv, jax_out, port_out):
    """pipeline.main.main of both packages on one argv (the port on its
    CPU route), each into its own output directory; returns the port's
    final graph."""
    from unicycler_tpu.pipeline import main as jmain
    from unicycler_tpu_torch.pipeline import main as tmain
    jmain.main(argv + ['-o', jax_out])
    return tmain.main(argv + ['-o', port_out], device='cpu')


def read_bytes(path):
    with open(path, 'rb') as f:
        return f.read()
