"""Carry alignment state over from the JAX package.

The aligner has no learned weights. The state a run carries is the
scoring scheme and the reference minimiser index. `port_state` takes the
JAX package's numpy-side objects (its Scoring tuple and MinimizerIndex,
read by attribute only, so nothing of that package is imported) and
builds this package's equivalents from the same arrays, without
recomputing them.
"""

import numpy as np

from .ops.minimizer import MinimizerIndex
from .ops.pairwise import Scoring

_INDEX_ARRAYS = ('ref_lengths', 'hashes', 'ref_ids', 'positions', 'strands')


def port_state(scoring, index=None):
    """(Scoring, MinimizerIndex or None) of this package from the JAX
    package's scoring tuple and (optionally) its MinimizerIndex."""
    sc = Scoring(*(int(x) for x in scoring))
    if index is None:
        return sc, None
    idx = MinimizerIndex.__new__(MinimizerIndex)
    idx.k = int(index.k)
    idx.w = int(index.w)
    for name in _INDEX_ARRAYS:
        setattr(idx, name, np.array(getattr(index, name), copy=True))
    return sc, idx
