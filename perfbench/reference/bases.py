"""Bases as codes: A, C, G, T -> 0, 1, 2, 3; anything else -> 4."""

import numpy as np

_LUT = np.full(256, 4, np.int8)
for _i, _b in enumerate(b'ACGT'):
    _LUT[_b] = _i
    _LUT[_b + 32] = _i      # lower case
_COMP = np.array([3, 2, 1, 0, 4], np.int8)


def codes(seq):
    """A string of bases as an int8 code array."""
    return _LUT[np.frombuffer(seq.encode('ascii'), np.uint8)]


def revcomp(c):
    """The reverse complement of a code array."""
    return _COMP[np.asarray(c)[::-1]]
