"""The modules a run must not hold: JAX and the JAX package. Names are
compared by their whole top-level part (before the first dot), since the
program's package name, unicycler_tpu_torch, begins with the JAX
package's."""

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'unicycler_tpu')


def forbidden(modules=None):
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split('.', 1)[0] for n in names} & set(FORBIDDEN))
