"""The import guard: the process that reports must not hold JAX or the JAX
package.  Modules are compared by their whole top-level name (the part
before the first dot), since the port's name begins with the JAX package's."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fastgaussianprocesses_tpu"})


def forbidden_modules(modules=None):
    """The sorted top-level names in ``modules`` (default ``sys.modules``)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
