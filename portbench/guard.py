"""The run's guard against JAX: no module of JAX, jaxlib, flax or the JAX
package may be loaded in the process that prints the result. Names are
compared by their top-level part (before the first dot) as whole words, so
`uvltrack_tpu_torch`, the port, is not `uvltrack_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "uvltrack_tpu"})


def forbidden_loaded(names=None) -> list:
    """The forbidden top-level names among `names` (sys.modules by default)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.partition(".")[0] for n in names} & FORBIDDEN)
