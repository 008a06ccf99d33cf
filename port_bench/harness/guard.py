"""The import guard: no module of a run is JAX or the JAX package, and
nothing the reference loads is the port.

Names are compared by their top-level part (before the first dot) whole:
the port's name, `jax_mapping_torch`, begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

#: Top-level names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "jax_mapping")

#: The port's top-level name, which the reference may not load.
PORT = "jax_mapping_torch"


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(names: Iterable[str] = None,
                     forbidden: Iterable[str] = FORBIDDEN) -> List[str]:
    """The forbidden top-level names among `names` (default: the
    modules this process has loaded)."""
    tops = top_level(sys.modules if names is None else names)
    return sorted(tops & set(forbidden))
