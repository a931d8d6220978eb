"""The run's process holds nothing of JAX or of the JAX package.

The names are compared by their top-level module name (the part before
the first dot) as a whole: the program's package
``distributed_sgd_tpu_torch`` begins with the JAX package's name and is
not it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "distributed_sgd_tpu"})


class Forbidden(RuntimeError):
    def __init__(self, found: List[str]):
        super().__init__(f"the process holds forbidden modules: {', '.join(found)}")
        self.found = found


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or `names`) whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
