"""The import guard: the benchmark measures the PyTorch port, so the JAX
package and JAX itself may not be loaded in the process that reports.

Names are compared by their whole top-level part, the text before the
first dot: ``repro_torch`` is the port, ``repro`` the JAX package."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: every
    module loaded in this process)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
