"""Thread-local sharding context: (mesh, logical-axis rules), the JAX
package's ``repro.dist.context`` for the port.

`constrain` is the single annotation primitive the LM models use.  On one
device, and on the port's data-parallel mesh (a `launch.mesh.DeviceMesh`
whose ``model`` extent is 1), it returns its input: there is nothing
within a model to place.  Sharding within a model (the rule policies of
``dist/sharding.py``, a ``model`` axis above 1) has not been ported yet
(ROADMAP.md A16, its sharding step), so a context with such a mesh makes
`constrain` raise rather than quietly run replicated.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_state = threading.local()


def current() -> Tuple[Optional[object], Optional[dict]]:
    """The active (mesh, rules), or (None, None) outside any context."""
    return getattr(_state, "mesh", None), getattr(_state, "rules", None)


@contextlib.contextmanager
def sharding_context(mesh, rules):
    """Activate (mesh, rules) for the dynamic extent of a step function."""
    prev = current()
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """``x`` placed by the logical-axis rules (one logical axis name, or
    None, per dim of ``x``).  Outside a context, and on a mesh without a
    ``model`` axis, that placement is ``x`` as it is."""
    mesh, rules = current()
    if mesh is None or rules is None:
        return x
    if getattr(mesh, "shape", {}).get("model", 1) == 1:
        return x
    raise NotImplementedError(
        f"constrain{tuple(logical_axes)} on a mesh of shape {mesh.shape}: "
        "sharding within a model is not ported yet (ROADMAP.md A16)")
