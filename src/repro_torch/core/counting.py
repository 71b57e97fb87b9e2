"""The hooks through which a cost counter (`analysis.cost.CostMode`) sees
a step: the counter in effect, the loops whose iterations it may multiply
(`trips`, `repeat`), and the hand-written kernels' launches
(`record_kernel`), which no dispatch mode sees.  With no counter in effect
`trips` is ``range`` and the others do nothing.  The models, the trainer
and the kernel wrappers import this module, not the analysis layer."""
from __future__ import annotations

import sys
from typing import Any, List, Optional

import torch
from torch.utils._pytree import tree_leaves

_ACTIVE: List[Any] = []


def active() -> Optional[Any]:
    """The innermost counter in effect, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def push(counter) -> None:
    """``counter`` takes effect (`CostMode.__enter__`)."""
    _ACTIVE.append(counter)


def pop(counter) -> None:
    """``counter`` leaves effect (`CostMode.__exit__`)."""
    _ACTIVE.remove(counter)


def local(t):
    """The local shard of a DTensor, else ``t``."""
    return getattr(t, "_local_tensor", t)


def is_fake(t) -> bool:
    """Whether ``t`` is a FakeTensor (shapes and dtypes, no data)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def nbytes(t: torch.Tensor) -> int:
    """The bytes of a tensor's elements (a DTensor's local shard)."""
    t = local(t)
    return t.numel() * t.element_size()


def trips(n: int):
    """``range(n)`` for a loop whose iterations do the same work at the
    same shapes.  Under a counter in "multiply" mode three iterations run,
    weighted 1, ``n - 2`` and 1: the first of a loop with a carry differs
    (its backward has no carry to reach), and in the backward the last
    one's gradient of a tensor that every iteration reads is the one that
    needs no add, so the adds of those gradients count ``n - 1`` as in the
    full loop."""
    c = active()
    if c is None or c.loops != "multiply" or n <= 3:
        return range(n)
    f = sys._getframe(1)
    return c._region(n, (f.f_code, f.f_lineno))


def repeat(results: list, n: int) -> list:
    """A `trips` loop's per-iteration results, ``n`` of them: under a
    multiplier iteration 0's, iteration 1's ``n - 2`` times (each extra
    copy counted as held while the result lives) and iteration 2's; else
    ``results``."""
    if len(results) == n:
        return results
    if len(results) != 3:
        raise ValueError(f"{len(results)} results of a loop of {n}")
    c = active()
    if c is not None:
        for t in tree_leaves(results[1]):
            if isinstance(t, torch.Tensor):
                c._hold(local(t).untyped_storage().nbytes() * (n - 3), t)
    return results[:1] + results[1:2] * (n - 2) + results[2:]


def record_kernel(name: str, flops: float, bytes_: float) -> None:
    """A hand-written kernel's launch, reported by its wrapper where it
    launches (no dispatch mode sees a ctypes launch)."""
    c = active()
    if c is not None:
        c._kernel(name, flops, bytes_)
