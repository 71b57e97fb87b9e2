"""Optimizers without ``torch.optim``: AdamW / Adam / SGD with f32
accumulators and global-norm clipping, copied from the JAX package's
``repro.optim.optimizer``.

They are functional: ``update(grads, state, params)`` returns new param
tensors and a new state and changes none of its arguments, so a tensor
that some other code still holds (a serving engine's weight, a prepared
kernel operand) keeps its value.  ``torch.optim`` updates in place and
has no global-norm clip.  Params and states are the port's trees (nested
dicts of tensors; `AdamState` a NamedTuple, as in the reference).  On
DTensor params (the sharded LM) every state takes its param's placements
and the clip's global norm sums over every shard of every leaf on the
device: DTensor reduces each leaf's partial sum across the mesh, and
nothing reads a value back to the host."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..core.tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: Any
    nu: Any


def _device(params) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros like ``p``: on a DTensor, with its placements."""
    return torch.zeros_like(p, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamState:
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            mu=tree_map(_zeros_f32, params),
            nu=tree_map(_zeros_f32, params),
        )

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> Tuple[Any, AdamState]:
        grads = tree_map(lambda g: g.float(), grads)
        if self.clip_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(p, m, v):
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu,
                                                        nu=nu)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 1e-2
    momentum: float = 0.0

    def init(self, params):
        if self.momentum:
            return tree_map(_zeros_f32, params)
        return ()

    @torch.no_grad()
    def update(self, grads, state, params):
        if self.momentum:
            state = tree_map(lambda b, g: self.momentum * b + g.float(),
                             state, grads)
            new = tree_map(lambda p, b: (p.float() - self.lr * b).to(p.dtype),
                           params, state)
            return new, state
        new = tree_map(lambda p, g: (p.float() - self.lr * g.float())
                       .to(p.dtype), params, grads)
        return new, state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, summed in leaf order (of
    every shard of a DTensor leaf: its sum is reduced over the mesh)."""
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in tree_leaves(tree)))
