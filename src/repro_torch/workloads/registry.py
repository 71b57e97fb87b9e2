"""Workload registry: named deconv towers.

Resolves the names that `EngineConfig.model` and plan documents carry
("mnist", "celeba", or a tower's own ``cfg.name``) to a `DcnnConfig`.
Resolution is strict: an unknown name raises a typed
`UnknownWorkloadError` listing the known names, never a fallback.  This
slice registers the paper's two WGAN generators; the JAX package's SR and
denoising heads come with a later slice.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..models.dcnn import CELEBA_DCNN, MNIST_DCNN, DcnnConfig

__all__ = ["WorkloadError", "UnknownWorkloadError", "get", "names",
           "resolve_model", "workload_name_for"]


class WorkloadError(ValueError):
    """A model/workload reference the registry cannot satisfy."""


class UnknownWorkloadError(WorkloadError, KeyError):
    """A workload name that is not registered (typed, never a fallback)."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message
        return self.args[0] if self.args else ""


# canonical name -> tower (the JAX package's registry names)
_BY_NAME: Dict[str, DcnnConfig] = {"mnist": MNIST_DCNN, "celeba": CELEBA_DCNN}
# name | cfg.name -> canonical name
_INDEX: Dict[str, str] = {**{n: n for n in _BY_NAME},
                          **{c.name: n for n, c in _BY_NAME.items()}}


def names() -> Tuple[str, ...]:
    """Canonical registered workload names, sorted."""
    return tuple(sorted(_BY_NAME))


def get(name: str) -> DcnnConfig:
    """The tower registered under ``name`` (or under its ``cfg.name``)."""
    canonical = _INDEX.get(name)
    if canonical is None:
        raise UnknownWorkloadError(
            f"unknown workload {name!r}; registered workloads: "
            f"{list(names())}")
    return _BY_NAME[canonical]


def workload_name_for(cfg: DcnnConfig) -> str:
    """Canonical registry name for a tower config, else the config's own
    name (what `NetworkPlan.workload` records)."""
    canonical = _INDEX.get(cfg.name)
    if canonical is not None and _BY_NAME[canonical] == cfg:
        return canonical
    return cfg.name


def resolve_model(model) -> DcnnConfig:
    """`EngineConfig.model` resolution: a `DcnnConfig` passes through, a
    string resolves via the registry, anything else is a typed error."""
    if isinstance(model, DcnnConfig):
        return model
    if isinstance(model, str):
        return get(model)
    raise WorkloadError(
        f"model must be a DcnnConfig or a registered workload name, "
        f"got {type(model).__name__}")
