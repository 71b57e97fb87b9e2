"""Workload registry: named deconv towers on the plan and serve surface.

A `Workload` binds a `models.dcnn.DcnnConfig` tower to what the rest of
the stack needs to treat it as a first-class citizen: a stable registry
name (what `EngineConfig.model` and plan documents carry), the training
objective kind ("generative" adversarial vs "supervised" reconstruction),
a deterministic calibration-batch synthesizer for the int8 observers,
and, for supervised heads, a training-pair synthesizer.  Registration is
open: other towers call `register()` at import time and then plan and
serve through the same machinery as the built-ins (`workloads.zoo`).

Name resolution is strict: `get`/`resolve_model` raise a typed
`UnknownWorkloadError` listing the known names; a mistyped workload never
falls back to an MNIST generator.  The API, the collision rules and the
synthesizers' draws are the JAX package's (``repro.workloads.registry``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.dcnn import DcnnConfig

__all__ = [
    "Workload",
    "WorkloadError",
    "UnknownWorkloadError",
    "register",
    "get",
    "names",
    "resolve_model",
    "workload_for",
    "workload_name_for",
    "calibration_input",
]


class WorkloadError(ValueError):
    """A model/workload reference the registry cannot satisfy."""


class UnknownWorkloadError(WorkloadError, KeyError):
    """A workload name that is not registered (typed, never a fallback)."""

    def __str__(self) -> str:  # KeyError quotes its arg; keep the message
        return self.args[0] if self.args else ""


# (seed, n) -> array; pair synthesizers return (x, y)
PairFn = Callable[[int, int], Tuple]
CalibFn = Callable[[int, int], object]


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named deconv tower plus its task wiring.

    ``kind`` is "generative" (a latent-z tower trained adversarially) or
    "supervised" (an image-rooted tower trained on (input, target)
    pairs).  ``pair_fn(seed, n)`` synthesizes n training pairs ``(x, y)``
    as numpy arrays; ``calib_fn(seed, n)`` synthesizes n calibration
    inputs matching the serving distribution (defaults: N(0,1) latents
    for generative towers, ``pair_fn`` inputs for supervised ones)."""

    name: str
    cfg: DcnnConfig
    kind: str
    description: str = ""
    aliases: Tuple[str, ...] = ()
    pair_fn: Optional[PairFn] = None
    calib_fn: Optional[CalibFn] = None

    def __post_init__(self):
        if self.kind not in ("generative", "supervised"):
            raise WorkloadError(
                f"workload {self.name!r}: kind must be 'generative' or "
                f"'supervised', got {self.kind!r}")
        if self.kind == "supervised" and self.pair_fn is None:
            raise WorkloadError(
                f"workload {self.name!r}: supervised workloads need a "
                "pair_fn to synthesize (input, target) training pairs")

    # -- convenience passthroughs to the tower implementation ----------
    def init(self, generator: torch.Generator, device="cuda"):
        """Random params of the tower (`models.dcnn.generator_init`)."""
        from ..models.dcnn import generator_init

        return generator_init(generator, self.cfg, device)

    def apply(self, params, x, **kwargs):
        from ..models.dcnn import generator_apply

        return generator_apply(params, self.cfg, x, **kwargs)

    def ref(self, params, x):
        """The unplanned reverse-loop oracle every fast path is held
        against."""
        from ..models.dcnn import generator_apply

        return generator_apply(params, self.cfg, x, backend="reverse_loop")

    def training_pairs(self, seed: int, n: int):
        if self.pair_fn is None:
            raise WorkloadError(
                f"workload {self.name!r} is {self.kind}; it has no "
                "(input, target) pair synthesizer")
        return self.pair_fn(seed, n)

    def calibration_batch(self, seed: int, n: int) -> torch.Tensor:
        return calibration_input(self.cfg, seed=seed, batch=n,
                                 _workload=self)


_lock = threading.Lock()
_by_name: Dict[str, Workload] = {}   # canonical name -> workload
_index: Dict[str, str] = {}          # name | cfg.name | alias -> canonical


def register(workload: Workload) -> Workload:
    """Add a workload; every key (name, cfg.name, aliases) must be free
    or already point at this same workload (idempotent re-import)."""
    keys = (workload.name, workload.cfg.name) + tuple(workload.aliases)
    with _lock:
        for k in keys:
            owner = _index.get(k)
            if owner is not None and owner != workload.name:
                raise WorkloadError(
                    f"workload key {k!r} is already registered to "
                    f"{owner!r}")
        prev = _by_name.get(workload.name)
        if prev is not None and prev.cfg != workload.cfg:
            raise WorkloadError(
                f"workload {workload.name!r} is already registered with "
                "a different tower config")
        _by_name[workload.name] = workload
        for k in keys:
            _index[k] = workload.name
    return workload


def names() -> Tuple[str, ...]:
    """Canonical registered workload names, sorted."""
    with _lock:
        return tuple(sorted(_by_name))


def get(name: str) -> Workload:
    """Look a workload up by name, cfg.name, or alias: a typed error on
    an unknown key, never a fallback."""
    with _lock:
        canonical = _index.get(name)
        if canonical is not None:
            return _by_name[canonical]
        known = sorted(_by_name)
    raise UnknownWorkloadError(
        f"unknown workload {name!r}; registered workloads: {known}")


def workload_for(cfg: DcnnConfig) -> Optional[Workload]:
    """The registered workload whose tower is ``cfg``, else None
    (unregistered towers still plan and serve; they just lose the
    registry's calibration and pair synthesizers)."""
    with _lock:
        canonical = _index.get(cfg.name)
        w = _by_name.get(canonical) if canonical is not None else None
    if w is not None and w.cfg == cfg:
        return w
    return None


def workload_name_for(cfg: DcnnConfig) -> str:
    """Canonical registry name for a tower config, else the config's own
    name for unregistered towers (what `NetworkPlan.workload` records)."""
    w = workload_for(cfg)
    return w.name if w is not None else cfg.name


def resolve_model(model) -> DcnnConfig:
    """`EngineConfig.model` resolution: a `DcnnConfig` (or the U-Net's
    `models.unet.UnetConfig`) passes through, a string resolves via the
    registry, anything else is a typed error."""
    from ..models.unet import UnetConfig

    if isinstance(model, (DcnnConfig, UnetConfig)):
        return model
    if isinstance(model, str):
        return get(model).cfg
    raise WorkloadError(
        f"model must be a DcnnConfig or a registered workload name, "
        f"got {type(model).__name__}")


def calibration_input(cfg: DcnnConfig, *, seed: int = 0, batch: int = 64,
                      _workload: Optional[Workload] = None) -> torch.Tensor:
    """A deterministic f32 calibration batch for ``cfg``'s input root, on
    the CPU.

    Image-rooted towers use the registered workload's ``calib_fn`` where
    there is one: a numpy draw, so the batch, and the scales calibrated
    from it, equal the JAX package's.  Latent towers (and image towers
    without one) draw z ~ N(0, 1) of shape ``(batch,) + cfg.input_shape``
    from ``torch.Generator().manual_seed(seed)``.  That draw cannot
    reproduce the JAX package's ``jax.random`` one, so a port that
    self-calibrates a latent tower gets other scales than the reference;
    to compute with the reference's scales, hand the port its
    ``QuantConfig`` (or a plan pinned by it).

    The plan builder and the serving engine both calibrate on it with the
    same (seed, batch), so their scales agree."""
    w = _workload if _workload is not None else workload_for(cfg)
    if not cfg.is_latent and w is not None and w.calib_fn is not None:
        return torch.from_numpy(np.asarray(w.calib_fn(seed, batch),
                                           np.float32))
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch,) + cfg.input_shape, generator=gen)
