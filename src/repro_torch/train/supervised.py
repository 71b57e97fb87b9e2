"""Supervised reconstruction training for image-rooted deconv towers (the
JAX package's ``repro.train.supervised`` in torch).

`SupervisedTrainer` is the reconstruction-loss twin of
`train.wgan.WganTrainer`, for the workload zoo's supervised heads
(super-resolution, denoising): the same power-of-two bucketing with exact
masked sum/n_valid loss accounting over pad rows, each bucket's step and
plan built once (``build_counts``), and with ``backend="cuda"`` the same
`build_network_plan` -> `make_fused_generator` path, so a training step's
forward runs the serving kernel at a serving plan (``plan_fingerprints``;
hash-asserted against an optional pinned serving plan).

The objective is per-pixel masked MSE between the tower's output and the
target image.  The step draws no noise, so a run is a function of the
params and the data alone.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..core.tree import tree_leaves, tree_unflatten
from ..data.pipeline import StepIndexedSource
from ..models.dcnn import DcnnConfig, generator_init
from .wgan import (as_batch, bucket_gen_fn, check_backend, pad_rows,
                   pow2_bucket, requiring_grad)

__all__ = ["SupervisedTrainer", "pair_source", "train_supervised"]


def pair_source(workload, seed: int, batch: int) -> StepIndexedSource:
    """Step-indexed ``{"x": inputs, "y": targets}`` source from a
    registered supervised workload's pair synthesizer (pure in
    (seed, step), so training is deterministically resumable)."""
    def fn(step):
        x, y = workload.training_pairs(seed + step, batch)
        return {"x": x, "y": y}

    return StepIndexedSource(fn)


class SupervisedTrainer:
    """Bucketed masked-MSE trainer for image-in/image-out towers.

    ``step(p, state, x, y)`` takes a (possibly ragged) batch of (input,
    target) images, numpy or tensors, pads it to its power-of-two bucket
    and runs the bucket's update; pad rows are masked out of the loss with
    exact sum/n_valid accounting.  Params live on ``device`` (default the
    card)."""

    def __init__(self, cfg: DcnnConfig, opt, *,
                 backend: str = "reverse_loop",
                 autotune: bool = True, plan=None, device="cuda"):
        check_backend(backend, plan)
        if plan is not None:
            plan.validate_for(cfg)
        self.cfg = cfg
        self.opt = opt
        self.backend = backend
        self.device = torch.device(device)
        self._autotune = autotune
        self._pinned_plan = plan
        self._fns: Dict[int, Callable] = {}
        # per kind and bucket, how many times its step / plan was built
        self.build_counts: Dict[str, Dict[int, int]] = {"step": {},
                                                        "plan": {}}
        self.plans: Dict[int, Any] = {}

    def bucket_for(self, n: int) -> int:
        return pow2_bucket(n)

    # -- step construction ----------------------------------------------
    def _build_fn(self, bucket: int) -> Callable:
        gen_fn, plan = bucket_gen_fn(
            self.cfg, self.backend, bucket, autotune=self._autotune,
            pinned=self._pinned_plan, counts=self.build_counts["plan"],
            bucket=bucket)
        if plan is not None:
            self.plans[bucket] = plan
        opt = self.opt
        out_elems = float(self.cfg.img_hw * self.cfg.img_hw * self.cfg.img_c)

        def body(p, state, x, y, nv):
            pg = requiring_grad(p)
            pred = gen_fn(pg, x)
            mask = (torch.arange(bucket, device=x.device) < nv).to(pred.dtype)
            per_row = torch.sum((pred - y.to(pred.dtype)) ** 2, dim=(1, 2, 3))
            # masked mean over valid pixels: pad rows contribute exactly
            # zero and the divisor is the true batch size
            loss = torch.sum(per_row * mask) / (nv * out_elems)
            grads = torch.autograd.grad(loss, tree_leaves(pg))
            p, state = opt.update(tree_unflatten(p, grads), state, p)
            return p, state, {"loss": loss.detach()}

        return body

    # -- public API ------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Random params on the trainer's device, drawn on the CPU from
        ``seed``, and their optimizer state."""
        p = generator_init(torch.Generator().manual_seed(seed), self.cfg,
                           self.device)
        return p, self.opt.init(p)

    def step(self, p, state, x, y):
        """One update on a (possibly ragged) batch of (input, target) image
        pairs; returns ``(params, opt_state, {"loss": ...})``."""
        dt = self.cfg.torch_dtype
        x = as_batch(x, self.device, dt)
        y = as_batch(y, self.device, dt)
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"input/target batches disagree: {x.shape[0]} vs "
                f"{y.shape[0]}")
        n = x.shape[0]
        bucket = self.bucket_for(n)
        x, y = pad_rows(x, bucket), pad_rows(y, bucket)
        if bucket not in self._fns:
            self._fns[bucket] = self._build_fn(bucket)
            counts = self.build_counts["step"]
            counts[bucket] = counts.get(bucket, 0) + 1
        return self._fns[bucket](p, state, x, y, n)

    @property
    def total_builds(self) -> int:
        return sum(v for d in self.build_counts.values() for v in d.values())

    def plan_fingerprints(self) -> Dict[int, str]:
        """{batch -> stable hash} of the plans the forward ran ("cuda")."""
        from ..plan import executable_fingerprints

        return executable_fingerprints(self.plans.values())

    # -- training loop ----------------------------------------------------
    def fit(self, source, steps: int, seed: int = 0, log_every: int = 50):
        """Train for ``steps`` steps over a step-indexed pair source
        (``batch(step) -> {"x": ..., "y": ...}``; see `pair_source`) from
        params drawn from ``seed``.  Returns ``(params, history)``."""
        p, state = self.init_state(seed)
        history: List[dict] = []
        for step in range(steps):
            rec = source.batch(step)
            p, state, met = self.step(p, state, rec["x"], rec["y"])
            if step % log_every == 0 or step == steps - 1:
                history.append({"step": step, "loss": float(met["loss"])})
        return p, history


def train_supervised(workload, steps: int, init_seed: int, opt, *,
                     batch: int = 8, seed: int = 0,
                     backend: str = "reverse_loop", **kwargs):
    """Train a registered supervised workload end to end: synthesize its
    pair source (data ``seed``), run ``steps`` bucketed updates from params
    drawn from ``init_seed``, return ``(params, trainer, history)``."""
    trainer = SupervisedTrainer(workload.cfg, opt, backend=backend, **kwargs)
    src = pair_source(workload, seed, batch)
    p, history = trainer.fit(src, steps, init_seed)
    return p, trainer, history
