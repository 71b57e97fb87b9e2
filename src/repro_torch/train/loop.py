"""Resilient generic training driver: checkpoint/restart, async saves,
straggler monitoring, deterministic data resume, simulated-failure recovery
(the JAX package's ``repro.train.loop``).

The driver owns no model specifics: it runs any step_fn over any state
tree with a StepIndexedSource, which is what makes restart exact: data is
a pure function of the step index, and the state checkpoint carries the
step.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..ckpt.checkpoint import AsyncCheckpointer, restore
from ..core.tree import tree_leaves
from ..dist.fault import StragglerMonitor


class NodeFailure(RuntimeError):
    """A node lost mid-step, injected or raised by ``step_fn``: the driver
    restores the last committed checkpoint and resumes.  Any other error
    (a kernel that fails to build or launch, an out-of-memory) propagates."""


def _wait_for(state) -> None:
    """Wait for the device of the state's first tensor leaf (the host
    clock then covers the step's device work)."""
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "cuda":
                torch.cuda.synchronize(leaf.device)
            return


class TrainDriver:
    def __init__(
        self,
        step_fn: Callable[[Any, Dict], Any],   # (state, batch) -> (state, metrics)
        source,                                 # StepIndexedSource
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep: int = 3,
        straggler_factor: float = 3.0,
        failure_injector: Optional[Callable[[int], bool]] = None,
    ):
        self.step_fn = step_fn
        self.source = source
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt = AsyncCheckpointer(ckpt_dir, keep) if ckpt_dir else None
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.failure_injector = failure_injector
        self.recoveries = 0
        self.metrics_log = []

    def _maybe_restore(self, state):
        if not self.ckpt_dir:
            return state, 0
        restored, step, _ = restore(self.ckpt_dir, state)
        if restored is None:
            return state, 0
        return restored, step + 1

    def run(self, state, n_steps: int):
        state, start = self._maybe_restore(state)
        init_state_template = state
        step = start
        while step < n_steps:
            try:
                if self.failure_injector and self.failure_injector(step):
                    raise NodeFailure(f"injected node failure at step {step}")
                batch = self.source.batch(step)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, batch)
                _wait_for(state)
                dt = time.monotonic() - t0
                self.monitor.observe(step, dt)
                self.metrics_log.append(
                    {"step": step, "time_s": dt,
                     **{k: float(v) for k, v in metrics.items()}})
                if self.ckpt and step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
                step += 1
            except NodeFailure:
                # node failure: restore last committed checkpoint and resume.
                self.recoveries += 1
                if self.ckpt:
                    self.ckpt.wait()
                state, step = self._maybe_restore(init_state_template)
        if self.ckpt:
            self.ckpt.save(n_steps - 1, state)
            self.ckpt.wait()
        return state
