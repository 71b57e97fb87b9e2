"""Deterministically resumable data pipeline (numpy), copied from the JAX
package's ``repro.data.pipeline``.

Batches are a pure function of (seed, step): no iterator state to
checkpoint, no divergence on restart, and every data-parallel host can
compute exactly its own shard (batch axis sliced by host id).  Prefetch is
a small background thread keeping a bounded queue of ready batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np

from .synthetic import digit_images, face_images, token_stream


class StepIndexedSource:
    """batch(step) -> dict of numpy arrays; pure in (seed, step)."""

    def __init__(self, fn: Callable[[int], Dict[str, np.ndarray]]):
        self._fn = fn

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return self._fn(step)

    def shard(self, host_id: int, n_hosts: int) -> "StepIndexedSource":
        def fn(step):
            full = self._fn(step)
            return {k: np.array_split(v, n_hosts, axis=0)[host_id]
                    for k, v in full.items()}
        return StepIndexedSource(fn)


def image_source(kind: str, seed: int, batch: int) -> StepIndexedSource:
    gen = digit_images if kind == "mnist" else face_images

    def fn(step):
        return {"images": gen(seed + step, batch)}

    return StepIndexedSource(fn)


def lm_source(seed: int, batch: int, seq_len: int, vocab: int) -> StepIndexedSource:
    def fn(step):
        toks = token_stream(seed + step, batch * (seq_len + 1), vocab)
        toks = toks.reshape(batch, seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return StepIndexedSource(fn)


def finite_batches(source: StepIndexedSource, n_steps: int,
                   start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """A step-indexed source as a finite streaming iterator: the
    `train.wgan.WganTrainer.fit` streaming form (one batch per critic
    sub-step; training stops when the iterator drains)."""
    for step in range(start, start + n_steps):
        yield source.batch(step)


class Prefetcher:
    """Bounded background prefetch over a StepIndexedSource."""

    def __init__(self, source: StepIndexedSource, start_step: int,
                 depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next
        while not self._stop.is_set():
            try:
                self._q.put((step, self._source.batch(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
