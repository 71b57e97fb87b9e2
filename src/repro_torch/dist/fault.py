"""Fault-tolerance primitives: straggler detection, liveness heartbeats
and elastic meshes (the JAX package's ``dist/fault.py``).

`StragglerMonitor` flags a dispatch slower than a factor of its bucket's
healthy EMA, and `Heartbeat` fires a callback when an armed caller stays
silent past a timeout (both copied).  `elastic_mesh` shrinks a
`launch.mesh.DeviceMesh` onto the surviving prefix of its devices, and
`reshard_tree` moves a tree of tensors onto the devices of the new mesh.

The serving engine arms its heartbeat around each dispatch attempt; the
watcher thread only reads the clock and runs the callback, which counts
(it makes no CUDA call, so it cannot break a graph capture or
synchronise the card under another thread's work).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

__all__ = ["Heartbeat", "StragglerMonitor", "elastic_mesh", "reshard_tree"]


class StragglerMonitor:
    """EMA-based step-time outlier detector.

    A step slower than ``factor`` x the EMA is flagged; flagged steps do NOT
    update the EMA (a straggler must not poison the baseline it is judged
    against).  The first ``warmup_steps`` observations only seed the EMA —
    all of them, with their running mean, so one noisy first call does not
    become the baseline every later call is judged against — and are never
    flagged themselves.
    """

    def __init__(self, factor: float = 3.0, warmup_steps: int = 2,
                 decay: float = 0.9):
        self.factor = factor
        self.warmup_steps = warmup_steps
        self.decay = decay
        self.ema: Optional[float] = None
        self.flagged: List[int] = []
        self._n = 0
        self._warmup_sum = 0.0
        self._warmup_n = 0

    def estimate(self) -> Optional[float]:
        """Current EMA of the healthy per-step wall clock (None before any
        observation).  Stragglers never update the EMA, so this is the
        engine's best *healthy* service-time estimate — the capacity
        signal SLO admission control and deadline-aware scheduling feed
        on (serve.scheduler.ServiceModel seeds from it)."""
        return self.ema

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps or self.ema is None:
            # warmup (or warmup_steps=0 needing a first seed): every
            # observation contributes to the seed mean
            self._warmup_sum += dt
            self._warmup_n += 1
            self.ema = self._warmup_sum / self._warmup_n
            return False
        if dt > self.factor * self.ema:
            self.flagged.append(step)
            return True
        self.ema = self.decay * self.ema + (1.0 - self.decay) * dt
        return False


class Heartbeat:
    """Fires ``on_failure`` once per silence: no tick within ``timeout_s``
    while armed.

    A daemon thread polls the last-tick timestamp; `tick()` is the only
    thing the (possibly blocked) training loop must call.  `close()` stops
    the watcher; it never fires after close.

    Thread-safety: `tick()` and the watcher race on the fired/last pair
    (a tick landing between the watcher's check and its set used to
    double-fire or eat the reset), so both run under one lock — the
    check-and-set is atomic.  ``on_failure`` runs OUTSIDE the lock (it
    may call `tick` or `close` itself) and an exception it raises is
    recorded in ``callback_errors`` instead of silently killing the
    watcher thread; ``fire_count`` counts every fire.

    `arm()`/`disarm()` gate the watcher for callers whose liveness signal
    is intermittent: a serving engine arms around each dispatched call so
    an idle queue is not a "failure".  Constructed armed (the training
    driver's always-on usage).
    """

    def __init__(self, timeout_s: float, on_failure: Callable[[], None],
                 poll_s: Optional[float] = None):
        self.timeout_s = timeout_s
        self.on_failure = on_failure
        self.callback_errors: List[BaseException] = []
        self.fire_count = 0
        self._lock = threading.Lock()
        self._armed = True
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._poll = poll_s if poll_s is not None else max(timeout_s / 10, 0.01)
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def tick(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._fired = False

    def arm(self) -> None:
        """Start watching (fresh silence window from now)."""
        with self._lock:
            self._armed = True
            self._last = time.monotonic()
            self._fired = False

    def disarm(self) -> None:
        """Stop watching until the next `arm()` (idle is not a failure)."""
        with self._lock:
            self._armed = False

    def _watch(self) -> None:
        while not self._stop.is_set():
            fire = False
            with self._lock:
                if (self._armed and not self._fired
                        and time.monotonic() - self._last > self.timeout_s):
                    self._fired = True
                    fire = True
            if fire:
                self.fire_count += 1
                try:
                    self.on_failure()
                except Exception as e:
                    self.callback_errors.append(e)
            self._stop.wait(self._poll)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)


def elastic_mesh(devices: Sequence, model_parallel: int = 1):
    """(data, model) `launch.mesh.DeviceMesh` over the largest usable
    prefix of ``devices``.

    The model axis is fixed by the sharded weights; losing devices shrinks
    the data axis: data = len(devices) // model_parallel.  Surviving
    devices beyond data*model are left idle (they rejoin at the next
    remesh): the paper-style graceful degradation for edge fleets.
    """
    from ..launch.mesh import DeviceMesh

    if model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    data = len(devices) // model_parallel
    if data < 1:
        raise ValueError(
            f"{len(devices)} device(s) cannot host model_parallel="
            f"{model_parallel}")
    return DeviceMesh(tuple(devices[: data * model_parallel]),
                      model=model_parallel)


def reshard_tree(tree, devices):
    """Migrate a tree of tensors (e.g. after an elastic remesh): with one
    device, a copy of ``tree`` on it; with a sequence of devices, one copy
    per device (a replicated tree, `sharding.replicate`)."""
    from .sharding import replicate

    if isinstance(devices, (list, tuple)):
        return replicate(tree, devices)
    return replicate(tree, [devices])[0]
