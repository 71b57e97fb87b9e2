"""Thread-safe typed metrics: Counters, Gauges, fixed-bucket Histograms.

One :class:`MetricsRegistry` is shared by every engine/frontend in a
serving stack (``AsyncServeFrontend.from_config`` wires a single
registry through all per-precision engines), so the whole deployment's
counters land in one place.  Series are labelable by any string keys —
the serve stack uses ``(net, precision, bucket, tenant)`` — and a
histogram keeps streaming moments (count, sum, sum of squares) plus
fixed bucket counts, so the paper's Table II statistics (mean, std,
run-to-run CV) reduce in O(1) without retaining samples.

Locking discipline (checked by the JAX package's concurrency lint,
``tests/test_torch_lint.py``): each
metric owns one ``threading.Lock`` guarding its series dict; the
registry owns one lock guarding the name→metric table.  Metric locks
are leaves — no metric method calls back into the registry.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricTypeError",
    "default_registry",
]

LabelKey = Tuple[Tuple[str, str], ...]


class MetricTypeError(TypeError):
    """A metric name was re-requested with a different type."""


def _label_key(labels: Dict[str, object]) -> LabelKey:
    # values stringified so int bucket sizes and their str forms collide
    # deliberately — JSON round-trips cannot split a series in two
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_dict(key: LabelKey) -> Dict[str, str]:
    return dict(key)


def _matches(key: LabelKey, match: Dict[str, object]) -> bool:
    want = {str(k): str(v) for k, v in match.items()}
    have = dict(key)
    return all(have.get(k) == v for k, v in want.items())


class Counter:
    """Monotonically increasing count per label set."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1, **labels: object) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment {value}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels: object) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)

    def total(self, **match: object) -> float:
        """Sum over every series whose labels are a superset of ``match``."""
        with self._lock:
            return sum(v for k, v in self._series.items() if _matches(k, match))

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._series)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            rows = [{"labels": _label_dict(k), "value": v}
                    for k, v in sorted(self._series.items())]
        return {"type": "counter", "help": self.help, "series": rows}


class Gauge:
    """Last-write-wins value per label set."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = value

    def value(self, **labels: object) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def series(self) -> Dict[LabelKey, float]:
        with self._lock:
            return dict(self._series)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            rows = [{"labels": _label_dict(k), "value": v}
                    for k, v in sorted(self._series.items())]
        return {"type": "gauge", "help": self.help, "series": rows}


class _HistSeries:
    __slots__ = ("count", "total", "sumsq", "min", "max", "bucket_counts")

    def __init__(self, n_bounds: int) -> None:
        self.count = 0
        self.total = 0.0
        self.sumsq = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.bucket_counts = [0] * (n_bounds + 1)  # last = overflow

    def observe(self, value: float, bounds: Sequence[float]) -> None:
        self.count += 1
        self.total += value
        self.sumsq += value * value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        for i, b in enumerate(bounds):
            if value <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def merge_into(self, other: "_HistSeries") -> None:
        other.count += self.count
        other.total += self.total
        other.sumsq += self.sumsq
        other.min = min(other.min, self.min)
        other.max = max(other.max, self.max)
        for i, c in enumerate(self.bucket_counts):
            other.bucket_counts[i] += c

    def stats(self) -> dict:
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "std": 0.0, "cv": 0.0,
                    "min": 0.0, "max": 0.0, "total": 0.0}
        mean = self.total / self.count
        # population variance from streaming moments, clamped against
        # catastrophic cancellation on near-constant samples
        var = max(self.sumsq / self.count - mean * mean, 0.0)
        std = math.sqrt(var)
        cv = std / mean if mean > 0 else 0.0
        return {"count": self.count, "mean": mean, "std": std, "cv": cv,
                "min": self.min, "max": self.max, "total": self.total}


class Histogram:
    """Fixed-bucket histogram with streaming mean/std/CV per label set."""

    # dispatch wall-clocks on CPU interpret mode span ~100µs..10s
    DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 1e-1, 5e-1,
                       1.0, 5.0, 10.0)

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Sequence[float]] = None) -> None:
        self.name = name
        self.help = help
        bounds = tuple(buckets) if buckets is not None else self.DEFAULT_BUCKETS
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"strictly increasing, got {bounds}")
        self.bounds = bounds
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, _HistSeries] = {}

    def observe(self, value: float, **labels: object) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = _HistSeries(len(self.bounds))
                self._series[key] = s
            s.observe(value, self.bounds)

    def summary(self, **labels: object) -> dict:
        """mean/std/cv/min/max for one exact label set."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.stats() if s is not None else _HistSeries(0).stats()

    def merged_summary(self, **match: object) -> dict:
        """Pool moments across every series matching a label subset."""
        pooled = _HistSeries(len(self.bounds))
        with self._lock:
            for key, s in self._series.items():
                if _matches(key, match):
                    s.merge_into(pooled)
        return pooled.stats()

    def label_values(self, label: str) -> List[str]:
        """Distinct observed values of one label key, sorted."""
        with self._lock:
            keys = list(self._series)
        out = {dict(k)[label] for k in keys if label in dict(k)}
        return sorted(out)

    def series_summaries(self) -> Dict[LabelKey, dict]:
        with self._lock:
            return {k: s.stats() for k, s in self._series.items()}

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def snapshot(self) -> dict:
        with self._lock:
            rows = [{"labels": _label_dict(k), **s.stats(),
                     "bucket_counts": list(s.bucket_counts)}
                    for k, s in sorted(self._series.items())]
        return {"type": "histogram", "help": self.help,
                "bounds": list(self.bounds), "series": rows}


class MetricsRegistry:
    """Get-or-create registry of typed metrics, safe to share across threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise MetricTypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram, help, buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able dump of every metric and series."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def reset(self) -> None:
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry (used by module-level code like autotune)."""
    return _default
