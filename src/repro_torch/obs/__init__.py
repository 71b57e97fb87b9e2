"""Observability layer: one clock, typed metrics, span tracing, Table II.

A copy of the JAX package's ``obs`` (it imports no JAX, but the port
imports nothing of that package): metric names, label keys and span
names are the same, so one report reads either package's registry.

* :mod:`repro_torch.obs.clock` — the single monotonic timebase
  (:func:`clock.now`) every serve-stack duration and deadline uses.
* :mod:`repro_torch.obs.metrics` — thread-safe Counters / Gauges / fixed-bucket
  Histograms with streaming mean/std/CV, labeled by
  ``(net, precision, bucket, tenant)``.
* :mod:`repro_torch.obs.trace` — ring-buffered span tracing with a
  Chrome/Perfetto ``trace_event`` exporter (open at https://ui.perfetto.dev).
* :mod:`repro_torch.obs.report` — reduces dispatch histograms to the paper's
  Table II statistics (mean, std, run-to-run CV over healthy calls).
"""
from . import clock, metrics, report, trace  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      default_registry)
from .report import render_table2, table2_rows  # noqa: F401
from .trace import Tracer, get_tracer  # noqa: F401

__all__ = [
    "clock", "metrics", "trace", "report",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "default_registry",
    "Tracer", "get_tracer", "table2_rows", "render_table2",
]
