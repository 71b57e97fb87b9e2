"""Table II reporter: reduce dispatch histograms to the paper's methodology.

The paper's Table II reports, per network and implementation, the mean
throughput and the **run-to-run coefficient of variation** — its core
claim is that the FPGA pipeline's timing is not just fast but *stable*.
This module reduces the ``engine.dispatch_seconds`` histogram (healthy
steady-state dispatches only — retried/tainted calls are counted
separately and excluded, matching the engine's ``bucket_stats``
taint discipline) into rows of that shape:

* one row per ``(net, precision, bucket)`` — run-to-run mean/std/CV at
  a fixed compiled configuration, the statistic the paper actually
  tabulates;
* one roll-up row per ``(net, precision)`` with ``bucket="all"`` —
  ``cv`` there is the calls-weighted average of the per-bucket CVs
  (pooling raw moments across buckets would conflate bucket-size
  spread with run-to-run jitter, which is not Table II's quantity).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .metrics import Counter, Histogram, MetricsRegistry

__all__ = ["table2_rows", "render_table2", "DISPATCH_METRIC", "TAINT_METRIC"]

DISPATCH_METRIC = "engine.dispatch_seconds"
TAINT_METRIC = "engine.tainted_calls"


def _tainted(counter, **labels) -> int:
    if not isinstance(counter, Counter):
        return 0
    return int(counter.total(**labels))


def table2_rows(registry: MetricsRegistry,
                metric: str = DISPATCH_METRIC) -> List[dict]:
    """Reduce a registry's dispatch histogram to Table II rows."""
    hist = registry.get(metric)
    if not isinstance(hist, Histogram):
        return []
    taint = registry.get(TAINT_METRIC)
    groups: Dict[Tuple[str, str], List[dict]] = {}
    for key, stats in hist.series_summaries().items():
        labels = dict(key)
        if "net" not in labels or stats["count"] == 0:
            continue
        net = labels["net"]
        precision = labels.get("precision", "fp32")
        bucket = labels.get("bucket", "?")
        row = {
            "net": net,
            # registry workload name (falls back to the net for series
            # recorded before the workload label existed)
            "workload": labels.get("workload", net),
            "precision": precision,
            "bucket": int(bucket) if str(bucket).isdigit() else str(bucket),
            "calls": stats["count"],
            "mean_s": stats["mean"],
            "std_s": stats["std"],
            "cv": stats["cv"],
            "min_s": stats["min"],
            "max_s": stats["max"],
            "tainted_calls": _tainted(taint, net=net, precision=precision,
                                      bucket=bucket),
        }
        groups.setdefault((net, precision), []).append(row)

    rows: List[dict] = []
    for (net, precision) in sorted(groups):
        per_bucket = sorted(groups[(net, precision)],
                            key=lambda r: (str(r["bucket"])))
        rows.extend(per_bucket)
        calls = sum(r["calls"] for r in per_bucket)
        seconds = sum(r["mean_s"] * r["calls"] for r in per_bucket)
        images = sum(r["bucket"] * r["calls"] for r in per_bucket
                     if isinstance(r["bucket"], int))
        rollup = {
            "net": net,
            "workload": per_bucket[0]["workload"],
            "precision": precision,
            "bucket": "all",
            "calls": calls,
            "mean_s": seconds / calls,
            # calls-weighted averages keep run-to-run semantics (see module doc)
            "std_s": sum(r["std_s"] * r["calls"] for r in per_bucket) / calls,
            "cv": sum(r["cv"] * r["calls"] for r in per_bucket) / calls,
            "min_s": min(r["min_s"] for r in per_bucket),
            "max_s": max(r["max_s"] for r in per_bucket),
            "tainted_calls": sum(r["tainted_calls"] for r in per_bucket),
        }
        if images and seconds > 0:
            rollup["img_per_s"] = images / seconds
        rows.append(rollup)
    return rows


def render_table2(rows: List[dict]) -> str:
    """Fixed-width text table (bench output / CI logs)."""
    if not rows:
        return "(no table2 rows — registry has no healthy dispatches)"
    hdr = (f"{'net':<14} {'prec':<6} {'bucket':>6} {'calls':>6} "
           f"{'mean_ms':>9} {'std_ms':>8} {'cv':>7} {'tainted':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['net']:<14} {r['precision']:<6} {str(r['bucket']):>6} "
            f"{r['calls']:>6d} {r['mean_s'] * 1e3:>9.3f} "
            f"{r['std_s'] * 1e3:>8.3f} {r['cv']:>7.3f} "
            f"{r['tainted_calls']:>8d}")
    return "\n".join(lines)
