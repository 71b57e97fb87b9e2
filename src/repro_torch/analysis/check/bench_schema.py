"""Benchmark-artifact validation: `BENCH_deconv.json` schema + NaN scan
(the JAX package's pass, copied: it validates that package's artifact
exactly as the reference does; the port writes no such artifact yet).

`benchmarks/run.py --smoke` regenerates `BENCH_deconv.json` on every CI
run; this pass (same rule-engine plumbing as the plan DRC) makes the
smoke gate fail loudly when a refactor drops a section, renames a row
key, or lets a divide-by-zero leak a NaN into the artifact — all of
which previously surfaced only when a human read the report."""
from __future__ import annotations

import json
import math
import os
from typing import Any, List

from .rules import CheckReport, Severity, rule

#: {section: container type}.  Since the obs layer landed, ``table2`` is
#: populated in every mode (smoke emits interpret-mode rows via
#: `repro.obs.report`); `bench.table2_rows` rejects an empty section.
SECTIONS = {
    "table2": list, "traffic": list, "autotune": list, "scaling": list,
    "batch_sweep": list, "serving": dict, "sharded": dict, "quant": list,
    "plan": list, "degraded": dict, "slo": dict, "workloads": list,
}

#: obs-produced Table II rows (`repro.obs.report.table2_rows`) carry the
#: run-to-run statistics; legacy full-sweep rows carry the GOPS columns.
#: Either shape is a valid table2 row — `bench.table2_rows` requires one
#: of the two key sets to be complete.
TABLE2_STAT_KEYS = ("net", "precision", "bucket", "calls", "mean_s",
                    "std_s", "cv", "tainted_calls")
TABLE2_LEGACY_KEYS = ("net", "layer", "rl_gops", "rl_cv", "zi_gops",
                      "zi_cv")
#: generous healthy-run CV ceiling: interpret-mode CPU timing jitters,
#: but a healthy dispatch population whose std exceeds 1.5x its mean
#: means the "healthy" tagging broke (compiles or retries leaked in)
TABLE2_CV_MAX = 1.5

#: per-row required keys for the sections the smoke run always fills
ROW_KEYS = {
    "traffic": ("net", "layer", "in_bytes_per_tile", "halo_total_bytes",
                "full_image_total_bytes", "traffic_reduction"),
    "autotune": ("net", "layer", "fixed_tiles", "tuned_tiles",
                 "fixed_us", "tuned_us"),
    "scaling": ("in_hw", "out_hw", "halo_in_bytes_per_tile",
                "full_in_bytes_per_tile", "n_tiles"),
}


@rule("bench.sections",
      "BENCH_deconv.json is missing a section or has the wrong shape")
def check_sections(r, doc):
    out = []
    if not isinstance(doc, dict):
        return [r.violation(
            f"top level must be an object, got {type(doc).__name__}",
            fix_hint="regenerate with benchmarks/run.py")]
    for name, typ in SECTIONS.items():
        if name not in doc:
            out.append(r.violation(
                f"section {name!r} missing",
                location=name,
                fix_hint="regenerate with benchmarks/run.py (write_json "
                         "emits every section, empty or not)"))
        elif not isinstance(doc[name], typ):
            out.append(r.violation(
                f"section {name!r} should be a {typ.__name__}, got "
                f"{type(doc[name]).__name__}", location=name))
    for name in doc:
        if name not in SECTIONS:
            out.append(r.violation(
                f"unknown section {name!r}", location=name,
                severity=Severity.WARNING,
                fix_hint="add it to SECTIONS in bench_schema.py if it is "
                         "a new deliberate artifact"))
    return out


@rule("bench.keys", "a benchmark row is missing a required key")
def check_row_keys(r, doc):
    out = []
    if not isinstance(doc, dict):
        return out
    for section, keys in ROW_KEYS.items():
        rows = doc.get(section)
        if not isinstance(rows, list):
            continue
        for i, row in enumerate(rows):
            if not isinstance(row, dict):
                out.append(r.violation(
                    f"row {i} is not an object",
                    location=f"{section}[{i}]"))
                continue
            missing = [k for k in keys if k not in row]
            if missing:
                out.append(r.violation(
                    f"row {i} missing key(s) {', '.join(missing)}",
                    location=f"{section}[{i}]",
                    fix_hint="a rename in bench_deconv.py must update "
                             "ROW_KEYS (and the README tables) with it"))
    return out


@rule("bench.nan", "a benchmark value is NaN or infinite")
def check_finite(r, doc):
    out = []

    def scan(node: Any, path: str) -> None:
        if isinstance(node, float) and not math.isfinite(node):
            out.append(r.violation(
                f"non-finite value {node!r}", location=path,
                fix_hint="guard the producing division (bench rows use "
                         "max(denom, eps)) or drop the row"))
        elif isinstance(node, dict):
            for k, v in node.items():
                scan(v, f"{path}.{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                scan(v, f"{path}[{i}]")

    scan(doc, "$")
    return out


@rule("bench.table2_rows",
      "the table2 section is empty or a row matches neither schema")
def check_table2_rows(r, doc):
    out = []
    if not isinstance(doc, dict) or not isinstance(doc.get("table2"), list):
        return out          # shape problems are bench.sections' findings
    rows = doc["table2"]
    if not rows:
        return [r.violation(
            "table2 is empty: the bench no longer reports the paper's "
            "run-to-run variation statistics",
            location="table2",
            fix_hint="smoke mode must emit obs rows (bench_deconv."
                     "table2_obs_rows via repro.obs.report)")]
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            out.append(r.violation(f"row {i} is not an object",
                                   location=f"table2[{i}]"))
            continue
        if (any(k not in row for k in TABLE2_STAT_KEYS)
                and any(k not in row for k in TABLE2_LEGACY_KEYS)):
            out.append(r.violation(
                f"row {i} is neither an obs statistics row "
                f"({', '.join(TABLE2_STAT_KEYS)}) nor a legacy sweep row "
                f"({', '.join(TABLE2_LEGACY_KEYS)})",
                location=f"table2[{i}]",
                fix_hint="a key rename in obs/report.py or "
                         "bench_deconv.py must update TABLE2_*_KEYS"))
    return out


@rule("bench.table2_cv",
      "a healthy-run CV in table2 exceeds the pinned ceiling")
def check_table2_cv(r, doc):
    out = []
    if not isinstance(doc, dict) or not isinstance(doc.get("table2"), list):
        return out
    for i, row in enumerate(doc["table2"]):
        if not isinstance(row, dict) or "cv" not in row:
            continue        # legacy sweep rows carry rl_cv/zi_cv instead
        cv = row["cv"]
        if isinstance(cv, float) and not math.isfinite(cv):
            continue        # bench.nan's finding
        if cv > TABLE2_CV_MAX:
            out.append(r.violation(
                f"row {i} ({row.get('net')}/{row.get('precision')}/"
                f"b{row.get('bucket')}): healthy-run cv={cv:.3f} exceeds "
                f"{TABLE2_CV_MAX} — run-to-run variation regressed, or "
                "unhealthy samples (compiles, retries) leaked into the "
                "healthy population",
                location=f"table2[{i}]",
                fix_hint="check the engine's steady/tainted outcome "
                         "tagging before raising TABLE2_CV_MAX"))
    return out


#: workload-zoo serving rows: Table II statistics labeled by registry
#: workload (the zoo's proof that new towers serve with the same
#: run-to-run stability as the paper's generators)
WORKLOADS_ROW_KEYS = ("workload", "net", "precision", "bucket", "calls",
                      "mean_s", "cv")


@rule("bench.workloads_rows",
      "the workloads section is empty or a row is malformed")
def check_workloads_rows(r, doc):
    out = []
    if not isinstance(doc, dict) or not isinstance(
            doc.get("workloads"), list):
        return out          # shape problems are bench.sections' findings
    rows = doc["workloads"]
    if not rows:
        return [r.violation(
            "workloads is empty: the bench no longer serves the workload "
            "zoo (SR / denoising heads) through the engine",
            location="workloads",
            fix_hint="smoke mode must emit bench_deconv.workloads_rows")]
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            out.append(r.violation(f"row {i} is not an object",
                                   location=f"workloads[{i}]"))
            continue
        missing = [k for k in WORKLOADS_ROW_KEYS if k not in row]
        if missing:
            out.append(r.violation(
                f"row {i} missing key(s) {', '.join(missing)}",
                location=f"workloads[{i}]",
                fix_hint="a key rename in obs/report.py or "
                         "bench_deconv.py must update WORKLOADS_ROW_KEYS"))
    return out


BENCH_RULES = ("bench.sections", "bench.keys", "bench.nan",
               "bench.table2_rows", "bench.table2_cv",
               "bench.workloads_rows")


def check_bench_doc(doc, name: str = "BENCH_deconv.json") -> CheckReport:
    report = CheckReport(f"bench-schema:{name}")
    report.rules_run += list(BENCH_RULES)
    report.extend(check_sections(doc))
    report.extend(check_row_keys(doc))
    report.extend(check_finite(doc))
    report.extend(check_table2_rows(doc))
    report.extend(check_table2_cv(doc))
    report.extend(check_workloads_rows(doc))
    return report


def check_bench_json(path: str) -> CheckReport:
    """Validate a benchmark artifact on disk.  Unreadable/unparsable
    files report through ``bench.sections`` rather than raising — the
    smoke gate wants a report either way."""
    name = os.path.basename(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        report = CheckReport(f"bench-schema:{name}")
        report.rules_run += list(BENCH_RULES)
        report.extend([check_sections.rule.violation(
            f"cannot load {path}: {e}",
            fix_hint="regenerate with benchmarks/run.py --smoke")])
        return report
    return check_bench_doc(doc, name)
