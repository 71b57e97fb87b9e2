"""The port's bench-artifact pass (`repro_torch.analysis.check.
bench_schema`, a copy) gives the JAX package's report on
``BENCH_deconv.json`` and on each mutant of the reference test's
well-formed document: the same violations (rule id, severity, message,
location, fix hint) in the same order."""
import copy
import json
import math
import pathlib

import pytest

from repro.analysis.check import check_bench_doc as jcheck_doc
from repro.analysis.check import check_bench_json as jcheck_json
from repro.analysis.check.bench_schema import ROW_KEYS as JROW_KEYS
from repro.analysis.check.bench_schema import SECTIONS as JSECTIONS
from repro_torch.analysis.check import check_bench_doc, check_bench_json
from repro_torch.analysis.check.bench_schema import ROW_KEYS, SECTIONS

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _doc():
    """The reference test's well-formed document."""
    doc = {name: typ() for name, typ in SECTIONS.items()}
    doc["table2"] = [{
        "net": "dcnn-mnist", "precision": "fp32", "bucket": 4, "calls": 5,
        "mean_s": 0.01, "std_s": 0.001, "cv": 0.1, "tainted_calls": 0}]
    doc["traffic"] = [{
        "net": "dcnn-mnist", "layer": "L1", "in_bytes_per_tile": 4096,
        "halo_total_bytes": 65536, "full_image_total_bytes": 262144,
        "traffic_reduction": 4.0}]
    doc["autotune"] = [{
        "net": "dcnn-mnist", "layer": "L1", "fixed_tiles": {"t_oh": 32},
        "tuned_tiles": {"t_oh": 16}, "fixed_us": 10.0, "tuned_us": 8.0}]
    doc["scaling"] = [{
        "in_hw": 16, "out_hw": 32, "halo_in_bytes_per_tile": 4096,
        "full_in_bytes_per_tile": 16384, "n_tiles": 4}]
    doc["workloads"] = [{
        "workload": "sr", "net": "sr-espcn-x2", "precision": "fp32",
        "bucket": 4, "calls": 3, "mean_s": 0.01, "cv": 0.1}]
    return doc


def _set(path, value):
    def edit(doc):
        *head, last = path
        for k in head:
            doc = doc[k]
        doc[last] = value
    return edit


def _del(path):
    def edit(doc):
        *head, last = path
        for k in head:
            doc = doc[k]
        del doc[last]
    return edit


MUTANTS = {
    "wellformed": lambda d: None,
    "empty_table2": _set(["table2"], []),
    "legacy_table2_row": _set(["table2"], [{
        "net": "dcnn-mnist", "layer": "L1", "rl_gops": 1.0, "rl_cv": 0.1,
        "zi_gops": 0.5, "zi_cv": 0.2, "useful_mac_ratio_zi": 0.25,
        "rl_us": 10.0, "zi_us": 20.0}]),
    "table2_row_of_neither_schema": _set(["table2"], [{
        "net": "dcnn-mnist", "mean_s": 0.01}]),
    "table2_cv_over_ceiling": _set(["table2", 0, "cv"], 2.5),
    "empty_workloads": _set(["workloads"], []),
    "workloads_row_missing_key": _del(["workloads", 0, "workload"]),
    "missing_section": _del(["serving"]),
    "wrong_section_shape": _set(["traffic"], {"not": "a list"}),
    "unknown_section": _set(["mystery"], []),
    "missing_row_key": _del(["traffic", 0, "halo_total_bytes"]),
    "nan_value": _set(["serving", "p99_ms"], float("nan")),
    "inf_value": _set(["serving", "p99_ms"], float("inf")),
    "nested_nan": _set(["traffic", 0, "traffic_reduction"], float("nan")),
    "not_an_object": lambda d: d.clear(),
}


def _report(r):
    return [(v.rule_id, v.severity.name, v.message, v.location, v.fix_hint)
            for v in r.violations]


def test_sections_and_row_keys_are_the_reference_ones():
    assert SECTIONS == JSECTIONS and ROW_KEYS == JROW_KEYS


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_gives_the_reference_report(name):
    doc = _doc()
    MUTANTS[name](doc)
    if name == "not_an_object":
        doc = []
    want, got = jcheck_doc(copy.deepcopy(doc)), check_bench_doc(doc)
    assert _report(got) == _report(want)
    assert got.ok(strict=True) == want.ok(strict=True)
    assert got.rules_run == want.rules_run
    assert (name in ("wellformed", "legacy_table2_row")) == got.ok(strict=True)


def test_repo_artifact_gives_the_reference_report():
    path = str(ROOT / "BENCH_deconv.json")
    want, got = jcheck_json(path), check_bench_json(path)
    assert _report(got) == _report(want)
    assert got.render(strict=True) == want.render(strict=True)


@pytest.mark.parametrize("content", ["missing", "{nope", "nan"])
def test_files_on_disk_give_the_reference_report(content, tmp_path):
    path = tmp_path / "BENCH_deconv.json"
    if content == "nan":
        doc = _doc()
        doc["degraded"]["gops"] = math.nan
        path.write_text(json.dumps(doc))
    elif content != "missing":
        path.write_text(content)
    want, got = jcheck_json(str(path)), check_bench_json(str(path))
    assert _report(got) == _report(want) and not got.ok()
