"""Cells, configurations, traffic mixes and metrics found by name, and the
shape of ``BENCHMARK.json``."""
import json
import re
import shutil

import pytest

from benchkit import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = ("celeba.batch64", "mnist.batch64", "celeba.single", "celeba.mixed")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(bench, cell):
    c = spec.find_cell(bench, cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "images_per_s"}
    assert c.per_layer
    fam = spec.load_module("configs", c.config["family"])
    assert callable(fam.forward) and callable(fam.make_weights)
    assert spec.load_module("systems", c.config["system"]).System
    for read in spec.metric_readers(c.end_to_end + c.per_layer).values():
        assert callable(read)


def test_unknown_names_are_refused(bench):
    with pytest.raises(spec.UnknownName):
        spec.find_cell(bench, "celeba.nothing")
    with pytest.raises(spec.UnknownName):
        spec.load_config(bench, "dcnn-nothing")
    with pytest.raises(spec.UnknownName):
        spec.load_traffic("nothing")
    with pytest.raises(spec.UnknownName):
        spec.load_module("metrics", "nothing")
    with pytest.raises(spec.UnknownName):
        spec.load_traffic("../BENCHMARK")


def test_new_files_alone_add_a_cell_and_a_metric(tmp_path, bench):
    """A later change adds a configuration, a traffic mix and a metric as
    files and entries, and edits no file that exists."""
    root = tmp_path
    shutil.copytree(spec.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cfg = json.loads((root / "bench/configs/dcnn-mnist.json").read_text())
    cfg.update(name="dcnn-mnist-wide", img_c=3)
    cfg["layers"][-1]["c_out"] = 3
    (root / "bench/configs/dcnn-mnist-wide.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/batch8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "rows": {"kind": "fixed",
                                                  "value": 8},
         "buckets": [8], "pool_rows": 64, "check_requests": 4}))
    (root / "bench/metrics/rows_per_request.py").write_text(
        "def read(run):\n    return run.images / run.attempted\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "dcnn-mnist-wide", "source": "x",
                           "file": "bench/configs/dcnn-mnist-wide.json",
                           "reduced": ["img_c"], "why": "x"})
    new["workloads"].append({"name": "mnistw.batch8",
                             "config": "dcnn-mnist-wide",
                             "traffic": "batch8", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "rows_per_request", "unit": "rows",
                             "better": "higher", "source": "host_clock",
                             "layer": "serve engine", "moves": "images_per_s",
                             "workloads": ["mnistw.batch8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.find_cell(spec.load_benchmark(root), "mnistw.batch8", root)
    assert cell.config["img_c"] == 3 and cell.traffic["buckets"] == [8]
    assert [m["name"] for m in cell.per_layer] == ["rows_per_request"]
    read = spec.metric_readers(cell.per_layer, root)["rows_per_request"]

    class Run:
        images, attempted = 80, 10

    assert read(Run) == 8
    fam = spec.load_module("configs", cell.config["family"], root)
    assert fam.layers(cell.config)[-1]["c_out"] == 3


def test_benchmark_file_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["file"].startswith("bench/")
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.fullmatch(m["unit"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.fullmatch(m["unit"])
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        c = spec.find_cell(bench, cell)
        assert any(m["name"] == "setup_s" for m in c.end_to_end)
        assert len(c.end_to_end) >= 2 and c.per_layer
