"""Finding what ``BENCHMARK.json`` names, by name.

Each cell names a configuration (its file is given in ``configs``) and a
traffic mix (``bench/traffic/<name>.json``).  A configuration names its
family (``bench/configs/<family>.py``: sizes, weights, counts and the plain
reference) and the system that serves it (``bench/systems/<system>.py``:
the adapter to the program).  Each metric is a reader of its own,
``bench/metrics/<name>.py``.  So a new cell, configuration, traffic mix or
metric is new files and new entries, never an edit of a file that is
there."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class UnknownName(LookupError):
    """A name that the benchmark does not define, or that is not a name."""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _checked(name: str, what: str) -> str:
    if not isinstance(name, str) or NAME.fullmatch(name) is None:
        raise UnknownName(f"{what} {name!r} is not a name")
    return name


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise UnknownName(f"no {what} named {name!r}; there are "
                      f"{sorted(e['name'] for e in entries)}")


def load_config(bench: dict, name: str,
                root: pathlib.Path = ROOT) -> dict:
    entry = _entry(bench["configs"], _checked(name, "configuration"),
                   "configuration")
    cfg = json.loads((pathlib.Path(root) / entry["file"]).read_text())
    if cfg.get("name") != name:
        raise UnknownName(f"{entry['file']} holds {cfg.get('name')!r}, "
                          f"not {name!r}")
    return cfg


def load_traffic(name: str, root: pathlib.Path = ROOT) -> dict:
    path = pathlib.Path(root) / "bench" / "traffic" / (
        _checked(name, "traffic mix") + ".json")
    if not path.is_file():
        raise UnknownName(f"no traffic mix named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
    """``bench/<kind>/<name>.py`` as a module of its own (metric names hold
    dots, so these files are loaded by path, not imported)."""
    path = pathlib.Path(root) / "bench" / kind / (
        _checked(name, kind[:-1]) + ".py")
    if not path.is_file():
        raise UnknownName(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> Cell:
    w = _entry(bench["workloads"], _checked(name, "workload"), "workload")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_config(bench, w["config"], root),
        traffic=load_traffic(w["traffic"], root),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_readers(metrics: List[dict],
                   root: pathlib.Path = ROOT) -> Dict[str, object]:
    """Each metric's ``read`` function, by the metric's name."""
    return {m["name"]: load_module("metrics", m["name"], root).read
            for m in metrics}
