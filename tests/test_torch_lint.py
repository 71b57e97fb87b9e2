"""The JAX package's concurrency lint over the port's threaded modules:
no ERROR, and no rule waived (the lint's default allowlist, nothing
added)."""
import pathlib

import pytest

from repro.analysis.check.concurrency import lint_files

ROOT = pathlib.Path(__file__).resolve().parents[1]
TARGETS = ["src/repro_torch/serve/engine.py",
           "src/repro_torch/workloads/registry.py",
           "src/repro_torch/serve/frontend.py",
           "src/repro_torch/serve/scheduler.py",
           "src/repro_torch/obs/metrics.py",
           "src/repro_torch/obs/trace.py",
           "src/repro_torch/dist/fault.py",
           "src/repro_torch/ckpt/checkpoint.py",
           "src/repro_torch/data/pipeline.py"]


@pytest.mark.parametrize("path", TARGETS)
def test_concurrency_lint_finds_no_error(path):
    report = lint_files([str(ROOT / path)])
    assert report.rules_run
    assert not report.errors(), report.render()
