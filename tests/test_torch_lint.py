"""The concurrency lint over the port: the JAX package's lint finds no
ERROR on the port's threaded modules, with no rule waived (its default
allowlist, nothing added); the port's copy of the lint reports the JAX
lint's violations on every port file; and its default targets are the
port's threaded modules."""
import pathlib

import pytest

from repro.analysis.check.concurrency import lint_files
from repro_torch.analysis.check import concurrency as tlint

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
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "src" / "repro_torch").rglob("*.py"))


@pytest.mark.parametrize("path", TARGETS)
def test_concurrency_lint_finds_no_error(path):
    report = lint_files([str(ROOT / path)])
    assert report.rules_run
    assert not report.errors(), report.render()


def _violations(report):
    return [(v.rule_id, v.severity.name, v.message, v.location, v.fix_hint)
            for v in report.violations]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_lint_reports_the_reference_lint(path):
    want = lint_files([str(ROOT / path)])
    got = tlint.lint_files([str(ROOT / path)])
    assert _violations(got) == _violations(want)
    assert got.rules_run == want.rules_run


def test_port_lint_targets_the_threaded_modules():
    got = sorted(str(pathlib.Path(p).resolve().relative_to(ROOT))
                 for p in tlint.default_target_files())
    assert got == sorted(TARGETS)
    report = tlint.lint_files()
    assert not report.errors(), report.render()
