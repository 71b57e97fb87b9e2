"""Static verification subsystem: plan DRC, concurrency lint and the
bench-artifact schema, the JAX package's ``repro.analysis.check`` for the
port.

The FPGA flow in the source paper signs off resource budgets and timing
*before* synthesis; this package is the same discipline for the Hopper
kernels.  Three passes, one chassis:

* ``plan_drc`` — design-rule check over ``NetworkPlan``/``DeconvPlan``
  against the H100 (the kernel's dynamic shared memory and threads per
  block, its launch checks, int8 scale chaining and packing, sparse
  digests, bucket/mesh alignment, epilogue legality, roofline sanity)
  without launching a kernel.
* ``concurrency`` — AST lock-discipline lint over the threaded serve
  stack (guarded-attribute learning, lock-order inversions, callbacks
  under locks, check-then-act races).
* ``bench_schema`` — schema + NaN validation for ``BENCH_deconv.json``.

CLI: ``python -m repro_torch.analysis.check`` (see ``--help``); the
serving engine runs the plan DRC on every pinned plan at load and rejects
bad ones with a typed :class:`PlanCheckError` before any planning, kernel
build or graph capture.
"""
from .bench_schema import check_bench_doc, check_bench_json
from .concurrency import (Allowlist, DEFAULT_ALLOWLIST,
                          default_target_files, lint_file, lint_files)
from .plan_drc import check_network_plan, check_plan_json
from .rules import (CheckReport, PlanCheckError, PlanRuleViolation,
                    Severity, registered_rules)

__all__ = [
    "Allowlist", "CheckReport", "DEFAULT_ALLOWLIST", "PlanCheckError",
    "PlanRuleViolation", "Severity", "check_bench_doc",
    "check_bench_json", "check_network_plan", "check_plan_json",
    "default_target_files", "lint_file", "lint_files",
    "registered_rules",
]
