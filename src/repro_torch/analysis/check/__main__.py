"""CLI for the static verification subsystem.

    python -m repro_torch.analysis.check                    # lint serve stack
    python -m repro_torch.analysis.check --strict           # CI gate
    python -m repro_torch.analysis.check --plan-json p.json # + plan DRC
    python -m repro_torch.analysis.check --bench BENCH_deconv.json
    python -m repro_torch.analysis.check --list-rules

Exit status 0 iff every requested pass is clean (WARNINGs gate too
under ``--strict``)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from .bench_schema import check_bench_json
from .concurrency import Allowlist, lint_files
from .plan_drc import check_plan_json
from .rules import CheckReport, registered_rules


def _json_report(report: CheckReport, strict: bool) -> str:
    return json.dumps({
        "name": report.name,
        "ok": report.ok(strict),
        "rules_run": report.rules_run,
        "violations": [
            {**dataclasses.asdict(v), "severity": v.severity.name}
            for v in report.violations],
    }, indent=1)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static verification: plan DRC, concurrency lint, "
                    "bench-artifact schema.")
    ap.add_argument("--strict", action="store_true",
                    help="WARNING-level violations also fail the run")
    ap.add_argument("--plan-json", nargs="*", default=[], metavar="PATH",
                    help="pinned NetworkPlan JSON(s) to design-rule check")
    ap.add_argument("--bench", nargs="*", default=[], metavar="PATH",
                    help="BENCH_deconv.json artifact(s) to validate")
    ap.add_argument("--lint", nargs="*", default=None, metavar="FILE",
                    help="Python files to concurrency-lint (default: the "
                         "threaded serve stack; pass with no files to "
                         "skip the lint pass)")
    ap.add_argument("--allowlist", metavar="FILE",
                    help="allowlist file (ClassName.attr[:read] lines) "
                         "replacing the built-in one")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every registered rule id and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule_id, r in sorted(registered_rules().items()):
            print(f"{rule_id:24s} [{r.default_severity.name:7s}] "
                  f"{r.description}")
        return 0

    report = CheckReport("repro_torch.analysis.check")
    for path in args.plan_json:
        report.merge(check_plan_json(path))
    for path in args.bench:
        report.merge(check_bench_json(path))
    run_lint = args.lint is None or len(args.lint) > 0
    if run_lint:
        allow = (Allowlist.load(args.allowlist)
                 if args.allowlist else None)
        report.merge(lint_files(args.lint, allowlist=allow))

    if args.format == "json":
        print(_json_report(report, args.strict))
    else:
        print(report.render(args.strict))
    return 0 if report.ok(args.strict) else 1


if __name__ == "__main__":
    sys.exit(main())
