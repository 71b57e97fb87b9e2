"""Rule-engine core shared by every static verification pass (the JAX
package's ``repro.analysis.check.rules``, copied).

The FPGA flow the paper builds on never runs an unverified bitstream:
the toolchain *statically* proves resource budgets and timing before
synthesis signs off.  This module is the port's chassis for the same
discipline: a typed violation record, severity levels, a registry of
named rules, and a report that renders rule-by-rule for humans or
machines.  The rules live in `plan_drc` (plan design-rule check against
the H100), `concurrency` (lock-discipline lint) and `bench_schema`
(benchmark artifact validation); all three emit `PlanRuleViolation`s
through this one chassis so the CLI, the example script and the serving
engine agree on what "clean" means.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional, Sequence


class Severity(enum.IntEnum):
    """Violation severity.  ERROR always fails a check run; WARNING
    fails only under ``--strict`` (the CI gate); INFO never fails."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # pragma: no cover
        return self.name


@dataclasses.dataclass(frozen=True)
class PlanRuleViolation:
    """One design-rule violation, carrying everything a human needs to
    fix it offline: the rule id (stable, testable), where it fired
    (layer index for plan rules, file:line for lint rules), what is
    wrong, and the fix hint."""

    rule_id: str
    severity: Severity
    message: str
    fix_hint: str = ""
    layer: Optional[int] = None
    location: Optional[str] = None

    def render(self) -> str:
        where = ""
        if self.location is not None:
            where = f" [{self.location}]"
        elif self.layer is not None:
            where = f" [layer {self.layer}]"
        out = f"{self.severity.name:7s} {self.rule_id}{where}: {self.message}"
        if self.fix_hint:
            out += f"\n        fix: {self.fix_hint}"
        return out


class PlanCheckError(ValueError):
    """A check pass found ERROR-level violations.

    The typed rejection the serving engine raises when a pinned plan
    fails DRC at load — the caller gets the full violation list instead
    of a mid-serve crash (or a traceback pointing into kernel guts)."""

    def __init__(self, message: str,
                 violations: Sequence[PlanRuleViolation] = ()):
        super().__init__(message)
        self.violations = tuple(violations)

    def report(self) -> str:
        lines = [str(self)]
        lines += [v.render() for v in self.violations]
        return "\n".join(lines)


@dataclasses.dataclass
class CheckReport:
    """Accumulated violations of one check run (possibly many passes)."""

    name: str
    violations: List[PlanRuleViolation] = dataclasses.field(
        default_factory=list)
    rules_run: List[str] = dataclasses.field(default_factory=list)

    def extend(self, violations: Sequence[PlanRuleViolation]) -> None:
        self.violations.extend(violations)

    def merge(self, other: "CheckReport") -> None:
        self.violations.extend(other.violations)
        self.rules_run.extend(r for r in other.rules_run
                              if r not in self.rules_run)

    def by_rule(self) -> Dict[str, List[PlanRuleViolation]]:
        out: Dict[str, List[PlanRuleViolation]] = {}
        for v in self.violations:
            out.setdefault(v.rule_id, []).append(v)
        return out

    def errors(self) -> List[PlanRuleViolation]:
        return [v for v in self.violations if v.severity >= Severity.ERROR]

    def failures(self, strict: bool = False) -> List[PlanRuleViolation]:
        """What gates: ERRORs always, WARNINGs too under strict."""
        bar = Severity.WARNING if strict else Severity.ERROR
        return [v for v in self.violations if v.severity >= bar]

    def ok(self, strict: bool = False) -> bool:
        return not self.failures(strict)

    def render(self, strict: bool = False) -> str:
        """Rule-by-rule human report (the `--plan-json` failure output)."""
        lines = [f"== {self.name}: "
                 f"{len(self.violations)} violation(s), "
                 f"{len(self.failures(strict))} gating"
                 f"{' (strict)' if strict else ''} =="]
        for rule_id in sorted(self.by_rule()):
            lines.append(f"-- {rule_id} --")
            lines += [v.render() for v in self.by_rule()[rule_id]]
        if not self.violations:
            lines.append("clean: no violations")
        return "\n".join(lines)

    def raise_if_failed(self, strict: bool = False) -> None:
        bad = self.failures(strict)
        if bad:
            raise PlanCheckError(
                f"{self.name}: {len(bad)} gating violation(s)", bad)


# -- registry ----------------------------------------------------------
# Rules register under a stable id so tests can assert "this mutation
# fires exactly that rule" and the README's rule table can be generated
# instead of hand-maintained.
_RULES: Dict[str, "Rule"] = {}


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    description: str
    default_severity: Severity
    fn: Callable

    def violation(self, message: str, *, fix_hint: str = "",
                  layer: Optional[int] = None,
                  location: Optional[str] = None,
                  severity: Optional[Severity] = None) -> PlanRuleViolation:
        return PlanRuleViolation(
            rule_id=self.rule_id,
            severity=(self.default_severity if severity is None
                      else severity),
            message=message, fix_hint=fix_hint, layer=layer,
            location=location)


def rule(rule_id: str, description: str,
         severity: Severity = Severity.ERROR):
    """Decorator: register a check function under a stable rule id.

    The decorated function receives the `Rule` as its first argument
    (so it mints violations with the right id/severity) and returns a
    list of `PlanRuleViolation`s."""
    def deco(fn: Callable) -> Rule:
        r = Rule(rule_id=rule_id, description=description,
                 default_severity=severity, fn=fn)
        if rule_id in _RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        _RULES[rule_id] = r

        def run(*args, **kwargs) -> List[PlanRuleViolation]:
            return fn(r, *args, **kwargs)

        run.rule = r                      # type: ignore[attr-defined]
        run.rule_id = rule_id             # type: ignore[attr-defined]
        run.__name__ = fn.__name__
        run.__doc__ = fn.__doc__
        return run
    return deco


def registered_rules() -> Dict[str, Rule]:
    """{rule_id: Rule} over everything imported so far (the README rule
    table and the CLI's --list-rules render from this)."""
    # import the passes for their registration side effects
    from . import bench_schema, concurrency, plan_drc  # noqa: F401
    return dict(_RULES)
