"""Pass 2 — AST lock-discipline lint over the threaded serve stack (the
JAX package's lint, copied; only `default_target_files` names the port's
modules, so both lints report the same violations on any file).

The serving engine, the async frontend, and the fault primitives are the
only genuinely concurrent code in the repo, and their discipline is
conventions in comments ("_qlock guards the queue state", "lock order:
_cond before _slock").  This pass turns those comments into checked
rules — statically, the way the plan DRC checks VMEM budgets without
running a kernel:

* **guarded-attribute learning** — a class's lock attributes are the
  ``self.X = threading.Lock()/RLock()/Condition()`` assignments; an
  instance attribute is *guarded* by the locks held at every one of its
  non-constructor assignments.  A write to a guarded attribute outside
  its guard is ``lint.unguarded_write`` (ERROR); a read outside it is
  ``lint.unguarded_read`` (WARNING — some stats reads are intentionally
  lock-free, which is what the allowlist is for).
* **call-site lock propagation** — a ``*_locked`` helper inherits the
  locks held at every one of its call sites (the repo convention:
  `_drain_locked`, `_pick_wave_locked`, ...), so accesses inside it are
  not falsely flagged.  Explicit ``self.X.acquire()`` / ``release()``
  pairs are tracked through the enclosing statement list.
* **lock-order inversion** — every "acquire L while holding H" pair is
  collected (one level of transitivity through self-calls); seeing both
  H->L and L->H is ``lint.lock_order`` (ERROR): two threads taking the
  locks in opposite orders is a deadlock waiting for load.
* **callback under lock** — invoking a configurable callback name
  (``on_failure``, ``before_call``, ...) while holding any lock is
  ``lint.callback_in_lock`` (WARNING): a callback that re-enters the
  lock owner deadlocks (the Heartbeat deliberately fires OUTSIDE its
  lock for exactly this reason).
* **check-then-act** — ``if self.flag: ... self.flag = ...`` on a bare
  boolean/None flag with no lock held, in a class that owns locks, is
  ``lint.check_then_act`` (ERROR): the window between the check and the
  set admits two winners (the frontend's double-`start()` race).

The linter is intentionally conservative: attributes never assigned
under a lock are presumed single-threaded by design and not reported
(the engine's lazy `_fns`/`plans` caches are that, documented); only
attributes the code *itself* treats as lock-guarded somewhere are held
to that discipline everywhere.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .rules import CheckReport, PlanRuleViolation, Severity, rule

LOCK_FACTORIES = ("Lock", "RLock", "Condition")
CONSTRUCTOR_METHODS = ("__init__", "__new__", "_setup")
CALLBACK_NAMES = ("on_failure", "on_stall", "on_error", "on_complete",
                  "before_call", "callback")
LOCKED_HELPER_SUFFIX = "_locked"


# ---------------------------------------------------------------------------
# allowlist
# ---------------------------------------------------------------------------
class Allowlist:
    """Suppressions for intentionally lock-free accesses.

    Entries are ``ClassName.attr`` (suppresses reads and writes) or
    ``ClassName.attr:read`` (reads only); ``#`` starts a comment.  The
    default allowlist documents the serve stack's deliberate lock-free
    surfaces (single-threaded dispatch caches, stats snapshots)."""

    def __init__(self, entries: Sequence[str] = ()):
        self._all: Set[Tuple[str, str]] = set()
        self._read: Set[Tuple[str, str]] = set()
        for line in entries:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            kind = "all"
            if ":" in line:
                line, kind = line.rsplit(":", 1)
                kind = kind.strip()
                if kind not in ("read", "all"):
                    raise ValueError(
                        f"allowlist entry {line!r}: kind must be 'read' "
                        f"or 'all', got {kind!r}")
            if "." not in line:
                raise ValueError(
                    f"allowlist entry {line!r}: expected ClassName.attr")
            cls, attr = line.rsplit(".", 1)
            (self._all if kind == "all" else self._read).add(
                (cls.strip(), attr.strip()))

    def allows(self, cls: str, attr: str, kind: str) -> bool:
        if (cls, attr) in self._all:
            return True
        return kind == "read" and (cls, attr) in self._read

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        with open(path) as f:
            return cls(f.read().splitlines())


#: deliberate lock-free surfaces in the serve stack (see class docstring)
DEFAULT_ALLOWLIST = Allowlist([
    "DcnnServeEngine.stats",          # dispatch is single-threaded
    "DcnnServeEngine.bucket_stats",   # idem (timing accounting)
    "DcnnServeEngine.trace_counts",   # the JAX engine's (kept: same lint)
    "DcnnServeEngine.plan_stats",
    "DcnnServeEngine.fault_stats:read",   # snapshot reads are lock-free
    "AsyncServeFrontend._worker_errors:read",
])


# ---------------------------------------------------------------------------
# per-method facts collected by the AST walk
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Access:
    attr: str
    kind: str                      # "read" | "write"
    held: FrozenSet[str]
    lineno: int
    method: str


@dataclasses.dataclass
class _MethodFacts:
    name: str
    accesses: List[_Access] = dataclasses.field(default_factory=list)
    # self-calls: (callee, held, lineno)
    calls: List[Tuple[str, FrozenSet[str], int]] = dataclasses.field(
        default_factory=list)
    # lock acquisitions: (held_before, lock, lineno)
    acquires: List[Tuple[FrozenSet[str], str, int]] = dataclasses.field(
        default_factory=list)
    # callback invocations: (callback_name, held, lineno)
    callbacks: List[Tuple[str, FrozenSet[str], int]] = dataclasses.field(
        default_factory=list)
    # bare-flag check-then-act candidates: (attr, lineno)
    flag_races: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class _ClassFacts:
    name: str
    locks: Set[str]
    methods: Dict[str, _MethodFacts]


def _self_attr(node: ast.AST) -> Optional[str]:
    """'attr' for an ``self.attr`` Attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _subscript_base_attr(node: ast.AST) -> Optional[str]:
    """Base ``self.attr`` of a (possibly nested) subscript chain:
    ``self.a[k]``, ``self.a[k][j]`` -> "a"."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return _self_attr(node)


def _is_lock_factory(node: ast.AST) -> bool:
    """True for ``threading.Lock()`` / ``Lock()`` / RLock / Condition."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = (f.attr if isinstance(f, ast.Attribute)
            else f.id if isinstance(f, ast.Name) else None)
    return name in LOCK_FACTORIES


class _MethodWalker:
    """Walks one method body tracking the set of held locks."""

    def __init__(self, cls: "_ClassFacts", method: str):
        self.cls = cls
        self.facts = _MethodFacts(method)
        self.method_names: Set[str] = set()   # filled by caller

    # -- expression-level recording ------------------------------------
    def _record_expr(self, node: ast.AST, held: FrozenSet[str],
                     skip: Tuple[ast.AST, ...] = ()) -> None:
        """Record reads / self-calls / acquires / callbacks in an
        expression subtree.  ``skip`` holds Attribute nodes already
        counted as write targets."""
        for sub in ast.walk(node):
            if sub in skip:
                continue
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Attribute):
                    base = _self_attr(f.value)    # self.X.m() -> X
                    if base in self.cls.locks:
                        if f.attr == "acquire":
                            self.facts.acquires.append(
                                (held, base, sub.lineno))
                        continue  # lock-method call; not a data access
                    if (_self_attr(f) in self.method_names):
                        self.facts.calls.append((f.attr, held, sub.lineno))
                    if f.attr in CALLBACK_NAMES:
                        self.facts.callbacks.append(
                            (f.attr, held, sub.lineno))
            attr = _self_attr(sub)
            if attr is None:
                continue
            if attr in self.cls.locks or attr in self.method_names:
                continue
            if isinstance(sub.ctx, ast.Load):
                self.facts.accesses.append(_Access(
                    attr, "read", held, sub.lineno, self.facts.name))

    def _record_write_target(self, target: ast.AST,
                             held: FrozenSet[str]) -> List[ast.AST]:
        """Record writes for an assignment target; returns the Attribute
        nodes consumed as write bases (so they are not double-counted as
        reads)."""
        consumed: List[ast.AST] = []
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                consumed += self._record_write_target(el, held)
            return consumed
        if isinstance(target, ast.Starred):
            return self._record_write_target(target.value, held)
        attr = _self_attr(target)
        if attr is not None:
            if attr not in self.cls.locks:
                self.facts.accesses.append(_Access(
                    attr, "write", held, target.lineno, self.facts.name))
            consumed.append(target)
            return consumed
        if isinstance(target, ast.Subscript):
            base = target
            while isinstance(base, ast.Subscript):
                # slice expressions are ordinary reads
                self._record_expr(base.slice, held)
                base = base.value
            battr = _self_attr(base)
            if battr is not None and battr not in self.cls.locks:
                self.facts.accesses.append(_Access(
                    battr, "write", held, target.lineno, self.facts.name))
                consumed.append(base)
            else:
                self._record_expr(base, held)
            return consumed
        # non-self target (local, req.field, ...): its value expr may
        # still contain reads
        self._record_expr(target, held)
        return consumed

    # -- statement walking ----------------------------------------------
    def _lock_events(self, stmt: ast.stmt) -> Tuple[Set[str], Set[str]]:
        """Locks explicitly acquire()d / release()d anywhere in ``stmt``
        (for tracking held state through the enclosing statement list)."""
        acq: Set[str] = set()
        rel: Set[str] = set()
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute):
                base = _self_attr(sub.func.value)
                if base in self.cls.locks:
                    if sub.func.attr == "acquire":
                        acq.add(base)
                    elif sub.func.attr == "release":
                        rel.add(base)
        return acq, rel

    def walk_body(self, body: Sequence[ast.stmt],
                  held: FrozenSet[str]) -> None:
        tracked: Set[str] = set()
        for stmt in body:
            self._walk_stmt(stmt, held | frozenset(tracked))
            acq, rel = self._lock_events(stmt)
            tracked |= acq
            tracked -= rel

    def _walk_stmt(self, stmt: ast.stmt, held: FrozenSet[str]) -> None:
        if isinstance(stmt, ast.With):
            inner = set(held)
            for item in stmt.items:
                attr = _self_attr(item.context_expr)
                if attr in self.cls.locks:
                    self.facts.acquires.append(
                        (held, attr, stmt.lineno))
                    inner.add(attr)
                else:
                    self._record_expr(item.context_expr, held)
            self.walk_body(stmt.body, frozenset(inner))
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            consumed: List[ast.AST] = []
            for t in targets:
                consumed += self._record_write_target(t, held)
            if getattr(stmt, "value", None) is not None:
                self._record_expr(stmt.value, held, skip=tuple(consumed))
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                attr = _self_attr(t) or _subscript_base_attr(t)
                if attr is not None and attr not in self.cls.locks:
                    self.facts.accesses.append(_Access(
                        attr, "write", held, stmt.lineno, self.facts.name))
                else:
                    self._record_expr(t, held)
        elif isinstance(stmt, ast.If):
            self._record_expr(stmt.test, held)
            self._flag_race_check(stmt, held)
            self.walk_body(stmt.body, held)
            self.walk_body(stmt.orelse, held)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._record_expr(stmt.iter, held)
            self._record_write_target(stmt.target, held)
            self.walk_body(stmt.body, held)
            self.walk_body(stmt.orelse, held)
        elif isinstance(stmt, ast.While):
            self._record_expr(stmt.test, held)
            self.walk_body(stmt.body, held)
            self.walk_body(stmt.orelse, held)
        elif isinstance(stmt, ast.Try):
            self.walk_body(stmt.body, held)
            for h in stmt.handlers:
                self.walk_body(h.body, held)
            self.walk_body(stmt.orelse, held)
            self.walk_body(stmt.finalbody, held)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested closure runs at an unknown later time: the locks
            # held at definition say nothing about the locks held at call
            self.walk_body(stmt.body, frozenset())
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._record_expr(stmt.value, held)
        elif isinstance(stmt, ast.Expr):
            self._record_expr(stmt.value, held)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            self._record_expr(stmt, held)
        elif isinstance(stmt, ast.ClassDef):
            pass
        else:
            self._record_expr(stmt, held)

    def _flag_race_check(self, stmt: ast.If,
                         held: FrozenSet[str]) -> None:
        """``if self.flag: ... self.flag = ...`` with no lock held."""
        if held & self.cls.locks:
            return
        flags = self._bare_flag_attrs(stmt.test)
        if not flags:
            return
        written: Set[str] = set()
        for sub in ast.walk(stmt):
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        written.add(attr)
        for attr in flags & written:
            self.facts.flag_races.append((attr, stmt.lineno))

    def _bare_flag_attrs(self, test: ast.expr) -> Set[str]:
        """self-attributes used as bare boolean/None flags in a test:
        ``self.a``, ``not self.a``, ``self.a is (not) None``.  Membership
        or comparison tests are excluded — flagging every lazy-cache
        ``if key not in self.cache`` would drown the one real race."""
        out: Set[str] = set()
        nodes = [test]
        while nodes:
            n = nodes.pop()
            if isinstance(n, ast.BoolOp):
                nodes += n.values
                continue
            if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                nodes.append(n.operand)
                continue
            attr = _self_attr(n)
            if attr is not None and attr not in self.cls.locks:
                out.add(attr)
                continue
            if (isinstance(n, ast.Compare) and len(n.ops) == 1
                    and isinstance(n.ops[0], (ast.Is, ast.IsNot))
                    and isinstance(n.comparators[0], ast.Constant)
                    and n.comparators[0].value is None):
                a = _self_attr(n.left)
                if a is not None and a not in self.cls.locks:
                    out.add(a)
        return out


# ---------------------------------------------------------------------------
# class-level analysis
# ---------------------------------------------------------------------------
def _collect_class(node: ast.ClassDef) -> _ClassFacts:
    method_defs = [n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    method_names = {m.name for m in method_defs}
    locks: Set[str] = set()
    for m in method_defs:
        for sub in ast.walk(m):
            if isinstance(sub, ast.Assign) and _is_lock_factory(sub.value):
                for t in sub.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        locks.add(attr)
    cls = _ClassFacts(node.name, locks, {})
    for m in method_defs:
        w = _MethodWalker(cls, m.name)
        w.method_names = method_names
        w.walk_body(m.body, frozenset())
        cls.methods[m.name] = w.facts
    return cls


def _propagated_held(cls: _ClassFacts) -> Dict[str, FrozenSet[str]]:
    """Locks a ``*_locked`` helper inherits: the intersection of the
    locks held at every one of its in-class call sites."""
    sites: Dict[str, List[FrozenSet[str]]] = {}
    for mf in cls.methods.values():
        for callee, held, _ in mf.calls:
            sites.setdefault(callee, []).append(held)
    out: Dict[str, FrozenSet[str]] = {}
    for name, helds in sites.items():
        if not name.endswith(LOCKED_HELPER_SUFFIX):
            continue
        common = frozenset.intersection(*helds) if helds else frozenset()
        if common:
            out[name] = common
    return out


def _effective_accesses(cls: _ClassFacts) -> List[_Access]:
    extra = _propagated_held(cls)
    out: List[_Access] = []
    for mf in cls.methods.values():
        add = extra.get(mf.name, frozenset())
        for a in mf.accesses:
            out.append(dataclasses.replace(a, held=a.held | add)
                       if add else a)
    return out


def _lock_order_pairs(cls: _ClassFacts
                      ) -> Dict[Tuple[str, str], List[Tuple[str, int]]]:
    """(outer, inner) -> [(method, line)] over every acquire made while
    holding another lock, with call-site propagation and one level of
    transitivity through self-calls."""
    extra = _propagated_held(cls)
    pairs: Dict[Tuple[str, str], List[Tuple[str, int]]] = {}

    def note(held: FrozenSet[str], lock: str, method: str,
             line: int) -> None:
        for h in held:
            if h != lock:
                pairs.setdefault((h, lock), []).append((method, line))

    for mf in cls.methods.values():
        add = extra.get(mf.name, frozenset())
        for held, lock, line in mf.acquires:
            note(held | add, lock, mf.name, line)
        # one level through self-calls: m holds H and calls c; c's own
        # acquires happen with H additionally held
        for callee, held, line in mf.calls:
            held = held | add
            if not held:
                continue
            cf = cls.methods.get(callee)
            if cf is None:
                continue
            for inner_held, lock, _ in cf.acquires:
                note(held | inner_held, lock,
                     f"{mf.name}->{callee}", line)
    return pairs


# ---------------------------------------------------------------------------
# rules (ids are what the tests and the allowlist hang off)
# ---------------------------------------------------------------------------
@rule("lint.unguarded_write",
      "write to a lock-guarded attribute without holding its guard")
def _r_unguarded_write(r, findings):
    return [r.violation(**f) for f in findings]


@rule("lint.unguarded_read",
      "read of a lock-guarded attribute without holding its guard",
      severity=Severity.WARNING)
def _r_unguarded_read(r, findings):
    return [r.violation(**f) for f in findings]


@rule("lint.lock_order",
      "two locks acquired in opposite orders on different paths")
def _r_lock_order(r, findings):
    return [r.violation(**f) for f in findings]


@rule("lint.callback_in_lock",
      "callback invoked while holding a lock",
      severity=Severity.WARNING)
def _r_callback_in_lock(r, findings):
    return [r.violation(**f) for f in findings]


@rule("lint.check_then_act",
      "unlocked check-then-act on a shared flag")
def _r_check_then_act(r, findings):
    return [r.violation(**f) for f in findings]


LINT_RULES = ("lint.unguarded_write", "lint.unguarded_read",
              "lint.lock_order", "lint.callback_in_lock",
              "lint.check_then_act")


def _lint_class(cls: _ClassFacts, relpath: str,
                allowlist: Allowlist) -> CheckReport:
    report = CheckReport(f"lint:{relpath}:{cls.name}")
    if not cls.locks:
        return report
    loc = lambda a: f"{relpath}:{a.lineno} ({cls.name}.{a.method})"
    accesses = _effective_accesses(cls)

    # learn which attributes the class itself treats as guarded
    guards: Dict[str, FrozenSet[str]] = {}
    for a in accesses:
        if a.kind != "write" or a.method in CONSTRUCTOR_METHODS:
            continue
        locked = frozenset(a.held & cls.locks)
        if not locked:
            continue
        prev = guards.get(a.attr)
        guards[a.attr] = locked if prev is None else (prev & locked
                                                      or prev | locked)

    uw, ur = [], []
    for a in accesses:
        if a.method in CONSTRUCTOR_METHODS or a.attr not in guards:
            continue
        guard = guards[a.attr]
        if a.held & guard:
            continue
        if allowlist.allows(cls.name, a.attr, a.kind):
            continue
        pretty = "/".join(sorted(guard))
        if a.kind == "write":
            uw.append(dict(
                message=f"self.{a.attr} is written under {pretty} "
                        f"elsewhere but written here with no lock held",
                location=loc(a),
                fix_hint=f"take {pretty} around this write (or allowlist "
                         f"{cls.name}.{a.attr} if it is deliberately "
                         "lock-free)"))
        else:
            ur.append(dict(
                message=f"self.{a.attr} is guarded by {pretty} but read "
                        "here with no lock held",
                location=loc(a),
                fix_hint=f"take {pretty}, or allowlist "
                         f"{cls.name}.{a.attr}:read for an intentionally "
                         "lock-free snapshot"))

    pairs = _lock_order_pairs(cls)
    lo = []
    for (a_, b_), sites in sorted(pairs.items()):
        if (b_, a_) in pairs and a_ < b_:
            here = ", ".join(f"{m}:{ln}" for m, ln in sites[:3])
            there = ", ".join(f"{m}:{ln}"
                              for m, ln in pairs[(b_, a_)][:3])
            lo.append(dict(
                message=f"lock order inversion: {a_} -> {b_} ({here}) "
                        f"but also {b_} -> {a_} ({there})",
                location=f"{relpath} ({cls.name})",
                fix_hint="pick one order and restructure the minority "
                         "path (release before re-acquiring)"))

    cb = []
    for mf in cls.methods.values():
        for name, held, line in mf.callbacks:
            if held & cls.locks and mf.name not in CONSTRUCTOR_METHODS:
                cb.append(dict(
                    message=f"callback {name}() invoked while holding "
                            f"{'/'.join(sorted(held & cls.locks))}: a "
                            "callback that re-enters this object "
                            "deadlocks",
                    location=f"{relpath}:{line} ({cls.name}.{mf.name})",
                    fix_hint="snapshot under the lock, invoke the "
                             "callback after releasing it"))

    cta = []
    for mf in cls.methods.values():
        if mf.name in CONSTRUCTOR_METHODS:
            continue
        for attr, line in mf.flag_races:
            if allowlist.allows(cls.name, attr, "write"):
                continue
            cta.append(dict(
                message=f"check-then-act on self.{attr} with no lock "
                        "held: two threads can both pass the check "
                        "before either writes",
                location=f"{relpath}:{line} ({cls.name}.{mf.name})",
                fix_hint="perform the check and the set under one lock"))

    report.extend(_r_unguarded_write(uw))
    report.extend(_r_unguarded_read(ur))
    report.extend(_r_lock_order(lo))
    report.extend(_r_callback_in_lock(cb))
    report.extend(_r_check_then_act(cta))
    return report


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def lint_file(path: str,
              allowlist: Optional[Allowlist] = None) -> CheckReport:
    """Concurrency-lint every class in one Python source file."""
    allowlist = DEFAULT_ALLOWLIST if allowlist is None else allowlist
    relpath = os.path.basename(path)
    report = CheckReport(f"concurrency-lint:{relpath}")
    report.rules_run += list(LINT_RULES)
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        report.extend([PlanRuleViolation(
            "lint.unguarded_write", Severity.ERROR,
            f"file does not parse: {e}", location=relpath)])
        return report
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            report.merge(_lint_class(_collect_class(node), relpath,
                                     allowlist))
    report.name = f"concurrency-lint:{relpath}"
    return report


def default_target_files() -> List[str]:
    """The port's threaded modules (the serve stack, obs, the fault
    primitives, the workload registry, the checkpointer and the data
    pipeline), located via the package itself (so the CLI works from any
    cwd)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return [os.path.join(root, *p.split("/")) for p in (
        "serve/engine.py", "serve/frontend.py", "serve/scheduler.py",
        "obs/metrics.py", "obs/trace.py", "dist/fault.py",
        "workloads/registry.py", "ckpt/checkpoint.py",
        "data/pipeline.py")]


def lint_files(paths: Optional[Sequence[str]] = None,
               allowlist: Optional[Allowlist] = None) -> CheckReport:
    """Lint ``paths`` (default: `default_target_files`)."""
    paths = default_target_files() if paths is None else list(paths)
    report = CheckReport("concurrency-lint")
    report.rules_run += list(LINT_RULES)
    for p in paths:
        report.merge(lint_file(p, allowlist))
    report.name = f"concurrency-lint[{len(paths)} file(s)]"
    return report
