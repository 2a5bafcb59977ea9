"""Static concurrency analyzer: guarded-state inference, thread discipline,
and static lock-order extraction (stdlib `ast` only).

Port of trino_tpu/verify/concurrency.py, run over `trino_tpu_torch/`.
The port runs torch from several threads since the dispatcher's engine
lanes (runtime/dispatcher.py); its locks guard the device gate, the step
cache, the kernels' launch counters, the metrics registry, key ids and
string tables.  Three passes:

  * **Guarded-state inference** (`unguarded-state`).  Per class, the
    analyzer learns which `self._x` attributes are lock-guarded — any
    attribute accessed at least once inside a `with self._lock:` block of
    that class — and flags every read or write of the same attribute
    outside any lock.  `__init__` is exempt (construction precedes
    publication), attribute *calls* (`self.clock()`) are treated as
    behavior, not state, and only attributes the class mutates after
    construction are flaggable (immutable config can't race).  Simple
    self-aliases (`worker = self`) are followed, including into nested
    functions and classes.
  * **Thread discipline** (`thread-discipline`).  Every
    `threading.Thread(...)` must pass `name=` AND an explicit `daemon=`,
    so every thread is attributable in a stack dump.
  * **Static lock-order extraction** (`lock-order-cycle`).  Nested
    `with <lock>:` statements contribute edges to a tree-wide
    acquisition-order graph over canonical lock names (`Class._lock`,
    `module:NAME`); a cycle is a potential deadlock, reported at every
    witness site.  The dynamic half (cross-function nesting, real thread
    interleavings) is `trino_tpu_torch.verify.lockgraph`.

Suppression: `# lint: allow(<rule>)` comments on the line or on the
enclosing def/class.  `unguarded-state` findings additionally triage
through the port's own baseline (`concurrency_baseline.json` beside this
file): every surviving finding needs a `file:Class.attr` entry whose value
is a one-line justification.  New findings outside the baseline fail.

    python -m trino_tpu_torch.verify.concurrency [--check-stale]

exits 0 when every finding over `trino_tpu_torch/` is fixed, allowed or
baselined.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

#: threading factory names whose result is a lock object
_LOCK_FACTORIES = frozenset({"Lock", "RLock"})

#: method calls that MUTATE their receiver (a `self._x.append(...)` is a
#: write to the guarded collection, not a read)
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "sort", "reverse",
})

#: the `# lint: allow(<rule>)` comment grammar of the JAX package's lint
_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")


@dataclass
class Finding:
    file: str
    line: int
    rule: str
    message: str
    #: baseline key for unguarded-state findings ("file:Class.attr")
    key: str = ""

    def __str__(self):
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Access:
    line: int
    cls: str
    method: str
    attr: str
    kind: str  # "read" | "write"
    guarded: bool
    locks_held: tuple = ()


@dataclass
class ClassReport:
    """Per-class lock/state summary the inference runs over."""

    name: str
    file: str
    line: int
    locks: set = field(default_factory=set)
    accesses: list = field(default_factory=list)

    def guarded_attrs(self) -> set:
        """Attributes accessed at least once under one of this class's own
        locks — the inferred lock-guarded state."""
        return {a.attr for a in self.accesses if a.guarded}

    def mutated_attrs(self) -> set:
        """Attributes written outside __init__ somewhere in the class —
        only these can race (construction-frozen config cannot)."""
        return {
            a.attr
            for a in self.accesses
            if a.kind == "write" and a.method != "__init__"
        }


def _allowances(source: str) -> dict:
    out: dict = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _is_lock_factory_call(node: ast.AST) -> bool:
    """Does this expression (sub)tree construct a threading lock?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            fn = n.func
            if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_FACTORIES:
                return True
            if isinstance(fn, ast.Name) and fn.id in _LOCK_FACTORIES:
                return True
    return False


class _ClassAnalyzer(ast.NodeVisitor):
    """Walk one ClassDef recording self-attribute accesses and the lexical
    with-lock nesting around them.  `self` aliases assigned inside methods
    (`worker = self`) are tracked class-wide: nested handler classes and
    waiter closures access state through them from OTHER threads, which is
    exactly the surface this analysis exists for."""

    def __init__(self, cls: ast.ClassDef, path: str):
        self.report = ClassReport(cls.name, path, cls.lineno)
        self._cls = cls
        #: names that refer to the instance ("self" + aliases)
        self._selves = {"self"}
        #: current method name (top-level def within the class)
        self._method = "?"
        #: stack of lock attr names currently held (lexical with-blocks)
        self._held: list = []
        #: attrs assigned a lock object (first pass)
        self._find_locks()

    # -- pass 1: which attributes hold locks ----------------------------------

    def _find_locks(self) -> None:
        for node in ast.walk(self._cls):
            if isinstance(node, ast.Assign) and _is_lock_factory_call(
                node.value
            ):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        self.report.locks.add(t.attr)
            # adopted locks (`self._engine_lock = lock`): the name says lock
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and t.attr.lower().endswith("lock")
                    ):
                        self.report.locks.add(t.attr)

    # -- pass 2: accesses ------------------------------------------------------

    def run(self) -> ClassReport:
        for stmt in self._cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._method = stmt.name
                self.generic_visit(stmt)
        return self.report

    def _is_self(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self._selves

    def _self_attr(self, node: ast.AST):
        if isinstance(node, ast.Attribute) and self._is_self(node.value):
            return node.attr
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        # alias tracking: `worker = self`
        if self._is_self(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self._selves.add(t.id)
        for t in node.targets:
            self._mark_target(t)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mark_target(node.target, aug=True)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._mark_target(node.target)
        if node.value is not None:
            self.visit(node.value)

    def _mark_target(self, t: ast.AST, aug: bool = False) -> None:
        attr = self._self_attr(t)
        if attr is not None:
            self._record(t.lineno, attr, "write")
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._mark_target(e)
            return
        if isinstance(t, (ast.Subscript, ast.Attribute)) and not isinstance(
            t, ast.Name
        ):
            # self._tasks[k] = v / self._x.y = v: mutation THROUGH the attr
            attr = self._self_attr(t.value)
            if attr is not None:
                self._record(t.value.lineno, attr, "write")
            else:
                self.visit(t.value)
            if isinstance(t, ast.Subscript):
                self.visit(t.slice)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            base = (
                t.value if isinstance(t, (ast.Subscript, ast.Attribute)) else t
            )
            attr = self._self_attr(base)
            if attr is not None:
                self._record(base.lineno, attr, "write")
            else:
                self.visit(t)

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            expr = item.context_expr
            # `with self._lock:` (Call form `with self._lock.acquire():`
            # never appears; Lock context managers are bare attributes)
            attr = self._self_attr(expr)
            if attr is not None and attr in self.report.locks:
                acquired.append(attr)
            else:
                self.visit(expr)
        self._held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    def visit_Call(self, node: ast.Call) -> None:
        # `self.clock()` — calling an attribute is behavior, not state: the
        # callable itself is construction-frozen config in this codebase
        attr = self._self_attr(node.func)
        if attr is None:
            # `self._x.append(v)` mutates the guarded collection
            fn = node.func
            if isinstance(fn, ast.Attribute):
                base_attr = self._self_attr(fn.value)
                if base_attr is not None:
                    kind = "write" if fn.attr in _MUTATORS else "read"
                    self._record(fn.value.lineno, base_attr, kind)
                    for a in node.args:
                        self.visit(a)
                    for k in node.keywords:
                        self.visit(k.value)
                    return
            self.visit(node.func)
        for a in node.args:
            self.visit(a)
        for k in node.keywords:
            self.visit(k.value)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None:
            self._record(node.lineno, attr, "read")
            return
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs (waiter closures) run on other threads with the SAME
        # lexical held-set view: a `with self._lock:` wrapping a def does
        # not guard the def's eventual execution, so reset the held stack
        saved, self._held = self._held, []
        self.generic_visit(node)
        self._held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        # nested class (the HTTP Handler idiom): its methods access state
        # via a self-alias; held locks never span into them
        saved, self._held = self._held, []
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                method, self._method = self._method, f"{node.name}.{stmt.name}"
                self.generic_visit(stmt)
                self._method = method
        self._held = saved

    def _record(self, line: int, attr: str, kind: str) -> None:
        if attr in self.report.locks or attr.startswith("__"):
            return
        self.report.accesses.append(
            Access(
                line,
                self.report.name,
                self._method,
                attr,
                kind,
                guarded=bool(self._held),
                locks_held=tuple(self._held),
            )
        )


# -- module-level lock discovery (for the static lock-order graph) ------------


def _module_locks(tree: ast.Module) -> set:
    out = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and _is_lock_factory_call(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


class _OrderExtractor(ast.NodeVisitor):
    """Collect (outer lock, inner lock) edges from nested with-statements.
    Lock names are canonical: `Class.attr` for instance locks (the class
    the with appears in), `module:NAME` for module-level locks."""

    def __init__(self, path: str, class_locks: dict, module_locks: set,
                 modname: str):
        self.path = path
        self.class_locks = class_locks  # class name -> lock attr set
        self.module_locks = module_locks
        self.modname = modname
        self.edges: list = []  # (outer, inner, line)
        self._cls: list = []
        self._held: list = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._cls.append(node.name)
        self.generic_visit(node)
        self._cls.pop()

    def _lock_name(self, expr: ast.AST):
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            for cls in reversed(self._cls):
                if expr.attr in self.class_locks.get(cls, ()):
                    return f"{cls}.{expr.attr}"
            # self._lock in a class we did not map (alias receiver): accept
            # when the attr is lock-named and we are inside a class
            if self._cls and expr.attr.lower().endswith("lock"):
                return f"{self._cls[-1]}.{expr.attr}"
            return None
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"{self.modname}:{expr.id}"
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            name = self._lock_name(item.context_expr)
            if name is not None:
                for outer in self._held:
                    if outer != name:
                        self.edges.append((outer, name, item.context_expr.lineno))
                acquired.append(name)
        self._held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self._held.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def's body executes later, outside the lexical with
        saved, self._held = self._held, []
        self.generic_visit(node)
        self._held = saved

    visit_AsyncFunctionDef = visit_FunctionDef


def find_cycles(edges) -> list:
    """Cycles in a directed graph given as (a, b[, witness]) edges; returns
    a list of node-name lists, each a closed walk a -> ... -> a."""
    adj: dict = {}
    for e in edges:
        a, b = e[0], e[1]
        adj.setdefault(a, set()).add(b)
    cycles = []
    seen_cycles = set()
    # DFS with a recursion stack; report each back-edge cycle once
    state: dict = {}  # 0 unvisited / 1 on stack / 2 done

    def dfs(u, stack):
        state[u] = 1
        stack.append(u)
        for v in adj.get(u, ()):
            if state.get(v, 0) == 0:
                dfs(v, stack)
            elif state.get(v) == 1:
                cyc = stack[stack.index(v):] + [v]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
        stack.pop()
        state[u] = 2

    for n in list(adj):
        if state.get(n, 0) == 0:
            dfs(n, [])
    return cycles


# -- file / tree analysis ------------------------------------------------------


def analyze_source(path: str, source: str):
    """-> (class reports, thread findings, lock-order edges).  Pure AST; the
    caller applies suppressions and the baseline."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [], [Finding(path, e.lineno or 0, "syntax-error", str(e))], []
    reports = []
    class_locks: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            rep = _ClassAnalyzer(node, path).run()
            if rep.locks:
                reports.append(rep)
            class_locks[rep.name] = rep.locks
    thread_findings = _thread_discipline(path, tree)
    modname = os.path.basename(path).rsplit(".", 1)[0]
    extractor = _OrderExtractor(
        path, class_locks, _module_locks(tree), modname
    )
    extractor.visit(tree)
    return reports, thread_findings, extractor.edges


def _thread_discipline(path: str, tree: ast.Module) -> list:
    """`threading.Thread(...)` without name= or an explicit daemon=."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        is_thread = (
            isinstance(fn, ast.Attribute)
            and fn.attr == "Thread"
            and isinstance(fn.value, ast.Name)
            and fn.value.id == "threading"
        ) or (isinstance(fn, ast.Name) and fn.id == "Thread")
        if not is_thread:
            continue
        kw = {k.arg for k in node.keywords}
        missing = [k for k in ("name", "daemon") if k not in kw]
        if missing:
            out.append(
                Finding(
                    path, node.lineno, "thread-discipline",
                    "threading.Thread without explicit "
                    f"{' and '.join(missing)}= — an unnamed or "
                    "implicit-daemon thread is hard to attribute in a "
                    "stack dump",
                )
            )
    return out


def unguarded_findings(reports) -> list:
    """Apply the inference over class reports: accesses of lock-guarded
    attributes outside any lock, excluding __init__ and attributes never
    mutated after construction."""
    out = []
    for rep in reports:
        guarded = rep.guarded_attrs() & rep.mutated_attrs()
        if not guarded:
            continue
        for a in rep.accesses:
            if a.guarded or a.attr not in guarded:
                continue
            if a.method == "__init__":
                continue
            out.append(
                Finding(
                    rep.file, a.line, "unguarded-state",
                    f"{a.kind} of {rep.name}.{a.attr} outside any lock, but "
                    "the same attribute is accessed under a with-lock "
                    "elsewhere in the class — take the lock, or record a "
                    "justified baseline entry / # lint: allow(unguarded-state)",
                    key=f"{rep.file}:{rep.name}.{a.attr}",
                )
            )
    return out


def analyze_paths(paths, root: str = "."):
    """Analyze every .py under `paths` (relative to root).  Returns
    (findings, lock-order edges); findings cover unguarded-state and
    thread-discipline with `# lint: allow(...)` already applied, plus any
    lock-order-cycle findings over the whole path set."""
    findings: list = []
    all_edges: list = []  # (outer, inner, "file:line")
    files = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full):
            files.append(full)
            continue
        for dirpath, _, names in os.walk(full):
            files.extend(
                os.path.join(dirpath, n) for n in names if n.endswith(".py")
            )
    for f in sorted(files):
        with open(f, "r", encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        reports, threads, edges = analyze_source(rel, source)
        allow = _allowances(source)
        scopes = _scope_index(source)
        raw = unguarded_findings(reports) + threads
        for fd in raw:
            if not _suppressed(fd, allow, scopes):
                findings.append(fd)
        all_edges.extend((a, b, f"{rel}:{ln}") for a, b, ln in edges)
    for cyc in find_cycles(all_edges):
        pairs = set(zip(cyc, cyc[1:]))
        witnesses = sorted(
            w for a, b, w in all_edges if (a, b) in pairs
        )
        findings.append(
            Finding(
                witnesses[0].rsplit(":", 1)[0] if witnesses else "<repo>",
                int(witnesses[0].rsplit(":", 1)[1]) if witnesses else 0,
                "lock-order-cycle",
                "inconsistent lock acquisition order "
                + " -> ".join(cyc)
                + f" (witness sites: {', '.join(witnesses)})",
            )
        )
    return findings, all_edges


def _scope_index(source: str):
    """[(start, end)] line ranges of defs/classes, for def-level allows."""
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    out = []
    for node in ast.walk(tree):
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            out.append((node.lineno, node.end_lineno or node.lineno))
    return out


def _suppressed(fd: Finding, allow: dict, scopes) -> bool:
    lines = [fd.line] + [s for s, e in scopes if s <= fd.line <= e]
    for at in lines:
        rules = allow.get(at)
        if rules and (fd.rule in rules or "*" in rules):
            return True
    return False


# -- baseline ------------------------------------------------------------------


def apply_baseline(findings, baseline: dict):
    """Split unguarded-state findings by the baseline map
    ({"file:Class.attr": justification}).  Returns (new findings that FAIL
    the lint, stale baseline keys with no live finding — the ratchet
    reminder)."""
    keys = {fd.key for fd in findings if fd.rule == "unguarded-state"}
    new = [
        fd
        for fd in findings
        if fd.rule != "unguarded-state" or fd.key not in baseline
    ]
    stale = sorted(k for k in baseline if k not in keys)
    return new, stale


# -- the port's entry point ------------------------------------------------------

#: the tree the pass walks, relative to the repository root
PATHS = ("trino_tpu_torch",)

#: justified unguarded-state findings: {"file:Class.attr": reason}
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "concurrency_baseline.json")


def load_baseline(path: str = BASELINE_PATH) -> dict:
    """The port's baseline map ({} when the file is absent)."""
    import json

    try:
        with open(path, "r", encoding="utf-8") as fh:
            return dict(json.load(fh).get("unguarded_state") or {})
    except OSError:
        return {}


def repo_root() -> str:
    """The directory holding the `trino_tpu_torch` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(root: str = None, baseline: dict = None):
    """The three passes over `trino_tpu_torch/`, triaged through the
    baseline.  Returns (failing findings, stale baseline keys, edges)."""
    root = root or repo_root()
    findings, edges = analyze_paths(PATHS, root=root)
    if baseline is None:
        baseline = load_baseline()
    new, stale = apply_baseline(findings, baseline)
    return new, stale, edges


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="guarded-state, thread-discipline and static lock-order "
        "passes over trino_tpu_torch/"
    )
    ap.add_argument("--root", default=None, help="repository root")
    ap.add_argument(
        "--check-stale", action="store_true",
        help="fail when a baseline entry no longer matches a finding",
    )
    args = ap.parse_args(argv)
    baseline = load_baseline()
    new, stale, edges = run(args.root, baseline)
    for fd in sorted(new, key=lambda f: (f.file, f.line, f.rule)):
        print(fd)
        if fd.key:
            print(f"  baseline key: {fd.key!r}")
    word = "STALE" if args.check_stale else "note"
    for k in stale:
        print(f"{word}: baseline entry {k!r} has no live finding")
    pairs = sorted({(a, b) for a, b, _ in edges})
    print(
        f"concurrency: {len(new)} finding(s), {len(baseline)} baselined, "
        f"{len(stale)} stale, {len(pairs)} static lock-order edge(s)"
    )
    if new:
        return 1
    return 1 if (args.check_stale and stale) else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
