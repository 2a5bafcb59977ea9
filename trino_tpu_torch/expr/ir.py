"""Typed row-expression IR (reference: sql/relational/RowExpression.java).

Produced by the analyzer/planner, consumed by the trace-time compiler and by
optimizer rules (constant folding, predicate pushdown, dynamic-filter
extraction).  Deliberately small: InputRef / Literal / Call / SpecialForm.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Sequence

from trino_tpu_torch.types import Type, BOOLEAN


#: render budget for expression __repr__: a shared DAG would otherwise
#: expand to an exponential-size string in EXPLAIN / plan rendering
_REPR_BUDGET = 2000


def _render(e: "Expr", budget: list) -> str:
    if budget[0] <= 0:
        return "\u2026"
    budget[0] -= 1
    return e._render(budget)


#: hash-consing table: flat structural key -> small int id.  Composite keys
#: reference children by interned id, so a key stays FLAT (O(node arity))
#: even when the expression is a deeply shared DAG — a naive recursive key
#: would expand the DAG into an exponential-size tree (concat_ws's threaded
#: accumulator, CASE chains).  Process-level, like the step caches that
#: consume these keys; dispatcher lanes plan on several threads, so an id
#: is assigned under a lock (two keys must never share one).
_KEY_IDS: dict = {}
_KEY_IDS_LOCK = threading.Lock()


class Expr:
    type: Type

    def children(self) -> Sequence["Expr"]:
        return ()

    def with_children(self, children: Sequence["Expr"]) -> "Expr":
        assert not children
        return self

    # structural equality for optimizer rules
    def _compute_key(self):
        raise NotImplementedError

    def key(self):
        """Flat structural key (cached; children appear as interned ids)."""
        k = getattr(self, "_key", None)
        if k is None:
            k = self._compute_key()
            self._key = k
        return k

    def key_id(self) -> int:
        """Interned id of this node's structural key."""
        i = getattr(self, "_key_id", None)
        if i is None:
            k = self.key()
            i = _KEY_IDS.get(k)
            if i is None:
                with _KEY_IDS_LOCK:
                    i = _KEY_IDS.setdefault(k, len(_KEY_IDS))
            self._key_id = i
        return i

    def __eq__(self, other):
        return isinstance(other, Expr) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def _render(self, budget: list) -> str:
        raise NotImplementedError

    def __repr__(self):
        return _render(self, [_REPR_BUDGET])


class InputRef(Expr):
    """Reference to an input channel of the operator's input batch."""

    __slots__ = ("channel", "type")

    def __init__(self, channel: int, type: Type):
        self.channel = channel
        self.type = type

    def _compute_key(self):
        return ("input", self.channel, self.type.name)

    def _render(self, budget):
        return f"#{self.channel}:{self.type.name}"


class SymbolRef(Expr):
    """Named symbol reference used in logical plans (reference:
    sql/planner/Symbol.java); rewritten to InputRef channels by the local
    execution planner."""

    __slots__ = ("name", "type")

    def __init__(self, name: str, type: Type):
        self.name = name
        self.type = type

    def _compute_key(self):
        return ("sym", self.name, self.type.name)

    def _render(self, budget):
        return f"${self.name}:{self.type.name}"


class Literal(Expr):
    """Constant. `value` is the *logical* host python value — Decimal/int/float
    for decimals (scaled at compile time), day numbers for dates, python str
    for strings (resolved against column dictionaries at trace time)."""

    __slots__ = ("value", "type")

    def __init__(self, value: Any, type: Type):
        self.value = value
        self.type = type

    @property
    def is_null(self) -> bool:
        return self.value is None

    def _compute_key(self):
        v = self.value
        if isinstance(v, (list, dict)):  # array/map literals: hashable form
            v = repr(v)
        return ("lit", v, self.type.name)

    def _render(self, budget):
        return f"{self.value!r}:{self.type.name}"


class LambdaParam(Expr):
    """A bound lambda parameter reference (reference:
    sql/relational/LambdaDefinitionExpression's argument slots).  The
    compiler resolves it from the active lambda environment."""

    __slots__ = ("name", "type")

    def __init__(self, name: str, type: Type):
        self.name = name
        self.type = type

    def _compute_key(self):
        return ("lparam", self.name, self.type.name)

    def _render(self, budget):
        return f"λ{self.name}:{self.type.name}"


class Lambda(Expr):
    """x -> body (reference: sql/tree/LambdaExpression ->
    LambdaDefinitionExpression)."""

    __slots__ = ("params", "body", "type")

    def __init__(self, params: Sequence[str], body: Expr, type: Type):
        self.params = tuple(params)
        self.body = body
        self.type = type  # the BODY's result type

    def children(self):
        return (self.body,)

    def with_children(self, children):
        return Lambda(self.params, children[0], self.type)

    def _compute_key(self):
        return ("lambda", self.params, self.body.key_id(), self.type.name)

    def _render(self, budget):
        return f"({', '.join(self.params)}) -> {_render(self.body, budget)}"


class Call(Expr):
    """Scalar function call, name-resolved (e.g. '$add', 'substr', 'year')."""

    __slots__ = ("name", "args", "type")

    def __init__(self, name: str, args: Sequence[Expr], type: Type):
        self.name = name
        self.args = tuple(args)
        self.type = type

    def children(self):
        return self.args

    def with_children(self, children):
        return Call(self.name, tuple(children), self.type)

    def _compute_key(self):
        return ("call", self.name, tuple(a.key_id() for a in self.args), self.type.name)

    def _render(self, budget):
        return f"{self.name}({', '.join(_render(a, budget) for a in self.args)})"


class Form(enum.Enum):
    AND = "and"
    OR = "or"
    NOT = "not"
    IF = "if"                  # if(cond, then, else)
    CASE = "case"              # searched case: [c1, v1, c2, v2, ..., default]
    COALESCE = "coalesce"
    IN = "in"                  # in(value, item1, item2, ...)
    BETWEEN = "between"        # between(v, lo, hi)
    IS_NULL = "is_null"
    CAST = "cast"
    TRY = "try"
    NULLIF = "nullif"
    ROW = "row"
    DEREFERENCE = "dereference"
    ARRAY = "array"            # array(e1, e2, ...) constructor
    SUBSCRIPT = "subscript"    # subscript(array, index) — 1-based


class SpecialForm(Expr):
    __slots__ = ("form", "args", "type")

    def __init__(self, form: Form, args: Sequence[Expr], type: Type = BOOLEAN):
        self.form = form
        self.args = tuple(args)
        self.type = type

    def children(self):
        return self.args

    def with_children(self, children):
        return SpecialForm(self.form, tuple(children), self.type)

    def _compute_key(self):
        return ("form", self.form.value, tuple(a.key_id() for a in self.args), self.type.name)

    def _render(self, budget):
        return f"{self.form.value}({', '.join(_render(a, budget) for a in self.args)})"


# -- convenience constructors used throughout the planner --------------------


def substitute_symbols(expr: "Expr", mapping: dict) -> "Expr":
    """Replace SymbolRefs by name with mapped expressions (bottom-up).
    The mapping value is used as-is — callers wrap in CAST when the
    replacement's type differs from the symbol's."""

    def fn(x):
        if isinstance(x, SymbolRef) and x.name in mapping:
            return mapping[x.name]
        return x

    return visit(expr, fn)


def and_(*args: Expr) -> Expr:
    flat = []
    for a in args:
        if isinstance(a, SpecialForm) and a.form == Form.AND:
            flat.extend(a.args)
        elif isinstance(a, Literal) and a.value is True:
            continue
        else:
            flat.append(a)
    if not flat:
        return Literal(True, BOOLEAN)
    if len(flat) == 1:
        return flat[0]
    return SpecialForm(Form.AND, flat, BOOLEAN)


def or_(*args: Expr) -> Expr:
    if len(args) == 1:
        return args[0]
    return SpecialForm(Form.OR, list(args), BOOLEAN)


def not_(a: Expr) -> Expr:
    return SpecialForm(Form.NOT, [a], BOOLEAN)


def comparison(op: str, left: Expr, right: Expr) -> Expr:
    return Call({"=": "$eq", "<>": "$ne", "!=": "$ne", "<": "$lt",
                 "<=": "$le", ">": "$gt", ">=": "$ge"}[op], [left, right], BOOLEAN)


def visit(expr: Expr, fn, _memo: dict = None) -> Expr:
    """Bottom-up rewrite: fn applied to every node after its children.

    Memoized by node identity: planner rewrites produce DAGs where the same
    sub-Expr object is referenced many times (concat_ws's threaded
    accumulator, CASE chains); an unmemoized walk is exponential in the
    sharing depth AND un-shares the DAG for every downstream pass."""
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(expr))
    if hit is not None:
        return hit
    out = expr
    kids = expr.children()
    if kids:
        out = expr.with_children([visit(k, fn, _memo) for k in kids])
    out = fn(out)
    _memo[id(expr)] = out
    return out


def collect_input_channels(
    expr: Expr, acc: set | None = None, _seen: set | None = None
) -> set:
    if acc is None:
        acc = set()
    if _seen is None:
        _seen = set()
    if id(expr) in _seen:
        return acc
    _seen.add(id(expr))
    if isinstance(expr, InputRef):
        acc.add(expr.channel)
    for k in expr.children():
        collect_input_channels(k, acc, _seen)
    return acc
