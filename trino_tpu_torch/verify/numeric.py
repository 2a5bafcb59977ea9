"""Numeric-safety verifier: abstract interpretation over the expression IR.

The device compiles every scalar expression to fixed-width integer/float
kernels (expr/compiler.py + expr/functions.py): short decimals are scaled
int64, integers keep their declared width, long decimals are two int64 limb
planes.  None of those kernels trap — int overflow wraps two's-complement,
a mis-scaled decimal branch silently reinterprets units, a float detour
silently rounds an exact value, and a dropped validity plane resurrects
NULLs as zeros.  The reference engine throws at runtime; a vectorized XLA
program cannot, so the property must be PROVEN statically instead.

This pass propagates a lattice of (dtype, decimal precision/scale, value
interval, nullability) — `verify.ranges.Interval` in scaled units — through
every expression, mirroring the exact arithmetic the compiled kernels
perform (rescale-then-add, multiply-then-rescale, truncating division).
Facts come from literal values, declared type precisions, and connector
generator statistics (exact by construction); CBO estimates are never
admitted.  Each hazard becomes an `Issue` under one of the rules:

  rule                | flags
  --------------------+-----------------------------------------------------
  int-overflow        | integer arithmetic whose result interval exceeds the
                      | device dtype — silent two's-complement wrap
  decimal-overflow    | decimal arithmetic/rescale whose exact value can
                      | exceed its i64 (short) / i128 (limb) accumulator
  scale-mismatch      | branch-merge forms (IF/CASE/COALESCE/NULLIF) mixing
                      | decimal scales without a rescale — the compiler
                      | broadcasts raw scaled ints, so units silently differ
  float-contamination | an exact decimal value computed through a float
                      | representation (float argument to a decimal-typed
                      | op, or a float->decimal CAST) — exactness silently
                      | lost to f64 rounding
  dropped-validity    | a construct that collapses or discards a finer
                      | validity plane consuming a nullable argument (the
                      | rectangular ARRAY constructor's documented
                      | per-element collapse; extensible table)

Findings triage through the `numeric_safety` baseline map in
tools/lint_baseline.json — keyed by a stable (rule, operator-signature)
string, one reviewed justification per entry, same workflow as the
concurrency pass's `unguarded_state`.  The CI sweep
(`python -m trino_tpu_torch.verify.numeric`) walks every expression of every
TPC-H + TPC-DS plan and reports each as PROVEN-SAFE / BASELINED /
VIOLATION; any unbaselined VIOLATION fails.

The same interval machinery has a second job: **licensing**.
`sum_certificate()` turns an analyzed aggregation input into a
`verify.ranges.RangeCertificate` — per-row magnitude bound x total-row
bound — that the planner attaches to sum/avg specs; when the certificate
proves every partial sum fits int64, the aggregation and window kernels
compile single-plane i64 segment sums with NO runtime fits check and NO
limb-plane traffic (the generalization of `_sum128`'s static precision
proof; see ops/aggregation.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from trino_tpu_torch import types as T
from trino_tpu_torch.expr.ir import (
    Call,
    Expr,
    Form,
    InputRef,
    Lambda,
    LambdaParam,
    Literal,
    SpecialForm,
    SymbolRef,
)
from trino_tpu_torch.verify import ranges as R
from trino_tpu_torch.verify.capacity import FLIPPED_CMP, conjuncts
from trino_tpu_torch.verify.ranges import Interval, RangeCertificate

RULES = (
    "int-overflow",
    "decimal-overflow",
    "scale-mismatch",
    "float-contamination",
    "dropped-validity",
)

#: forms that merge branch values by raw broadcast (expr/compiler.py
#: _case_fold/_form_coalesce/_form_nullif): a decimal branch whose scale
#: differs from the output scale is silently reinterpreted
_BRANCH_FORMS = (Form.IF, Form.CASE, Form.COALESCE, Form.NULLIF)

#: constructs that collapse a finer validity plane (rule dropped-validity):
#: the rectangular ARRAY layout tracks validity per ROW, so a nullable
#: element's per-element NULL is unrepresentable and nulls the whole array
#: (documented deviation in expr/compiler.py _form_array)
_VALIDITY_COLLAPSING_FORMS = (Form.ARRAY,)

#: known value bounds of scalar functions the interval domain would
#: otherwise widen to the full result dtype (year(x) * 10000 must not read
#: as a bigint-range product); bounds are intentionally generous — they
#: only need to be TRUE, not tight
_FN_BOUNDS = {
    "year": Interval(-30000, 30000),
    "quarter": Interval(1, 4),
    "month": Interval(1, 12),
    "week": Interval(1, 53),
    "day": Interval(1, 31),
    "day_of_month": Interval(1, 31),
    "day_of_week": Interval(1, 7),
    "day_of_year": Interval(1, 366),
    "hour": Interval(0, 23),
    "minute": Interval(0, 59),
    "second": Interval(0, 59),
    "length": Interval(0, 1 << 31),
    "cardinality": Interval(0, 1 << 31),
    "sign": Interval(-1, 1),
}


@dataclass(frozen=True)
class Fact:
    """Abstract value: declared type + scaled-unit interval + nullability.

    tracked: the interval derives entirely from admissible bound sources
    (literals, declared decimal/integer precision of stored columns,
    generator statistics).  Untracked facts keep honest (type-wide)
    intervals but do not RAISE overflow findings — an unknown function's
    full-dtype result interval is not evidence of a wrap hazard — and never
    license a fast-path certificate."""

    type: T.Type
    interval: Interval
    nullable: bool = True
    tracked: bool = True

    @staticmethod
    def untracked(t: T.Type, nullable: bool = True) -> "Fact":
        return Fact(t, R.type_interval(t), nullable, tracked=False)


@dataclass(frozen=True)
class Issue:
    rule: str
    signature: str  # stable baseline key payload (operator + operand types)
    message: str

    def key(self) -> str:
        return f"{self.rule}:{self.signature}"

    def __str__(self) -> str:
        return f"[{self.rule}] {self.signature}: {self.message}"


class Env:
    """Bound facts for the free references of an expression: symbol names
    (logical plans) and/or input channels (locally planned exprs)."""

    def __init__(self, symbols: dict = None, channels: dict = None):
        self.symbols = dict(symbols or {})
        self.channels = dict(channels or {})

    def sym(self, name: str) -> Optional[Fact]:
        return self.symbols.get(name)

    def ref(self, channel: int) -> Optional[Fact]:
        return self.channels.get(channel)

    @staticmethod
    def for_layout(symbols, sym_env: "Env") -> "Env":
        """Channel-keyed env for a physical layout (symbols[i] -> channel i)."""
        ch = {}
        for i, s in enumerate(symbols):
            f = sym_env.sym(s.name)
            if f is not None:
                ch[i] = f
        return Env(sym_env.symbols, ch)


class Analyzer:
    """One pass over one expression; collects Issues, returns Facts."""

    def __init__(self, env: Env = None):
        self.env = env or Env()
        self.issues: list = []
        self._memo: dict = {}

    # -- helpers --------------------------------------------------------------

    def _issue(self, rule: str, signature: str, message: str) -> None:
        self.issues.append(Issue(rule, signature, message))

    @staticmethod
    def _sig(op: str, *types: T.Type, out: T.Type = None) -> str:
        s = f"{op}({', '.join(t.name for t in types)})"
        if out is not None:
            s += f"->{out.name}"
        return s

    def _check_fits(
        self, rule: str, sig: str, iv: Interval, room: Interval,
        tracked: bool, what: str,
    ) -> None:
        """Flag when a TRACKED interval can escape its accumulator."""
        if tracked and not iv.within(room):
            self._issue(rule, sig, f"{what}: value interval {iv} can exceed "
                                   f"the device accumulator {room}")

    # -- entry ----------------------------------------------------------------

    def analyze(self, expr: Expr) -> Fact:
        hit = self._memo.get(id(expr))
        # id() memo is safe here: the analyzer lives for one pass and keeps
        # every visited Expr alive through the memo itself
        if hit is not None:
            return hit
        fact = self._analyze(expr)
        self._memo[id(expr)] = fact
        return fact

    def _analyze(self, e: Expr) -> Fact:
        if isinstance(e, Literal):
            return self._literal(e)
        if isinstance(e, InputRef):
            f = self.env.ref(e.channel)
            return f if f is not None else self._column_fact(e.type)
        if isinstance(e, SymbolRef):
            f = self.env.sym(e.name)
            return f if f is not None else self._column_fact(e.type)
        if isinstance(e, LambdaParam):
            return Fact.untracked(e.type)
        if isinstance(e, Lambda):
            return self.analyze(e.body)
        if isinstance(e, Call):
            return self._call(e)
        if isinstance(e, SpecialForm):
            return self._form(e)
        return Fact.untracked(getattr(e, "type", T.UNKNOWN))

    def _column_fact(self, t: T.Type) -> Fact:
        """A stored column with no statistics: its DECLARED precision is
        still a real bound for exact types (a decimal(12,2) column holds
        |v| < 10**12 by the type contract), so the fact stays tracked."""
        if R.is_exact_type(t) and not isinstance(
            t, (T.ArrayType, T.MapType, T.RowType)
        ):
            return Fact(t, R.type_interval(t), nullable=True, tracked=True)
        return Fact.untracked(t)

    def _literal(self, lit: Literal) -> Fact:
        t = lit.type
        if lit.value is None:
            return Fact(t, Interval.point(0), nullable=True)
        if isinstance(t, T.DecimalType):
            from decimal import Decimal

            scaled = int(
                (Decimal(str(lit.value)) * t.scale_factor).to_integral_value()
            )
            return Fact(t, Interval.point(scaled), nullable=False)
        if isinstance(lit.value, bool):
            return Fact(t, Interval.point(int(lit.value)), nullable=False)
        if isinstance(lit.value, int) and R.is_exact_type(t):
            return Fact(t, Interval.point(lit.value), nullable=False)
        return Fact(t, R.type_interval(t), nullable=False,
                    tracked=R.is_exact_type(t))

    # -- calls ----------------------------------------------------------------

    def _call(self, call: Call) -> Fact:
        args = [self.analyze(a) for a in call.args]
        nullable = any(a.nullable for a in args)  # null-in/null-out default
        name = call.name
        rt = call.type
        if name in ("$add", "$sub"):
            return self._add_sub(call, args, nullable)
        if name == "$mul":
            return self._mul(call, args, nullable)
        if name == "$div":
            return self._div(call, args, nullable)
        if name == "$neg":
            a = args[0]
            iv = a.interval.neg()
            sig = self._sig(name, a.type, out=rt)
            self._check_fits(
                self._overflow_rule(rt), sig, iv, R.dtype_interval(rt),
                a.tracked, "negation",
            )
            return Fact(rt, iv, nullable, a.tracked)
        if name in ("$eq", "$ne", "$lt", "$le", "$gt", "$ge"):
            # comparisons rescale via _align_numeric: the REScale can wrap
            # short decimals before comparing
            self._check_align(name, args)
            return Fact(T.BOOLEAN, Interval(0, 1), nullable)
        if name == "abs":
            a = args[0]
            m = a.interval.max_abs()
            iv = Interval(0, m) if m is not None else R.type_interval(rt)
            return Fact(rt, iv, nullable, a.tracked)
        self._check_float_contamination(self._sig(name, *[a.type for a in args], out=rt), rt, args)
        b = _FN_BOUNDS.get(name)
        if b is not None:
            return Fact(rt, b, nullable, tracked=True)
        if name in ("$mod",):
            m = args[1].interval.max_abs()
            if m is not None:
                return Fact(rt, Interval(-m, m), nullable, args[1].tracked)
        # unknown scalar function: honest type-wide interval, untracked
        return Fact.untracked(rt, nullable)

    def _overflow_rule(self, t: T.Type) -> str:
        return "decimal-overflow" if isinstance(t, T.DecimalType) else "int-overflow"

    def _check_float_contamination(self, sig: str, rt: T.Type, args) -> None:
        if isinstance(rt, T.DecimalType) and any(
            a.type.name in ("real", "double") for a in args
        ):
            self._issue(
                "float-contamination", sig,
                "exact decimal result computed from a float argument — the "
                "value detours through f64 and silently loses exactness",
            )

    def _check_align(self, op: str, args) -> None:
        """_align_numeric rescales short decimals to the max operand scale
        in i64: the rescaled operand can wrap before the op even runs."""
        da = [a for a in args if isinstance(a.type, T.DecimalType)]
        if len(da) < 2 or any(a.type.is_long for a in da):
            return
        s = max(a.type.scale for a in da)
        for a in da:
            iv = a.interval.scale_pow10(s - a.type.scale)
            self._check_fits(
                "decimal-overflow",
                self._sig(op, *[x.type for x in args]),
                iv, R.I64_INTERVAL, a.tracked,
                f"operand rescale to scale {s}",
            )

    def _add_sub(self, call: Call, args, nullable: bool) -> Fact:
        a, b = args
        rt = call.type
        tracked = a.tracked and b.tracked
        sig = self._sig(call.name, a.type, b.type, out=rt)
        self._check_float_contamination(sig, rt, args)
        if not R.is_exact_type(rt):
            return Fact.untracked(rt, nullable)
        da = isinstance(a.type, T.DecimalType)
        db = isinstance(b.type, T.DecimalType)
        if da or db:
            long_path = (
                (da and a.type.is_long) or (db and b.type.is_long)
                or (isinstance(rt, T.DecimalType) and rt.is_long)
            )
            out_scale = rt.scale if isinstance(rt, T.DecimalType) else 0
            sa = a.type.scale if da else 0
            sb = b.type.scale if db else 0
            if long_path:
                # exact two-limb add at the OUTPUT scale (functions._arith)
                ia = a.interval.scale_pow10(out_scale - sa)
                ib = b.interval.scale_pow10(out_scale - sb)
                iv = ia.add(ib) if call.name == "$add" else ia.sub(ib)
                room = R.dtype_interval(rt)
                self._check_fits(
                    "decimal-overflow", sig, iv, room, tracked, "limb add"
                )
                return Fact(rt, iv, nullable, tracked)
            # short path: rescale both to max scale in i64, add, rescale out
            s = max(sa, sb)
            ia = a.interval.scale_pow10(s - sa)
            ib = b.interval.scale_pow10(s - sb)
            for side, iv_side in (("left", ia), ("right", ib)):
                self._check_fits(
                    "decimal-overflow", sig, iv_side, R.I64_INTERVAL,
                    tracked, f"{side} operand rescale to scale {s}",
                )
            iv = ia.add(ib) if call.name == "$add" else ia.sub(ib)
            self._check_fits(
                "decimal-overflow", sig, iv, R.I64_INTERVAL, tracked,
                "short-decimal accumulate",
            )
            iv = iv.scale_pow10(out_scale - s)
            return Fact(rt, iv, nullable, tracked)
        # integer kinds: the kernel computes in the promoted operand dtype,
        # which equals the result dtype for the planner's typed IR
        iv = a.interval.add(b.interval) if call.name == "$add" else a.interval.sub(b.interval)
        self._check_fits(
            "int-overflow", sig, iv, R.dtype_interval(rt), tracked,
            "integer add/sub",
        )
        return Fact(rt, iv, nullable, tracked)

    def _mul(self, call: Call, args, nullable: bool) -> Fact:
        a, b = args
        rt = call.type
        tracked = a.tracked and b.tracked
        sig = self._sig("$mul", a.type, b.type, out=rt)
        self._check_float_contamination(sig, rt, args)
        if not R.is_exact_type(rt):
            return Fact.untracked(rt, nullable)
        da = isinstance(a.type, T.DecimalType)
        db = isinstance(b.type, T.DecimalType)
        if da or db:
            sa = a.type.scale if da else 0
            sb = b.type.scale if db else 0
            out_scale = rt.scale if isinstance(rt, T.DecimalType) else sa + sb
            iv = a.interval.mul(b.interval)  # product at scale sa+sb
            long_path = (
                (da and a.type.is_long) or (db and b.type.is_long)
                or (isinstance(rt, T.DecimalType) and rt.is_long)
            )
            if long_path:
                # mul64x64 / mul128_by_i64vec are exact to 128 bits; the
                # post-rescale must still fit the planes
                iv = iv.scale_pow10(out_scale - (sa + sb))
                self._check_fits(
                    "decimal-overflow", sig, iv, R.I128_INTERVAL, tracked,
                    "limb product",
                )
                if isinstance(rt, T.DecimalType) and not rt.is_long:
                    self._check_fits(
                        "decimal-overflow", sig, iv, R.I64_INTERVAL, tracked,
                        "limb product narrowed to a short result",
                    )
                return Fact(rt, iv, nullable, tracked)
            # short x short with a short result: raw i64 product, then
            # rescale — BOTH can wrap
            self._check_fits(
                "decimal-overflow", sig, iv, R.I64_INTERVAL, tracked,
                "short-decimal product (computed in i64 before rescale)",
            )
            iv = iv.scale_pow10(out_scale - (sa + sb))
            self._check_fits(
                "decimal-overflow", sig, iv, R.I64_INTERVAL, tracked,
                "product rescale",
            )
            return Fact(rt, iv, nullable, tracked)
        iv = a.interval.mul(b.interval)
        self._check_fits(
            "int-overflow", sig, iv, R.dtype_interval(rt), tracked,
            "integer product",
        )
        return Fact(rt, iv, nullable, tracked)

    def _div(self, call: Call, args, nullable: bool) -> Fact:
        a, b = args
        rt = call.type
        tracked = a.tracked and b.tracked
        sig = self._sig("$div", a.type, b.type, out=rt)
        self._check_float_contamination(sig, rt, args)
        if not R.is_exact_type(rt):
            return Fact.untracked(rt, nullable)
        # div-by-zero nulls (TRY semantics): result is nullable regardless
        nullable = True
        if isinstance(rt, T.DecimalType) and not rt.is_long:
            sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
            sb = b.type.scale if isinstance(b.type, T.DecimalType) else 0
            shift = rt.scale - sa + sb
            num = a.interval.scale_pow10(shift) if shift > 0 else a.interval
            self._check_fits(
                "decimal-overflow", sig, num, R.I64_INTERVAL, tracked,
                f"numerator rescale by 10**{max(shift, 0)}",
            )
            iv = num.truncdiv(b.interval)
            # +1 unit covers the round-half-away bump
            iv = iv.add(Interval(-1, 1))
            return Fact(rt, iv, nullable, tracked)
        iv = a.interval.truncdiv(b.interval)
        return Fact(rt, iv, nullable, tracked)

    # -- special forms ---------------------------------------------------------

    def _form(self, f: SpecialForm) -> Fact:
        args = [self.analyze(a) for a in f.args]
        rt = f.type
        form = f.form
        if form in (Form.AND, Form.OR, Form.NOT, Form.IS_NULL, Form.IN,
                    Form.BETWEEN):
            if form in (Form.IN, Form.BETWEEN):
                self._check_align(form.value, args)
            nullable = form != Form.IS_NULL and any(a.nullable for a in args)
            return Fact(T.BOOLEAN, Interval(0, 1), nullable)
        if form == Form.CAST:
            return self._cast(f, args[0])
        if form == Form.TRY:
            a = args[0]
            return Fact(a.type, a.interval, True, a.tracked)
        if form in _BRANCH_FORMS:
            return self._branches(f, args)
        if form in _VALIDITY_COLLAPSING_FORMS:
            elems = [a for a in args if a.nullable]
            if elems:
                self._issue(
                    "dropped-validity",
                    self._sig(form.value, *[a.type for a in args], out=rt),
                    "the rectangular array layout tracks validity per ROW: "
                    "a nullable element's per-element NULL collapses into "
                    "nulling the whole value — wrap elements in COALESCE or "
                    "prove them non-null",
                )
            return Fact.untracked(rt)
        if form == Form.SUBSCRIPT:
            base = args[0]
            et = rt
            iv = R.type_interval(et)
            return Fact(et, iv, True, tracked=False)
        # ROW / DEREFERENCE / unmodeled forms
        return Fact.untracked(rt, any(a.nullable for a in args))

    def _cast(self, f: SpecialForm, a: Fact) -> Fact:
        rt = f.type
        sig = self._sig("cast", a.type, out=rt)
        nullable = a.nullable
        if isinstance(rt, T.DecimalType) and a.type.name in ("real", "double"):
            self._issue(
                "float-contamination", sig,
                "float -> decimal cast: the exact-decimal path downstream "
                "inherits f64 rounding error",
            )
            return Fact(rt, R.type_interval(rt), nullable, tracked=False)
        if isinstance(rt, T.DecimalType) and R.is_exact_type(a.type):
            sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
            iv = a.interval.scale_pow10(rt.scale - sa)
            room = R.dtype_interval(rt)
            self._check_fits(
                "decimal-overflow", sig, iv, room, a.tracked,
                "decimal rescale on cast",
            )
            return Fact(rt, iv, nullable, a.tracked)
        if T.is_integer_kind(rt) and R.is_exact_type(a.type):
            sa = a.type.scale if isinstance(a.type, T.DecimalType) else 0
            iv = a.interval.scale_pow10(-sa)
            # compile_cast nulls out-of-range values (no silent wrap), so
            # the fact narrows to the dtype range and turns nullable when
            # clipping is possible
            room = R.dtype_interval(rt)
            if not iv.within(room):
                nullable = True
            iv = Interval(
                room.lo if iv.lo is None else max(iv.lo, room.lo),
                room.hi if iv.hi is None else min(iv.hi, room.hi),
            )
            return Fact(rt, iv, nullable, a.tracked)
        if R.is_exact_type(rt):
            return Fact(rt, R.type_interval(rt), nullable, tracked=False)
        return Fact.untracked(rt, nullable)

    def _branches(self, f: SpecialForm, args) -> Fact:
        rt = f.type
        form = f.form
        # branch VALUE positions per compiler._case_fold/_form_coalesce —
        # keep the index shapes aligned with _branch_exprs below, whose zip
        # pairs facts with their Expr nodes
        implicit_null = False
        if form == Form.IF:
            vals = args[1:]
            implicit_null = len(args) < 3
        elif form == Form.CASE:
            if len(args) % 2 == 1:
                vals = [args[i] for i in range(1, len(args) - 1, 2)]
                vals.append(args[-1])
            else:
                # pairs only: the compiler supplies an implicit NULL
                # default, so the result is nullable whenever some row
                # matches no branch
                vals = [args[i] for i in range(1, len(args), 2)]
                implicit_null = True
        elif form == Form.NULLIF:
            vals = args[:1]
        else:  # COALESCE
            vals = args
        if isinstance(rt, T.DecimalType) and not rt.is_long:
            for v, e in zip(vals, _branch_exprs(f)):
                if (
                    isinstance(v.type, T.DecimalType)
                    and v.type.scale != rt.scale
                    and not (isinstance(e, Literal) and e.value is None)
                ):
                    self._issue(
                        "scale-mismatch",
                        self._sig(form.value, v.type, out=rt),
                        f"branch value at scale {v.type.scale} merged into "
                        f"a scale-{rt.scale} result by raw broadcast — the "
                        "compiler does not rescale branch data; insert an "
                        "explicit CAST",
                    )
        iv = None
        tracked = True
        for v in vals:
            vi = v.interval
            if isinstance(v.type, T.DecimalType) and isinstance(rt, T.DecimalType):
                vi = vi.scale_pow10(rt.scale - v.type.scale)
            iv = vi if iv is None else iv.union(vi)
            tracked = tracked and v.tracked
        nullable = (
            any(a.nullable for a in args)
            or form in (Form.NULLIF,)
            or implicit_null
        )
        if form == Form.COALESCE and vals and not vals[-1].nullable:
            nullable = False
        return Fact(
            rt, iv if iv is not None else R.type_interval(rt), nullable,
            tracked and R.is_exact_type(rt),
        )


def _branch_exprs(f: SpecialForm):
    """The Expr nodes in branch-VALUE positions, aligned with _branches."""
    args = list(f.args)
    if f.form == Form.IF:
        return args[1:]
    if f.form == Form.CASE:
        if len(args) % 2 == 1:
            return [args[i] for i in range(1, len(args) - 1, 2)] + [args[-1]]
        return [args[i] for i in range(1, len(args), 2)]
    if f.form == Form.NULLIF:
        return args[:1]
    return args


def analyze_expr(expr: Expr, env: Env = None):
    """-> (Fact, [Issue]) for one expression."""
    a = Analyzer(env)
    fact = a.analyze(expr)
    return fact, a.issues


# -- plan-level bound propagation ----------------------------------------------


#: connector catalogs whose table_statistics are EXACT generator parameters
#: (admissible as proof sources); anything else contributes only declared
#: type precisions
_EXACT_STATS_CATALOGS = ("tpch", "tpcds")


# -- predicate refinement: range certificates for filter outputs ---------------


def _lit_scaled_point(lit, sym_type) -> Optional[int]:
    """A literal's exact value in the compared symbol's scaled units, or
    None when the conversion is not provably exact (float literals,
    downscales that would round)."""
    if not isinstance(lit, Literal) or lit.value is None:
        return None
    if not R.is_exact_type(sym_type) or not R.is_exact_type(lit.type):
        return None
    f = Analyzer()._literal(lit)
    if f.interval.lo is None or f.interval.lo != f.interval.hi:
        return None
    v = f.interval.lo
    ls = lit.type.scale if isinstance(lit.type, T.DecimalType) else 0
    ss = sym_type.scale if isinstance(sym_type, T.DecimalType) else 0
    k = ss - ls
    if k >= 0:
        return v * 10 ** k
    d = 10 ** (-k)
    if v % d:
        return None  # would round: not an exact representation
    return v // d


def _conjunct_refinements(c):
    """(symbol name, admitted Interval) facts one conjunct proves about
    surviving rows.  Comparisons are NULL-rejecting, so refined symbols
    are also proven non-null — the caller applies that too."""
    out = []

    def sym_and_lit(a, b):
        if isinstance(a, SymbolRef) and isinstance(b, Literal):
            return a, b, False
        if isinstance(b, SymbolRef) and isinstance(a, Literal):
            return b, a, True
        return None, None, False

    if isinstance(c, Call) and c.name in (
        "$eq", "$lt", "$le", "$gt", "$ge"
    ) and len(c.args) == 2:
        s, lit, flipped = sym_and_lit(*c.args)
        if s is None:
            return out
        v = _lit_scaled_point(lit, s.type)
        if v is None:
            return out
        op = c.name
        if flipped:
            op = FLIPPED_CMP[op]
        if op == "$eq":
            out.append((s.name, Interval.point(v)))
        elif op == "$lt":
            out.append((s.name, Interval(None, v - 1)))
        elif op == "$le":
            out.append((s.name, Interval(None, v)))
        elif op == "$gt":
            out.append((s.name, Interval(v + 1, None)))
        else:  # $ge
            out.append((s.name, Interval(v, None)))
    elif isinstance(c, SpecialForm) and c.form == Form.BETWEEN and len(c.args) == 3:
        s = c.args[0]
        if isinstance(s, SymbolRef):
            lo = _lit_scaled_point(c.args[1], s.type)
            hi = _lit_scaled_point(c.args[2], s.type)
            if lo is not None and hi is not None:
                out.append((s.name, Interval(lo, hi)))
    elif isinstance(c, SpecialForm) and c.form == Form.IN and len(c.args) >= 2:
        s = c.args[0]
        if isinstance(s, SymbolRef):
            vals = [_lit_scaled_point(x, s.type) for x in c.args[1:]]
            if all(v is not None for v in vals):
                out.append((s.name, Interval(min(vals), max(vals))))
    return out


def refine_env(env: Env, predicate) -> Env:
    """Filter-output fact refinement: rows surviving `predicate` provably
    satisfy its literal-comparison conjuncts, so each compared symbol's
    interval meets the admitted range and turns non-null (comparisons
    reject NULL).  Only exact facts are admitted — the same sources as
    the licensing passes — so downstream range certificates built on a
    refined env stay sound.  This is how the aggregation-input
    certificates extend to FILTER (and, through plan_env, join) outputs:
    a provably-narrow filtered column licenses narrower kernels."""
    refits: dict = {}
    for c in conjuncts(predicate):
        for name, iv in _conjunct_refinements(c):
            f = env.sym(name)
            if f is None or not f.tracked or not R.is_exact_type(f.type):
                continue
            cur = refits.get(name, f.interval)
            refits[name] = cur.intersect(iv)
    if not refits:
        return env
    syms = dict(env.symbols)
    for name, iv in refits.items():
        f = syms[name]
        syms[name] = Fact(f.type, iv, False, f.tracked)
    return Env(syms, env.channels)


def _scan_env(node, catalogs) -> Env:
    syms = {}
    stats_cols = {}
    try:
        conn = catalogs.get(node.handle.catalog)
        exact = node.handle.catalog in _EXACT_STATS_CATALOGS
        if exact:
            ts = conn.metadata().table_statistics(
                node.handle.schema, node.handle.table
            )
            if ts is not None:
                stats_cols = dict(ts.columns or {})
    except Exception:
        stats_cols = {}
    for sym, col in node.assignments:
        iv = None
        cs = stats_cols.get(col)
        if cs is not None:
            iv = R.stats_interval(sym.type, cs.low, cs.high)
        if iv is not None:
            nullable = bool(getattr(cs, "null_fraction", 0.0))
            syms[sym.name] = Fact(sym.type, iv, nullable, tracked=True)
        elif R.is_exact_type(sym.type) and not isinstance(
            sym.type, (T.ArrayType, T.MapType, T.RowType)
        ):
            syms[sym.name] = Fact(
                sym.type, R.type_interval(sym.type), True, tracked=True
            )
        else:
            syms[sym.name] = Fact.untracked(sym.type)
    env = Env(syms)
    if node.pushed_predicate is not None:
        # range certificates for FILTER OUTPUTS: rows a pushed predicate
        # admits provably satisfy it, so literal comparisons narrow the
        # surviving column facts (exactly like the licensing sources —
        # literals only, never estimates)
        env = refine_env(env, node.pushed_predicate)
    return env


def row_upper_bound(node, catalogs=None, _memo=None) -> Optional[int]:
    """A SOUND upper bound on the rows the node can ever produce, or None.

    Only hard facts are admitted: generator row counts (exact by
    construction for the builtin tpch/tpcds connectors), LIMIT/TopN counts,
    VALUES arity, and structural bounds (an inner/outer join emits at most
    |L|*|R| + |L| + |R| rows; a union the sum; an aggregation at most its
    input).  Everything else — estimates included — returns None."""
    from trino_tpu_torch.planner import plan as P

    if _memo is None:
        _memo = {}
    key = id(node)
    if key in _memo:
        return _memo[key]
    _memo[key] = None  # cycle guard (plans are DAGs; shared subtrees fine)
    out: Optional[int] = None
    kids = [row_upper_bound(c, catalogs, _memo) for c in node.children]
    if isinstance(node, P.TableScanNode):
        try:
            if node.handle.catalog in _EXACT_STATS_CATALOGS:
                conn = catalogs.get(node.handle.catalog)
                ts = conn.metadata().table_statistics(
                    node.handle.schema, node.handle.table
                )
                if ts is not None and ts.row_count is not None:
                    out = int(ts.row_count)
        except Exception:
            out = None
    elif isinstance(node, P.ValuesNode):
        out = len(node.rows)
    elif isinstance(node, (P.LimitNode, P.TopNNode)):
        n = int(node.count)
        out = n if kids[0] is None else min(n, kids[0])
    elif isinstance(node, P.EnforceSingleRowNode):
        out = 1
    elif isinstance(node, P.JoinNode):
        l, r = kids[0], kids[1]
        if l is not None and r is not None:
            out = l * r + l + r  # outer-join null rows included
    elif isinstance(node, P.UnionNode):
        if all(k is not None for k in kids):
            out = sum(kids)
    elif isinstance(node, (P.UnnestNode, P.PatternRecognitionNode)):
        out = None  # may expand rows unboundedly
    elif isinstance(
        node,
        (
            P.FilterNode, P.ProjectNode, P.AggregationNode, P.SortNode,
            P.MarkDistinctNode, P.WindowNode, P.SampleNode, P.OutputNode,
            P.SemiJoinNode, P.ExchangeNode,
        ),
    ):
        out = kids[0]
    elif len(kids) == 1:
        out = kids[0]
    _memo[key] = out
    return out


def sound_rows_bound(node, catalogs=None) -> Optional[int]:
    """The canonical sound row bound: verify.capacity.rows_bound — which
    adds exact-filter selectivity and fanout-aware join bounds (a join
    with a proven-unique build key emits at most its probe side) on top of
    the structural `row_upper_bound`.  The capacity bounds are what let
    decimal-sum certificates license aggregations ABOVE joins."""
    try:
        from trino_tpu_torch.verify.capacity import rows_bound

        b = rows_bound(node, catalogs)
    except Exception:
        b = None
    if b is not None:
        return b
    return row_upper_bound(node, catalogs)


def plan_env(node, catalogs=None, _memo=None, issues=None) -> Env:
    """Bottom-up symbol-fact derivation over a logical plan: what interval /
    nullability each output symbol of `node` is PROVEN to satisfy."""
    from trino_tpu_torch.planner import plan as P

    if _memo is None:
        _memo = {}
    key = id(node)
    hit = _memo.get(key)
    if hit is not None:
        return hit
    _memo[key] = Env()  # cycle guard
    env = _plan_env(node, catalogs, _memo, issues)
    _memo[key] = env
    return env


def _merged_child_env(node, catalogs, memo, issues) -> Env:
    syms: dict = {}
    for c in node.children:
        syms.update(plan_env(c, catalogs, memo, issues).symbols)
    return Env(syms)


def _plan_env(node, catalogs, memo, issues) -> Env:
    from trino_tpu_torch.planner import plan as P

    if isinstance(node, P.TableScanNode):
        return _scan_env(node, catalogs)
    src = _merged_child_env(node, catalogs, memo, issues)
    if isinstance(node, P.ProjectNode):
        syms = dict(src.symbols)
        out = {}
        for sym, e in node.assignments:
            a = Analyzer(Env(syms))
            fact = a.analyze(e)
            if issues is not None:
                issues.extend(a.issues)
            out[sym.name] = fact
        return Env(out)
    if isinstance(node, P.AggregationNode):
        rows = sound_rows_bound(node.source, catalogs)
        out = {s.name: src.sym(s.name) or Fact.untracked(s.type)
               for s in node.group_symbols}
        for out_sym, agg in node.aggregations:
            out[out_sym.name] = _agg_fact(out_sym, agg, src, rows)
        return Env(out)
    if isinstance(node, P.WindowNode):
        rows = sound_rows_bound(node.source, catalogs)
        out = dict(src.symbols)
        for out_sym, fn in node.functions:
            out[out_sym.name] = _window_fact(out_sym, fn, src, rows)
        return Env(out)
    if isinstance(node, P.UnionNode):
        out = {}
        for o, branches in zip(node.outputs, _union_inputs(node)):
            facts = [src.sym(b.name) for b in branches]
            if any(f is None for f in facts):
                out[o.name] = Fact.untracked(o.type)
                continue
            iv = facts[0].interval
            for f in facts[1:]:
                iv = iv.union(f.interval)
            out[o.name] = Fact(
                o.type, iv, any(f.nullable for f in facts),
                all(f.tracked for f in facts),
            )
        return Env(out)
    if isinstance(node, (P.JoinNode,)):
        # outer sides turn nullable; keep it simple and mark everything
        # from the non-preserved side nullable
        syms = dict(src.symbols)
        if getattr(node, "kind", "inner") != "inner":
            syms = {
                k: Fact(f.type, f.interval, True, f.tracked)
                for k, f in syms.items()
            }
        return Env(syms)
    if isinstance(node, P.SemiJoinNode):
        syms = dict(src.symbols)
        syms[node.mark.name] = Fact(T.BOOLEAN, Interval(0, 1), True)
        return Env(syms)
    if isinstance(node, P.ValuesNode):
        # rows hold raw python values in logical units
        out = {}
        for i, sym in enumerate(node.outputs):
            iv = None
            nullable = False
            tracked = R.is_exact_type(sym.type)
            for row in node.rows:
                v = row[i] if i < len(row) else None
                f = Analyzer()._literal(Literal(v, sym.type))
                iv = f.interval if iv is None else iv.union(f.interval)
                nullable = nullable or f.nullable
                tracked = tracked and f.tracked
            out[sym.name] = Fact(
                sym.type, iv if iv is not None else R.type_interval(sym.type),
                nullable, tracked,
            )
        return Env(out)
    if isinstance(node, P.FilterNode):
        # filter outputs carry refined range facts (see refine_env): the
        # predicate's literal comparisons narrow surviving symbols
        return refine_env(src, node.predicate)
    # structure-preserving nodes (sort/limit/exchange/output/...)
    return src


def _union_inputs(node):
    """Per-output list of input symbols across union branches."""
    cols = []
    for i, o in enumerate(node.outputs):
        cols.append([m[i] for m in node.source_symbols if i < len(m)])
    return cols


def _agg_fact(out_sym, agg, src: Env, rows: Optional[int]) -> Fact:
    name = agg.function
    ot = out_sym.type
    arg_fact = None
    if agg.args:
        a = Analyzer(src)
        arg_fact = a.analyze(agg.args[0])
    if name in ("count", "count_star"):
        hi = rows if rows is not None else None
        return Fact(ot, Interval(0, hi), False, tracked=rows is not None)
    if arg_fact is None:
        return Fact.untracked(ot)
    if name in ("min", "max", "any_value", "arbitrary", "avg"):
        iv = arg_fact.interval
        if isinstance(arg_fact.type, T.DecimalType) and isinstance(ot, T.DecimalType):
            iv = iv.scale_pow10(ot.scale - arg_fact.type.scale)
        elif not R.is_exact_type(ot):
            return Fact.untracked(ot)
        # avg of values in [lo, hi] stays in [lo, hi] (+1 rounding unit)
        if name == "avg":
            iv = iv.add(Interval(-1, 1))
        return Fact(ot, iv, True, arg_fact.tracked)
    if name == "sum" and rows is not None and arg_fact.tracked:
        iv = arg_fact.interval
        if isinstance(arg_fact.type, T.DecimalType) and isinstance(ot, T.DecimalType):
            iv = iv.scale_pow10(ot.scale - arg_fact.type.scale)
        elif isinstance(ot, T.DecimalType) or isinstance(arg_fact.type, T.DecimalType):
            return Fact.untracked(ot)
        if iv.bounded:
            return Fact(
                ot,
                Interval(min(iv.lo, 0) * rows, max(iv.hi, 0) * rows),
                True, tracked=True,
            )
    return Fact.untracked(ot)


def _window_fact(out_sym, fn, src: Env, rows: Optional[int]) -> Fact:
    ot = out_sym.type
    name = fn.name
    if name in ("row_number", "rank", "dense_rank", "ntile", "count",
                "count_star"):
        hi = rows if rows is not None else None
        return Fact(ot, Interval(0 if name.startswith("count") else 1, hi),
                    False, tracked=rows is not None)
    arg_fact = None
    if getattr(fn, "args", None):
        a0 = fn.args[0]
        arg_fact = Analyzer(src).analyze(a0)
    if arg_fact is not None and name in (
        "min", "max", "first_value", "last_value", "nth_value", "lag",
        "lead", "avg",
    ):
        iv = arg_fact.interval
        if isinstance(arg_fact.type, T.DecimalType) and isinstance(ot, T.DecimalType):
            iv = iv.scale_pow10(ot.scale - arg_fact.type.scale)
        elif not R.is_exact_type(ot):
            return Fact.untracked(ot)
        if name == "avg":
            iv = iv.add(Interval(-1, 1))
        return Fact(ot, iv, True, arg_fact.tracked)
    if (
        name == "sum" and arg_fact is not None and rows is not None
        and arg_fact.tracked and arg_fact.interval.bounded
    ):
        iv = arg_fact.interval
        if isinstance(arg_fact.type, T.DecimalType) and isinstance(ot, T.DecimalType):
            iv = iv.scale_pow10(ot.scale - arg_fact.type.scale)
        if iv.bounded:
            return Fact(
                ot, Interval(min(iv.lo, 0) * rows, max(iv.hi, 0) * rows),
                True, tracked=True,
            )
    return Fact.untracked(ot)


# -- certificates: the planner-facing licensing API ----------------------------


def sum_certificate(
    expr: Expr, env: Env, rows_bound: Optional[int],
) -> Optional[RangeCertificate]:
    """Range certificate for an aggregation/window SUM input expression, or
    None when no admissible proof exists.  `env` binds the expression's free
    references (symbols or channels) to facts; `rows_bound` bounds the total
    contributing rows across the whole query (see row_upper_bound)."""
    try:
        fact, _ = analyze_expr(expr, env)
    except Exception:
        return None
    if not fact.tracked or not R.is_exact_type(fact.type):
        return None
    t = fact.type
    scale = t.scale if isinstance(t, T.DecimalType) else 0
    prov = ["expr:" + _expr_brief(expr)]
    if rows_bound is not None:
        prov.append(f"rows:{rows_bound}")
    return R.certificate(fact.interval, scale, rows_bound, prov)


def _expr_brief(e: Expr) -> str:
    s = repr(e)
    return s if len(s) <= 120 else s[:117] + "..."


def channel_env_for(symbols, sym_env: Env) -> Env:
    """Adapter: symbol-keyed env -> channel-keyed env for a layout."""
    return Env.for_layout(symbols, sym_env)


def license_decimal_sums(plan, catalogs=None) -> int:
    """The planner-facing licensing pass: walk the optimized logical plan
    and attach a proof-licensed `sum_bound` to every decimal sum/avg
    Aggregation / window function whose input expression has a range
    certificate proving ALL partial sums fit int64.  Runs once at the end
    of plan optimization — before fragmentation — so the local planner,
    the distributed partial/final split, and the window operator all read
    the same proof off the plan node.  Returns the number licensed."""
    from trino_tpu_torch.planner import plan as P

    n = 0
    env_memo: dict = {}
    for node in _walk_plan(plan):
        if isinstance(node, P.AggregationNode):
            rows = sound_rows_bound(node.source, catalogs)
            if rows is None:
                continue
            env = plan_env(node.source, catalogs, env_memo)
            for out_sym, agg in node.aggregations:
                if agg.function not in ("sum", "avg") or not agg.args:
                    continue
                # the sum STATE is Int128 (decimal(38, s)) for every
                # decimal input — avg included, whatever its output type
                # (_state_types mirrors DecimalSumAggregation)
                if not isinstance(agg.args[0].type, T.DecimalType):
                    continue
                cert = sum_certificate(agg.args[0], env, rows)
                if cert is None:
                    continue
                b = cert.licensed_i64_sum_bound()
                if b is not None:
                    agg.sum_bound = b
                    n += 1
        elif isinstance(node, P.WindowNode):
            rows = sound_rows_bound(node.source, catalogs)
            if rows is None:
                continue
            env = plan_env(node.source, catalogs, env_memo)
            for out_sym, fn in node.functions:
                if fn.name not in ("sum", "avg") or not fn.args:
                    continue
                at = fn.args[0].type
                if not isinstance(at, T.DecimalType):
                    continue
                cert = sum_certificate(fn.args[0], env, rows)
                if cert is None:
                    continue
                b = cert.licensed_i64_sum_bound()
                if b is not None:
                    fn.sum_bound = b
                    n += 1
    return n


# -- the sweep: every expression of every TPC-H + TPC-DS plan ------------------


#: expression positions per node type: (description, expr) pairs
def _node_exprs(node):
    from trino_tpu_torch.planner import plan as P

    if isinstance(node, P.TableScanNode):
        if node.pushed_predicate is not None:
            yield "pushed_predicate", node.pushed_predicate
    elif isinstance(node, P.FilterNode):
        yield "predicate", node.predicate
    elif isinstance(node, P.ProjectNode):
        for sym, e in node.assignments:
            yield f"project:{sym.name}", e
    elif isinstance(node, P.AggregationNode):
        for out_sym, agg in node.aggregations:
            for a in agg.args:
                yield f"agg:{out_sym.name}", a
            if agg.filter is not None:
                yield f"agg_filter:{out_sym.name}", agg.filter
    elif isinstance(node, P.JoinNode):
        if node.filter is not None:
            yield "join_filter", node.filter
    elif isinstance(node, P.SemiJoinNode):
        if node.filter is not None:
            yield "semijoin_filter", node.filter
    elif isinstance(node, P.UnnestNode):
        for sym, e in node.unnest:
            yield f"unnest:{sym.name}", e


def _walk_plan(node, _seen=None):
    if _seen is None:
        _seen = set()
    if id(node) in _seen:
        return
    _seen.add(id(node))
    yield node
    for c in node.children:
        yield from _walk_plan(c, _seen)


def numeric_safety_baseline(root: str = ".") -> dict:
    """{rule:signature -> justification} from tools/lint_baseline.json.

    DELIBERATE twin of tools/lint_tpu.numeric_safety_baseline: the lint
    must stay stdlib-only (the dependency-free CI lint job cannot import
    trino_tpu), so the two passes share the JSON contract, not code —
    change the file location / key / error handling in BOTH places."""
    import json
    import os

    path = os.path.join(root, "tools", "lint_baseline.json")
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return dict(json.load(fh).get("numeric_safety") or {})
    except (OSError, ValueError):
        return {}


@dataclass
class SweepResult:
    proven: int = 0
    baselined: int = 0
    violations: list = field(default_factory=list)  # (where, Issue)
    used_baseline: set = field(default_factory=set)
    expressions: int = 0


def sweep_plan(plan, catalogs, baseline: dict, result: SweepResult,
               where: str, verbose: bool = False) -> None:
    issues_sink: list = []
    env_memo: dict = {}
    for node in _walk_plan(plan):
        src_env = Env()
        if node.children:
            syms: dict = {}
            for c in node.children:
                syms.update(
                    plan_env(c, catalogs, env_memo, issues_sink).symbols
                )
            src_env = Env(syms)
        elif hasattr(node, "assignments") and hasattr(node, "handle"):
            src_env = _scan_env(node, catalogs)
        for slot, e in _node_exprs(node):
            result.expressions += 1
            a = Analyzer(src_env)
            try:
                a.analyze(e)
            except Exception as exc:  # analyzer must never kill the sweep
                a.issues.append(Issue(
                    "analyzer-error", type(exc).__name__, str(exc)[:200]
                ))
            if not a.issues:
                result.proven += 1
                continue
            unbase = []
            for iss in a.issues:
                if iss.key() in baseline:
                    result.used_baseline.add(iss.key())
                else:
                    unbase.append(iss)
            if not unbase:
                result.baselined += 1
            else:
                for iss in unbase:
                    result.violations.append((f"{where}/{slot}", iss))
                if verbose:
                    for iss in unbase:
                        print(f"VIOLATION {where}/{slot}: {iss}")


def verify_benchmarks(verbose: bool = False, root: str = ".") -> SweepResult:
    """Walk every expression of every TPC-H + TPC-DS plan through the
    analyzer; classify each as PROVEN-SAFE / BASELINED / VIOLATION.  The
    planning runs on the CPU; nothing is executed."""
    from trino_tpu_torch.runtime.runner import LocalQueryRunner
    from trino_tpu_torch.verify.collectives import benchmark_suites

    baseline = numeric_safety_baseline(root)
    result = SweepResult()
    for catalog, schema, queries in benchmark_suites():
        r = LocalQueryRunner(catalog=catalog, schema=schema, device="cpu")
        for q in sorted(queries):
            plan = r.create_plan(queries[q])
            sweep_plan(
                plan, r.catalogs, baseline, result,
                f"{catalog}:{q}", verbose,
            )
    result.violations.sort(key=lambda v: (v[0], v[1].key()))
    return result


def stale_keys(result: SweepResult, root: str = ".") -> set:
    """rule:signature baseline entries no live finding used.  Path-prefixed
    keys belong to the JAX package's AST lint (tools/lint_tpu.py), which
    checks its own staleness; only rule:signature keys are the sweep's."""
    return {
        k for k in numeric_safety_baseline(root)
        if not k.startswith("trino_tpu/")
    } - result.used_baseline


def main() -> int:  # pragma: no cover - CLI entry
    import argparse

    ap = argparse.ArgumentParser(
        description="numeric-safety sweep over all TPC-H + TPC-DS plan "
        "expressions (abstract interpretation of dtype/scale/range/validity)"
    )
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--root", default=".")
    ap.add_argument(
        "--check-stale", action="store_true",
        help="FAIL when a rule:signature entry of tools/lint_baseline.json "
        "(numeric_safety; read, never written) no longer matches any live "
        "sweep finding",
    )
    args = ap.parse_args()
    res = verify_benchmarks(args.verbose, root=args.root)
    stale = stale_keys(res, args.root)
    for where, iss in res.violations:
        print(f"VIOLATION {where}: {iss}")
        print(f"  baseline key: {iss.key()!r}")
    for k in sorted(stale):
        print(
            f"{'STALE' if args.check_stale else 'note'}: numeric_safety "
            f"baseline entry {k!r} has no live finding"
        )
    print(
        f"numeric-safety: {res.expressions} expressions — "
        f"{res.proven} PROVEN-SAFE, {res.baselined} BASELINED, "
        f"{len(res.violations)} VIOLATION(s)"
    )
    if res.violations:
        return 1
    return 1 if (args.check_stale and stale) else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
