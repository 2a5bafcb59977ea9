"""Expression compiler: IR -> torch ops over a Batch.

Port of trino_tpu/expr/compiler.py.  Where the JAX package traces each
expression into the fragment's XLA program, this compiler evaluates it
eagerly over whole columns of one batch; dictionary-dependent parts
(string predicates) are resolved to code comparisons on the host.

Null semantics follow SQL three-valued logic: functions are null-in/null-out
unless registered otherwise; AND is Kleene; filters keep rows where the
predicate is TRUE (not null).  Ported special forms: AND and OR (Kleene),
NOT, IS NULL, IF and searched CASE (limb planes for long decimals, merged
dictionaries for varchar), COALESCE, NULLIF, IN, BETWEEN, CAST, TRY, ARRAY
and SUBSCRIPT.  ROW and DEREFERENCE raise NotImplementedError by name (the
JAX package has no handler for them either).

Array and map values are rectangular: data [capacity, K] (a map
[capacity, 2K]) plus `lengths`, the per-row element count.  A lambda body
(expr/arrays.py) evaluates once over the whole [capacity, K] element
matrix: inside it `bshape()` is that matrix's shape and a captured column
gains a trailing axis, so every elementwise op broadcasts as it does in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, StringDictionary
from trino_tpu_torch.columnar.column import take_table, torch_dtype
from trino_tpu_torch.expr import ir
from trino_tpu_torch.expr.ir import Call, Expr, Form, InputRef, Literal, SpecialForm


@dataclass
class Val:
    """A value during compilation: tensor data (a column, or a 0-dim
    literal) + validity.

    valid is None (no nulls), a bool tensor, or the python literal False
    (definitely-null, for NULL literals).
    """

    data: torch.Tensor
    valid: object
    type: T.Type
    dictionary: Optional[StringDictionary] = None
    #: array/map values: data is [capacity, K], lengths int32 [capacity]
    lengths: object = None

    @property
    def is_literal_null(self) -> bool:
        return self.valid is False


def _and_valid(a, b):
    if a is False or b is False:
        return False
    if a is None:
        return b
    if b is None:
        return a
    return torch.logical_and(a, b)


def _scalar_result(t: T.Type, what: str) -> None:
    """Raise for a select over array or map branches: the row-wise selects
    broadcast one value per row (the JAX package fails on the shape)."""
    if isinstance(t, (T.ArrayType, T.MapType)):
        raise NotImplementedError(f"{what} over {t.name} values")


def _valid_arr(v, shape, device):
    if isinstance(shape, int):
        shape = (shape,)
    if v is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if v is False:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    return torch.broadcast_to(v, shape)


class ExprCompiler:
    """Compiles expressions against a concrete input Batch."""

    def __init__(self, batch: Batch):
        self.batch = batch
        self.capacity = batch.capacity
        self.device = batch.device
        # DAG memo: the same sub-Expr object may be referenced many times.
        # Keyed on the lambda context too: one Expr compiles differently
        # inside a lambda body
        self._memo: dict = {}
        #: the active lambda environment (parameter name -> Val), whether the
        #: body evaluates over the [capacity, K] element matrix, and that
        #: matrix's shape (expr/arrays.py `_eval_lambda` sets them)
        self._lambda_env: Optional[dict] = None
        self._lambda_matrix = False
        self._lambda_shape: Optional[tuple] = None

    def tensor(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A constant on this batch's device."""
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def bshape(self) -> tuple:
        """Broadcast shape of boolean and branch forms: [capacity], or the
        [capacity, K] element matrix inside an array-lambda body."""
        return self._lambda_shape if self._lambda_shape is not None else (self.capacity,)

    # -- public entry points -------------------------------------------------

    def value(self, expr: Expr) -> Val:
        from trino_tpu_torch.expr.ir import LambdaParam

        if isinstance(expr, LambdaParam):
            env = self._lambda_env
            if not env or expr.name not in env:
                raise NotImplementedError(f"unbound lambda parameter {expr.name}")
            return env[expr.name]
        if isinstance(expr, InputRef):
            c = self.batch.columns[expr.channel]
            if c.lengths is None and isinstance(expr.type, (T.ArrayType, T.MapType)):
                from trino_tpu_torch.connectors.memory import stored_nested_error

                raise stored_nested_error(expr.type)
            if self._lambda_matrix and c.lengths is None and c.data.ndim == 1:
                # a column captured inside an array-lambda body: a trailing
                # element axis, so it broadcasts against [capacity, K]
                valid = None if c.valid is None else c.valid[:, None]
                return Val(c.data[:, None], valid, expr.type, c.dictionary)
            return Val(c.data, c.valid, expr.type, c.dictionary, c.lengths)
        if isinstance(expr, Literal):
            return self._literal(expr)
        if isinstance(expr, (SpecialForm, Call)):
            env = self._lambda_env
            key = (id(expr), id(env), self._lambda_shape)
            hit = self._memo.get(key)
            # the entry pins both id()-keyed objects (the expr and the
            # lambda env): an id() key is only valid while its object lives
            if hit is not None and hit[0] is expr and hit[1] is env:
                return hit[2]
            if isinstance(expr, SpecialForm):
                v = self._form(expr)
            else:
                from trino_tpu_torch.expr.functions import dispatch

                v = dispatch(self, expr)
            self._memo[key] = (expr, env, v)
            return v
        raise NotImplementedError(f"cannot compile {expr!r}")

    def column(self, expr: Expr) -> Column:
        """Evaluate to a full-capacity Column."""
        v = self.value(expr)
        valid = None
        if v.valid is False:
            valid = torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        elif v.valid is not None:
            valid = torch.broadcast_to(v.valid, (self.capacity,))
        if v.lengths is not None:
            k = v.data.shape[-1]
            data = torch.broadcast_to(
                v.data.to(torch_dtype(v.type.np_dtype)), (self.capacity, k)
            )
            lengths = torch.broadcast_to(v.lengths.to(torch.int32), (self.capacity,))
            return Column(data, v.type, valid, v.dictionary, lengths)
        if isinstance(v.type, T.DecimalType) and v.type.is_long:
            # two-limb planes: [capacity, 2]
            d = v.data.to(torch.int64)
            if d.ndim == 0:  # null literal fill
                d = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
            elif d.ndim == 1:
                # 1-D data under a long type: short-VALUED rows, widened
                from trino_tpu_torch.types.int128 import widen64

                d = torch.stack(widen64(d), dim=-1)
            return Column(torch.broadcast_to(d, (self.capacity, 2)), v.type, valid)
        data = torch.broadcast_to(
            v.data.to(torch_dtype(v.type.np_dtype)), (self.capacity,)
        )
        return Column(data, v.type, valid, v.dictionary)

    def filter_mask(self, expr: Expr) -> torch.Tensor:
        """bool[capacity]: predicate is TRUE (nulls drop, per SQL WHERE)."""
        v = self.value(expr)
        if v.valid is False:
            return torch.zeros(self.capacity, dtype=torch.bool, device=self.device)
        data = torch.broadcast_to(v.data.to(torch.bool), (self.capacity,))
        if v.valid is None:
            return data
        return torch.logical_and(data, v.valid)

    # -- literals ------------------------------------------------------------

    def _literal(self, lit: Literal) -> Val:
        t = lit.type
        if lit.value is None:
            null = t.null_device_value()
            return Val(self.tensor(null, torch_dtype(t.np_dtype)), False, t)
        if T.is_string_kind(t) and isinstance(lit.value, str):
            # bare string literal with no column context: single-value dict
            d = StringDictionary([lit.value])
            return Val(self.tensor(0, torch.int32), None, t, d)
        if isinstance(t, T.DecimalType):
            from decimal import Context, Decimal

            ctx = Context(prec=60)  # the default 28-digit context rounds 29+
            scaled = int(
                ctx.multiply(
                    Decimal(str(lit.value)), Decimal(t.scale_factor)
                ).to_integral_value(context=ctx)
            )
            if t.is_long:
                from trino_tpu_torch.types.int128 import split_py

                # [1, 2] planes
                return Val(self.tensor([split_py(scaled)], torch.int64), None, t)
            return Val(self.tensor(scaled, torch.int64), None, t)
        return Val(self.tensor(lit.value, torch_dtype(t.np_dtype)), None, t)

    # -- special forms -------------------------------------------------------

    def _form(self, f: SpecialForm) -> Val:
        h = getattr(self, "_form_" + f.form.value, None)
        if h is None:
            raise NotImplementedError(f"special form {f.form.value}: not ported yet")
        return h(f)

    def _bool(self, v: Val, shp) -> torch.Tensor:
        return torch.broadcast_to(v.data.to(torch.bool), shp)

    def _form_and(self, f: SpecialForm) -> Val:
        vals = [self.value(a) for a in f.args]
        # Kleene AND over n terms: FALSE dominates, else NULL if any null
        shp, dev = self.bshape(), self.device
        value = torch.ones(shp, dtype=torch.bool, device=dev)
        any_false = torch.zeros(shp, dtype=torch.bool, device=dev)
        all_valid = torch.ones(shp, dtype=torch.bool, device=dev)
        for v in vals:
            va = _valid_arr(v.valid, shp, dev)
            d = self._bool(v, shp)
            value = torch.logical_and(value, torch.where(va, d, True))
            any_false = torch.logical_or(any_false, torch.logical_and(va, ~d))
            all_valid = torch.logical_and(all_valid, va)
        valid = torch.logical_or(all_valid, any_false)
        return Val(value, valid, T.BOOLEAN)

    def _form_or(self, f: SpecialForm) -> Val:
        vals = [self.value(a) for a in f.args]
        # Kleene OR over n terms: TRUE dominates, else NULL if any null
        shp, dev = self.bshape(), self.device
        value = torch.zeros(shp, dtype=torch.bool, device=dev)
        any_true = torch.zeros(shp, dtype=torch.bool, device=dev)
        all_valid = torch.ones(shp, dtype=torch.bool, device=dev)
        for v in vals:
            va = _valid_arr(v.valid, shp, dev)
            d = self._bool(v, shp)
            value = torch.logical_or(value, torch.where(va, d, False))
            any_true = torch.logical_or(any_true, torch.logical_and(va, d))
            all_valid = torch.logical_and(all_valid, va)
        valid = torch.logical_or(all_valid, any_true)
        return Val(value, valid, T.BOOLEAN)

    def _form_not(self, f: SpecialForm) -> Val:
        v = self.value(f.args[0])
        return Val(torch.logical_not(v.data.to(torch.bool)), v.valid, T.BOOLEAN)

    def _form_is_null(self, f: SpecialForm) -> Val:
        # a row predicate: array and map values ([capacity, K] data, with
        # lengths) and long decimals ([capacity, 2] limb planes) carry
        # per-row validity, so the row shape is kept.  Only a lambda
        # matrix value (2-D, no lengths, not a long decimal) has 2-D
        # validity
        v = self.value(f.args[0])
        if (
            v.data.ndim > 1
            and v.lengths is None
            and not (isinstance(v.type, T.DecimalType) and v.type.is_long)
        ):
            shp = tuple(v.data.shape)
        else:
            shp = self.bshape()
        return Val(
            torch.logical_not(_valid_arr(v.valid, shp, self.device)), None, T.BOOLEAN
        )

    def _cond_true(self, cond: Expr, shp) -> torch.Tensor:
        """bool[shp]: the condition is TRUE (NULL counts as not taken)."""
        c = self.value(cond)
        return torch.logical_and(self._bool(c, shp), _valid_arr(c.valid, shp, self.device))

    def _branch_data(self, v: Val, out_dict, out_type: T.Type, shp) -> torch.Tensor:
        data = self._recode(v, out_dict).to(torch_dtype(out_type.np_dtype))
        return torch.broadcast_to(data, shp)

    def _long_planes(self, v: Val, scale: int, shp):
        """(hi, lo) int64 limb planes of a value, broadcast to the row shape."""
        from trino_tpu_torch.expr.functions import _to_planes

        h, l = _to_planes(v, scale)
        return (
            torch.broadcast_to(h.to(torch.int64), shp),
            torch.broadcast_to(l.to(torch.int64), shp),
        )

    def _form_if(self, f: SpecialForm) -> Val:
        cond, then, els = f.args
        return self._case_fold([(cond, then)], els, f.type)

    def _form_case(self, f: SpecialForm) -> Val:
        args = list(f.args)
        default = args.pop() if len(args) % 2 == 1 else Literal(None, f.type)
        pairs = [(args[i], args[i + 1]) for i in range(0, len(args), 2)]
        return self._case_fold(pairs, default, f.type)

    def _case_fold(self, pairs, default: Expr, out_type: T.Type) -> Val:
        """Searched CASE as a right fold of selects: the first TRUE
        condition's branch wins, the default where none is TRUE."""
        _scalar_result(out_type, "IF/CASE")
        shp, dev = self.bshape(), self.device
        branches = [self.value(v) for _, v in pairs] + [self.value(default)]
        if isinstance(out_type, T.DecimalType) and out_type.is_long:
            return self._case_fold_long(pairs, branches, out_type, shp)
        out_dict = self._merge_branch_dicts(branches, out_type)
        acc = branches[-1]
        acc_data = self._branch_data(acc, out_dict, out_type, shp)
        acc_valid = _valid_arr(acc.valid, shp, dev)
        for (cond_e, _), v in zip(reversed(pairs), reversed(branches[:-1])):
            ctrue = self._cond_true(cond_e, shp)
            acc_data = torch.where(
                ctrue, self._branch_data(v, out_dict, out_type, shp), acc_data
            )
            acc_valid = torch.where(ctrue, _valid_arr(v.valid, shp, dev), acc_valid)
        return Val(acc_data, acc_valid, out_type, out_dict)

    def _case_fold_long(self, pairs, branches, out_type: T.Type, shp) -> Val:
        """CASE/IF over long-decimal branches: select on limb planes."""
        acc = branches[-1]
        acc_h, acc_l = self._long_planes(acc, out_type.scale, shp)
        acc_valid = _valid_arr(acc.valid, shp, self.device)
        for (cond_e, _), v in zip(reversed(pairs), reversed(branches[:-1])):
            ctrue = self._cond_true(cond_e, shp)
            vh, vl = self._long_planes(v, out_type.scale, shp)
            acc_h = torch.where(ctrue, vh, acc_h)
            acc_l = torch.where(ctrue, vl, acc_l)
            acc_valid = torch.where(ctrue, _valid_arr(v.valid, shp, self.device), acc_valid)
        return Val(torch.stack([acc_h, acc_l], dim=-1), acc_valid, out_type)

    def _merge_branch_dicts(self, vals, out_type):
        """One dictionary for varchar branch results: the branches'
        dictionaries merged (sorted union) when they differ."""
        if not T.is_string_kind(out_type):
            return None
        dicts = [v.dictionary for v in vals if v.dictionary is not None]
        if not dicts:
            return None
        merged = dicts[0]
        for d in dicts[1:]:
            if d is not merged and d != merged:
                if len(merged) + len(d) > (1 << 20):
                    # fail fast instead of letting an IF chain double its
                    # dictionary into the gigabytes
                    raise NotImplementedError(
                        "string branch dictionary merge exceeds the "
                        f"materialization bound ({len(merged)}+{len(d)})"
                    )
                merged = StringDictionary.from_unsorted(merged.values + d.values)
        return merged

    def _recode(self, v: Val, out_dict) -> torch.Tensor:
        """A branch's codes in the merged dictionary's code space."""
        if out_dict is None or v.dictionary is None or v.dictionary == out_dict:
            return v.data
        table = np.fromiter(
            (out_dict.index[x] for x in v.dictionary.values),
            dtype=np.int32,
            count=len(v.dictionary),
        )
        return take_table(table, v.data)

    def _form_coalesce(self, f: SpecialForm) -> Val:
        _scalar_result(f.type, "COALESCE")
        shp, dev = self.bshape(), self.device
        vals = [self.value(a) for a in f.args]
        if isinstance(f.type, T.DecimalType) and f.type.is_long:
            # limb planes fold like _case_fold_long
            acc = vals[-1]
            acc_h, acc_l = self._long_planes(acc, f.type.scale, shp)
            acc_valid = _valid_arr(acc.valid, shp, dev)
            for v in reversed(vals[:-1]):
                va = _valid_arr(v.valid, shp, dev)
                vh, vl = self._long_planes(v, f.type.scale, shp)
                acc_h = torch.where(va, vh, acc_h)
                acc_l = torch.where(va, vl, acc_l)
                acc_valid = torch.logical_or(va, acc_valid)
            return Val(torch.stack([acc_h, acc_l], dim=-1), acc_valid, f.type)
        out_dict = self._merge_branch_dicts(vals, f.type)
        acc = vals[-1]
        acc_data = self._branch_data(acc, out_dict, f.type, shp)
        acc_valid = _valid_arr(acc.valid, shp, dev)
        for v in reversed(vals[:-1]):
            va = _valid_arr(v.valid, shp, dev)
            acc_data = torch.where(va, self._branch_data(v, out_dict, f.type, shp), acc_data)
            acc_valid = torch.logical_or(va, acc_valid)
        return Val(acc_data, acc_valid, f.type, out_dict)

    def _form_nullif(self, f: SpecialForm) -> Val:
        a = self.value(f.args[0])
        shp = self.bshape()
        eq_true = self._cond_true(ir.comparison("=", f.args[0], f.args[1]), shp)
        valid = torch.logical_and(
            _valid_arr(a.valid, shp, self.device), torch.logical_not(eq_true)
        )
        return Val(a.data, valid, f.type, a.dictionary)

    def _form_in(self, f: SpecialForm) -> Val:
        # an OR of equalities: a string literal absent from the column's
        # dictionary compares as a code no row carries
        value, *items = f.args
        eqs = [ir.comparison("=", value, it) for it in items]
        return self._form_or(SpecialForm(Form.OR, eqs, T.BOOLEAN))

    def _form_between(self, f: SpecialForm) -> Val:
        v, lo, hi = f.args
        return self._form_and(
            SpecialForm(
                Form.AND,
                [ir.comparison(">=", v, lo), ir.comparison("<=", v, hi)],
                T.BOOLEAN,
            )
        )

    def _form_cast(self, f: SpecialForm) -> Val:
        from trino_tpu_torch.expr.functions import compile_cast

        return compile_cast(self, self.value(f.args[0]), f.type)

    def _form_try(self, f: SpecialForm) -> Val:
        # device arithmetic never traps: TRY is the identity, with the
        # null-on-error semantics folded into the ops (division by zero
        # gives NULL)
        return self.value(f.args[0])

    # -- arrays --------------------------------------------------------------

    def _form_array(self, f: SpecialForm) -> Val:
        """ARRAY[e1, ...] -> a [capacity, K] block + lengths (reference:
        spi/block/ArrayBlock.java's offsets become a rectangular layout).
        NULL elements are not representable: the whole array is NULL when
        any element is (as in the JAX package)."""
        vals = [self.value(a) for a in f.args]
        et = f.type.element
        if any(v.is_literal_null for v in vals):
            raise NotImplementedError("NULL array elements")
        if isinstance(et, T.DecimalType) and et.is_long:
            # an element slot holds one int64: no room for two limb planes
            raise NotImplementedError(f"arrays of {et.name} elements")
        dictionary = None
        if any(v.dictionary is not None for v in vals):
            from trino_tpu_torch.columnar.dictionary import union_many

            dictionary, tables = union_many([v.dictionary for v in vals])
            vals = [
                v if tbl is None
                else Val(take_table(tbl, v.data), v.valid, v.type, dictionary)
                for v, tbl in zip(vals, tables)
            ]
        cap, dt = self.capacity, torch_dtype(et.np_dtype)
        cols = [torch.broadcast_to(v.data.to(dt), (cap,)) for v in vals]
        data = (
            torch.stack(cols, dim=1) if cols
            else torch.zeros((cap, 0), dtype=dt, device=self.device)
        )
        valid = None
        for v in vals:
            valid = _and_valid(valid, v.valid)
        lengths = torch.full((cap,), len(vals), dtype=torch.int32, device=self.device)
        return Val(data, valid, f.type, dictionary, lengths)

    def _form_subscript(self, f: SpecialForm) -> Val:
        """array[i], 1-based; an index out of range gives NULL (the
        reference throws; a vectorized program signals by NULL)."""
        base = self.value(f.args[0])
        idx = self.value(f.args[1])
        if isinstance(base.type, T.MapType):
            from trino_tpu_torch.expr.maps import map_element_at

            return map_element_at(self, f, base, idx)
        if base.lengths is None:
            raise NotImplementedError("subscript on non-array value")
        cap = self.capacity
        if base.data.shape[-1] == 0:  # zero-width arrays: always NULL
            zero = torch.zeros(cap, dtype=torch_dtype(f.type.np_dtype), device=self.device)
            return Val(zero, False, f.type)
        k = base.data.shape[-1]
        data2 = torch.broadcast_to(base.data, (cap, k))
        lens = torch.broadcast_to(base.lengths.to(torch.int64), (cap,))
        i = torch.broadcast_to(idx.data.to(torch.int64), (cap,))
        in_range = torch.logical_and(i >= 1, i <= lens)
        pos = (i - 1).clamp(0, max(k - 1, 0))
        out = torch.gather(data2, 1, pos[:, None])[:, 0]
        valid = _and_valid(_and_valid(base.valid, idx.valid), in_range)
        return Val(out, valid, f.type, base.dictionary)
