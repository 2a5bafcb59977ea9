"""Array and JSON scalar functions.

Port of trino_tpu/expr/arrays.py (reference roles: operator/scalar/
ArrayFunctions + ArrayContains/ArrayPositionFunction/ArrayDistinctFunction/
ArraySortFunction, scalar/SplitFunction.java, and the JSON path family,
JsonExtract.java and operator/scalar/json/*).  Arrays are rectangular
[capacity, K] blocks with per-row lengths (columnar/column.py); string work
follows the engine's dictionary discipline: computed once per distinct
dictionary value on the host, gathered on the device by code.

A lambda body (transform, filter, the match family, zip_with) evaluates
ONCE over the whole padded [capacity, K] element matrix, so every scalar op
broadcasts elementwise; `reduce` unrolls its fold over the K slots, each
step one [capacity] update.  The rectangular layout has no per-element
NULLs, with the JAX package's consequences: ARRAY[...] with a NULL element
raises, array_agg skips NULL inputs, a NULL lambda result keeps its fill
value, and zip_with of arrays of different lengths is NULL.
"""

from __future__ import annotations

import json
from collections import deque

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.columnar.column import pad_slots, take_table, torch_dtype
from trino_tpu_torch.expr.compiler import Val, _and_valid, _valid_arr
from trino_tpu_torch.expr.functions import (
    FUNCTIONS,
    _host_table,
    _literal_str,
    _require_dict,
    register,
)


def _arr2d(ctx, v: Val):
    """Broadcast an array Val to ([cap, K], lengths int32 [cap])."""
    if v.lengths is None:
        raise NotImplementedError("expected an array value")
    cap = ctx.capacity
    k = v.data.shape[-1]
    data = torch.broadcast_to(v.data, (cap, k))
    lens = torch.broadcast_to(v.lengths.to(torch.int32), (cap,))
    return data, lens


def _elem_mask(data, lens):
    """bool [cap, K]: which padded slots hold real elements."""
    k = data.shape[1]
    pos = torch.arange(k, dtype=torch.int32, device=data.device)
    return pos[None, :] < lens[:, None]


def _null(ctx, out_type: T.Type) -> Val:
    zero = torch.zeros(ctx.capacity, dtype=torch_dtype(out_type.np_dtype), device=ctx.device)
    return Val(zero, False, out_type)


def _literal_int(v: Val) -> int:
    """A literal argument's value (sequence, repeat and split need static
    widths)."""
    return int(v.data)


@register("cardinality")
def _cardinality(ctx, call, v):
    if v.lengths is None:
        raise NotImplementedError("cardinality of non-array value")
    lens = torch.broadcast_to(v.lengths.to(torch.int64), (ctx.capacity,))
    return Val(lens, v.valid, call.type)


@register("element_at")
def _element_at(ctx, call, arr, idx):
    """element_at(array, i): 1-based, a negative i counts from the end,
    NULL out of range (reference: ElementAtFunction).  Map values go to
    the map lookup."""
    if isinstance(arr.type, T.MapType):
        from trino_tpu_torch.expr.maps import map_element_at

        return map_element_at(ctx, call, arr, idx)
    data, lens = _arr2d(ctx, arr)
    k = data.shape[1]
    if k == 0:
        return _null(ctx, call.type)
    i = torch.broadcast_to(idx.data.to(torch.int64), (ctx.capacity,))
    ln = lens.to(torch.int64)
    eff = torch.where(i < 0, ln + i + 1, i)  # -1 -> the last element
    in_range = torch.logical_and(eff >= 1, eff <= ln)
    pos = (eff - 1).clamp(0, k - 1)
    out = torch.gather(data, 1, pos[:, None])[:, 0]
    valid = _and_valid(_and_valid(arr.valid, idx.valid), in_range)
    return Val(out, valid, call.type, arr.dictionary)


def _needle_eq(ctx, arr: Val, data, needle: Val, what: str):
    """bool [cap, K]: element == needle (a string needle resolves against
    the array's dictionary on the host)."""
    if arr.dictionary is not None:
        code = arr.dictionary.index.get(_literal_str(needle, what), -1)
        return data == code
    return data == needle.data[..., None]


@register("contains")
def _contains(ctx, call, arr, needle):
    data, lens = _arr2d(ctx, arr)
    hit = torch.logical_and(_elem_mask(data, lens), _needle_eq(ctx, arr, data, needle, "contains"))
    return Val(hit.any(dim=1), _and_valid(arr.valid, needle.valid), call.type)


@register("array_position")
def _array_position(ctx, call, arr, needle):
    data, lens = _arr2d(ctx, arr)
    eq = torch.logical_and(
        _elem_mask(data, lens), _needle_eq(ctx, arr, data, needle, "array_position")
    )
    k = data.shape[1]
    pos = torch.arange(1, k + 1, dtype=torch.int64, device=data.device)[None, :]
    first = torch.where(eq, pos, k + 1).amin(dim=1) if k else torch.ones(
        data.shape[0], dtype=torch.int64, device=data.device
    )
    out = torch.where(first > k, 0, first)
    return Val(out, _and_valid(arr.valid, needle.valid), call.type)


def _masked_reduce(data, lens, fill, how: str):
    em = _elem_mask(data, lens)
    filled = torch.where(em, data, torch.as_tensor(fill, dtype=data.dtype, device=data.device))
    out = filled.amax(dim=1) if how == "max" else filled.amin(dim=1)
    return out, lens > 0


def _extreme(data, dictionary, how: str):
    """The padding fill of array_max (the lowest value) / array_min (the
    highest)."""
    if dictionary is not None:
        return -1 if how == "max" else len(dictionary.values)
    if data.is_floating_point():
        return float("-inf") if how == "max" else float("inf")
    info = torch.iinfo(data.dtype)
    return info.min if how == "max" else info.max


@register("array_max")
def _array_max(ctx, call, arr):
    data, lens = _arr2d(ctx, arr)
    out, nonempty = _masked_reduce(data, lens, _extreme(data, arr.dictionary, "max"), "max")
    return Val(out, _and_valid(arr.valid, nonempty), call.type, arr.dictionary)


@register("array_min")
def _array_min(ctx, call, arr):
    data, lens = _arr2d(ctx, arr)
    out, nonempty = _masked_reduce(data, lens, _extreme(data, arr.dictionary, "min"), "min")
    return Val(out, _and_valid(arr.valid, nonempty), call.type, arr.dictionary)


def _sorted_rows(data, lens):
    """Per-row ascending sort with the padding pushed past the elements."""
    em = _elem_mask(data, lens)
    if data.is_floating_point():
        hi = float("inf")
    else:
        hi = torch.iinfo(data.dtype).max
    keyed = torch.where(em, data, torch.as_tensor(hi, dtype=data.dtype, device=data.device))
    return torch.sort(keyed, dim=1).values


@register("array_sort")
def _array_sort(ctx, call, arr):
    data, lens = _arr2d(ctx, arr)
    return Val(_sorted_rows(data, lens), arr.valid, call.type, arr.dictionary, lens)


def _compact_rows(data, keep):
    """Each row's kept slots moved to the front in order (a stable sort of
    ~keep), and the kept counts."""
    order = torch.sort(torch.logical_not(keep).to(torch.int8), dim=1, stable=True).indices
    return torch.gather(data, 1, order), keep.sum(dim=1).to(torch.int32)


@register("array_distinct")
def _array_distinct(ctx, call, arr):
    """Distinct elements in sorted order (the reference keeps first-seen
    order; the JAX package sorts, and so does the port)."""
    data, lens = _arr2d(ctx, arr)
    s = _sorted_rows(data, lens)
    k = data.shape[1]
    live = _elem_mask(s, lens)
    first = torch.ones((s.shape[0], min(k, 1)), dtype=torch.bool, device=s.device)
    new = torch.cat([first, s[:, 1:] != s[:, :-1]], dim=1)
    out, out_lens = _compact_rows(s, torch.logical_and(live, new))
    out = torch.where(_elem_mask(out, out_lens), out, torch.zeros((), dtype=out.dtype, device=out.device))
    return Val(out, arr.valid, call.type, arr.dictionary, out_lens)


@register("sequence")
def _sequence(ctx, call, start, stop, step=None):
    """sequence(start, stop[, step]) over literal bounds (the rectangular
    layout needs a static K)."""
    s0, s1 = _literal_int(start), _literal_int(stop)
    st = _literal_int(step) if step is not None else 1
    if st == 0:
        raise ValueError("sequence step cannot be zero")
    vals = np.arange(s0, s1 + (1 if st > 0 else -1), st, dtype=np.int64)
    k = max(1, len(vals))
    row = np.zeros(k, np.int64)
    row[: len(vals)] = vals
    cap = ctx.capacity
    data = torch.broadcast_to(ctx.tensor(row, torch.int64), (cap, k))
    lens = torch.full((cap,), len(vals), dtype=torch.int32, device=ctx.device)
    return Val(data, _and_valid(start.valid, stop.valid), call.type, None, lens)


@register("repeat")
def _repeat(ctx, call, elem, count):
    n = max(_literal_int(count), 0)
    k = max(1, n)
    cap = ctx.capacity
    e = torch.broadcast_to(elem.data, (cap,))
    data = torch.broadcast_to(e[:, None], (cap, k))
    em = torch.arange(k, dtype=torch.int32, device=ctx.device)[None, :] < n
    data = torch.where(em, data, torch.zeros((), dtype=data.dtype, device=data.device))
    lens = torch.full((cap,), n, dtype=torch.int32, device=ctx.device)
    return Val(data, elem.valid, call.type, elem.dictionary, lens)


#: host seconds, dictionary size and K of the latest tables split built
#: (read and cleared by callers that time this host work; bounded)
SPLIT_TABLE_LOG: deque = deque(maxlen=4096)


def _split_table(d: StringDictionary, sep: str, lim):
    """(pieces dictionary, codes [|d|, K], lengths [|d|]) of split over
    every dictionary value, kept across batches with the string
    functions' tables (functions._host_table)."""
    import time

    def build(d):
        t0 = time.perf_counter()
        pieces_per = [(s.split(sep, lim - 1) if lim else s.split(sep)) for s in d.values]
        nd = StringDictionary(sorted({p for ps in pieces_per for p in ps}))
        ix = nd.index
        k = max(1, max((len(ps) for ps in pieces_per), default=1))
        table = np.zeros((len(d.values), k), np.int32)
        lens_t = np.zeros(len(d.values), np.int32)
        for i, ps in enumerate(pieces_per):
            lens_t[i] = len(ps)
            table[i, : len(ps)] = [ix[p] for p in ps]
        SPLIT_TABLE_LOG.append((time.perf_counter() - t0, len(d.values), k))
        return nd, table, lens_t

    return _host_table("split", (sep, lim), d, build)


@register("split")
def _split(ctx, call, value, delim, limit=None):
    """split(string, delimiter[, limit]) -> array(varchar), computed once
    per dictionary value (SplitFunction's row loop becomes a dictionary
    table) and gathered on the device by code."""
    d = _require_dict(value, "split")
    sep = _literal_str(delim, "split")
    lim = _literal_int(limit) if limit is not None else None
    nd, table, lens_t = _split_table(d, sep, lim)
    k = table.shape[1]
    cap = ctx.capacity
    data = torch.broadcast_to(take_table(table, value.data), (cap, k))
    lens = torch.broadcast_to(take_table(lens_t, value.data), (cap,))
    return Val(data, value.valid, call.type, nd, lens)


@register("slice")
def _slice_array(ctx, call, arr, start, length):
    """slice(array, start, length), 1-based; a negative start counts from
    the end (reference: ArraySliceFunction)."""
    data, lens = _arr2d(ctx, arr)
    cap, k = data.shape
    if k == 0:
        return Val(data, arr.valid, call.type, arr.dictionary, lens)
    s = torch.broadcast_to(start.data.to(torch.int64), (cap,))
    n = torch.broadcast_to(length.data.to(torch.int64), (cap,))
    ln = lens.to(torch.int64)
    begin = torch.where(s < 0, ln + s, s - 1)  # 0-based
    begin_c = begin.clamp(0, k)
    take = torch.minimum(n, ln - begin_c).clamp(0, k)
    idx = begin_c[:, None] + torch.arange(k, dtype=torch.int64, device=data.device)[None, :]
    out = torch.gather(data, 1, idx.clamp(0, k - 1))
    new_lens = torch.where(begin < 0, 0, take).to(torch.int32)
    valid = _and_valid(_and_valid(arr.valid, start.valid), length.valid)
    # start = 0 or a negative length: the reference raises; a vectorized
    # program makes those rows NULL
    valid = _and_valid(valid, torch.logical_and(s != 0, n >= 0))
    return Val(out, valid, call.type, arr.dictionary, new_lens)


def _unify_array_dicts(ctx, a: Val, da, b: Val, db):
    """Merge two array Vals' dictionaries and recode both data planes.
    Returns (da, db, merged dictionary)."""
    from trino_tpu_torch.columnar.dictionary import union_many

    dictionary = a.dictionary
    if a.dictionary is not None or b.dictionary is not None:
        dictionary, (ta, tb) = union_many([a.dictionary, b.dictionary])
        if ta is not None:
            da = take_table(ta, da)
        if tb is not None:
            db = take_table(tb, db)
    return da, db, dictionary


@register("$array_concat")
def array_concat(ctx, call, a: Val, b: Val) -> Val:
    """array || array (reference: ArrayConcatFunction)."""
    da, la = _arr2d(ctx, a)
    db, lb = _arr2d(ctx, b)
    da, db, dictionary = _unify_array_dicts(ctx, a, da, b, db)
    ka, kb = da.shape[1], db.shape[1]
    k = ka + kb
    dt = torch_dtype(call.type.element.np_dtype)
    out = pad_slots(da.to(dt), kb)
    idx = torch.arange(k, dtype=torch.int32, device=out.device)[None, :]
    from_b = torch.logical_and(idx >= la[:, None], idx < (la + lb)[:, None])
    b_pos = (idx - la[:, None]).clamp(0, max(kb - 1, 0)).to(torch.int64)
    db_p = pad_slots(db.to(dt), k - kb)
    out = torch.where(from_b, torch.gather(db_p, 1, b_pos), out)
    return Val(out, _and_valid(a.valid, b.valid), call.type, dictionary, la + lb)


def _membership(ctx, a: Val, b: Val):
    """(hit [cap, Ka], a's elements in the MERGED dictionary, a's lengths,
    the merged dictionary): which live elements of a appear among b's."""
    da, la = _arr2d(ctx, a)
    db, lb = _arr2d(ctx, b)
    da, db, dictionary = _unify_array_dicts(ctx, a, da, b, db)
    emb = _elem_mask(db, lb)
    hit = torch.logical_and(emb[:, None, :], da[:, :, None] == db[:, None, :]).any(dim=2)
    return torch.logical_and(hit, _elem_mask(da, la)), da, la, dictionary


def _first_occurrence(da, mask):
    """Among masked slots, only each value's FIRST occurrence per row."""
    k = da.shape[1]
    pos = torch.arange(k, device=da.device)
    eq_prior = torch.logical_and(
        da[:, :, None] == da[:, None, :], pos[None, None, :] < pos[None, :, None]
    )
    dup = torch.logical_and(eq_prior, mask[:, None, :]).any(dim=2)
    return torch.logical_and(mask, torch.logical_not(dup))


def _compact_row_subset(data, keep, dictionary, valid, out_type):
    out, lens = _compact_rows(data, keep)
    return Val(out, valid, out_type, dictionary, lens)


@register("arrays_overlap")
def _arrays_overlap(ctx, call, a, b):
    hit, _, _, _ = _membership(ctx, a, b)
    return Val(hit.any(dim=1), _and_valid(a.valid, b.valid), call.type)


@register("array_intersect")
def _array_intersect(ctx, call, a, b):
    """Distinct elements of a present in b, in a's first-occurrence order
    (reference: ArrayIntersectFunction)."""
    hit, da, _la, dictionary = _membership(ctx, a, b)
    return _compact_row_subset(
        da, _first_occurrence(da, hit), dictionary, _and_valid(a.valid, b.valid), call.type
    )


@register("array_except")
def _array_except(ctx, call, a, b):
    hit, da, la, dictionary = _membership(ctx, a, b)
    keep = _first_occurrence(da, torch.logical_and(_elem_mask(da, la), torch.logical_not(hit)))
    return _compact_row_subset(da, keep, dictionary, _and_valid(a.valid, b.valid), call.type)


@register("array_union")
def _array_union(ctx, call, a, b):
    concat = FUNCTIONS["$array_concat"](ctx, call, a, b)
    return FUNCTIONS["array_distinct"](ctx, call, concat)


# -- lambda functions --------------------------------------------------------
# (reference: operator/scalar/ArrayTransformFunction, ArrayFilterFunction,
# the ArrayAnyMatchFunction family, ReduceFunction)


def _eval_lambda(ctx, lam, args: list, matrix: bool = True) -> Val:
    """Evaluate a lambda body with its parameters bound.  `matrix` marks
    evaluation over the [capacity, K] element matrix: captured columns gain
    a trailing axis and boolean/branch forms broadcast to the matrix shape
    (ExprCompiler.value / bshape)."""
    prev = (ctx._lambda_env, ctx._lambda_matrix, ctx._lambda_shape)
    env = dict(prev[0] or {})
    for name, v in zip(lam.params, args):
        env[name] = v
    ctx._lambda_env = env
    ctx._lambda_matrix = matrix
    ctx._lambda_shape = tuple(args[0].data.shape) if matrix and args else None
    try:
        return ctx.value(lam.body)
    finally:
        ctx._lambda_env, ctx._lambda_matrix, ctx._lambda_shape = prev


def _elements(data, arr: Val) -> Val:
    return Val(data, None, arr.type.element, arr.dictionary)


def _as_elements(res: Val, et: T.Type, shape) -> torch.Tensor:
    if isinstance(et, T.DecimalType) and et.is_long:
        # an element slot holds one int64: no room for two limb planes
        raise NotImplementedError(f"arrays of {et.name} elements")
    return torch.broadcast_to(res.data.to(torch_dtype(et.np_dtype)), shape)


@register("zip_with")
def _zip_with(ctx, call, a, b, lam):
    """zip_with(a1, a2, (x, y) -> e); rows whose lengths differ are NULL
    (the reference pads the shorter side with NULL elements, which the
    rectangular layout cannot hold; the JAX package does the same)."""
    da, la = _arr2d(ctx, a)
    db, lb = _arr2d(ctx, b)
    k = max(da.shape[1], db.shape[1], 1)
    dap = pad_slots(da, k - da.shape[1])
    dbp = pad_slots(db, k - db.shape[1])
    res = _eval_lambda(ctx, lam, [_elements(dap, a), _elements(dbp, b)])
    out = _as_elements(res, call.type.element, (dap.shape[0], k))
    valid = _and_valid(_and_valid(a.valid, b.valid), la == lb)
    return Val(out, valid, call.type, res.dictionary, la)


@register("transform")
def _transform(ctx, call, arr, lam):
    data, lens = _arr2d(ctx, arr)
    res = _eval_lambda(ctx, lam, [_elements(data, arr)])
    out = _as_elements(res, call.type.element, data.shape)
    # per-element NULLs are not representable: a NULL-producing element
    # keeps its fill value (as in the JAX package)
    return Val(out, arr.valid, call.type, res.dictionary, lens)


def _lambda_truth(res: Val, shape):
    """(value, validity) of a boolean lambda result over the matrix."""
    m = torch.broadcast_to(res.data.to(torch.bool), shape)
    return m, _valid_arr(res.valid, shape, m.device)


@register("filter")
def _filter_array(ctx, call, arr, lam):
    data, lens = _arr2d(ctx, arr)
    res = _eval_lambda(ctx, lam, [_elements(data, arr)])
    m, pv = _lambda_truth(res, data.shape)
    # a NULL predicate drops the element
    keep = torch.logical_and(torch.logical_and(m, pv), _elem_mask(data, lens))
    out, new_lens = _compact_rows(data, keep)
    return Val(out, arr.valid, call.type, arr.dictionary, new_lens)


def _match_reduce(ctx, call, arr, lam, combine):
    """Three-valued match semantics (reference: ArrayAnyMatchFunction):
    any = TRUE if any true, NULL if none true but some null, else FALSE;
    all = FALSE if any false, NULL if none false but some null, else TRUE."""
    data, lens = _arr2d(ctx, arr)
    em = _elem_mask(data, lens)
    res = _eval_lambda(ctx, lam, [_elements(data, arr)])
    m, pv = _lambda_truth(res, data.shape)
    has_null = torch.logical_and(em, torch.logical_not(pv)).any(dim=1)
    if combine == "any":
        hit = torch.logical_and(em, torch.logical_and(m, pv)).any(dim=1)
        out = hit
        known = torch.logical_or(hit, torch.logical_not(has_null))
    else:
        miss = torch.logical_and(em, torch.logical_and(torch.logical_not(m), pv)).any(dim=1)
        out = torch.logical_not(miss)
        known = torch.logical_or(miss, torch.logical_not(has_null))
    return Val(out, _and_valid(arr.valid, known), call.type)


@register("any_match")
def _any_match(ctx, call, arr, lam):
    return _match_reduce(ctx, call, arr, lam, "any")


@register("all_match")
def _all_match(ctx, call, arr, lam):
    return _match_reduce(ctx, call, arr, lam, "all")


@register("none_match")
def _none_match(ctx, call, arr, lam):
    v = _match_reduce(ctx, call, arr, lam, "any")
    return Val(torch.logical_not(v.data), v.valid, call.type)


@register("reduce")
def _reduce_array(ctx, call, arr, init, comb, final):
    """reduce(array, init, (s, x) -> ..., s -> ...): the fold unrolls over
    the padded width K, each step one [capacity] update.  The state takes
    the combinator's analyzed type (it may widen, e.g. a bigint init over
    double elements): the carried state is cast to it, and so is each new
    value, so torch's own promotion never decides the state's type."""
    data, lens = _arr2d(ctx, arr)
    cap, k = data.shape
    shape = (cap,)
    state = Val(torch.broadcast_to(init.data, shape), init.valid, init.type, init.dictionary)
    for j in range(k):
        xj = Val(data[:, j], None, arr.type.element, arr.dictionary)
        new = _eval_lambda(ctx, comb, [state, xj], matrix=False)
        live = lens > j
        dt = torch_dtype(new.type.np_dtype)
        if isinstance(new.type, T.DecimalType) and new.type.is_long:
            raise NotImplementedError("reduce with a long-decimal state")
        merged = torch.where(live, new.data.to(dt), state.data.to(dt))
        mv = torch.where(
            live, _valid_arr(new.valid, shape, ctx.device), _valid_arr(state.valid, shape, ctx.device)
        )
        state = Val(merged, mv, new.type, new.dictionary)
    out = _eval_lambda(ctx, final, [state], matrix=False)
    return Val(
        torch.broadcast_to(out.data, shape),
        _and_valid(arr.valid, out.valid),
        call.type,
        out.dictionary,
    )


# ---------------------------------------------------------------------------
# JSON (reference: operator/scalar/json/JsonExtract.java + a JsonPath subset)


def _parse_json_path(path: str):
    """The JSONPath subset the reference's JsonExtract supports: $, .key,
    ['key'], [index]."""
    if not path.startswith("$"):
        raise ValueError(f"invalid JSON path: {path!r}")
    i, n, steps = 1, len(path), []
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            steps.append(path[i + 1 : j])
            i = j
        elif c == "[":
            j = path.index("]", i)
            tok = path[i + 1 : j].strip()
            steps.append(tok[1:-1] if tok[:1] in ("'", '"') else int(tok))
            i = j + 1
        else:
            raise ValueError(f"invalid JSON path: {path!r}")
    return steps


def _json_walk(doc, steps):
    for s in steps:
        if isinstance(s, int):
            if not isinstance(doc, list) or s >= len(doc) or s < -len(doc):
                return None, False
        elif not isinstance(doc, dict) or s not in doc:
            return None, False
        doc = doc[s]
    return doc, True


def _json_table(value: Val, path: Val, name: str, render):
    """Evaluate a JSON path once per dictionary value: (outputs, hits)."""
    d = _require_dict(value, name)
    steps = _parse_json_path(_literal_str(path, name))
    outs, hits = [], []
    for s in d.values:
        try:
            v, ok = _json_walk(json.loads(s), steps)
            r = render(v, ok)
        except (ValueError, TypeError, OverflowError):
            r = None
        outs.append("" if r is None else r)
        hits.append(r is not None)
    return outs, hits


def _dict_gather(ctx, value: Val, outs, hits, out_type):
    nd = StringDictionary.from_unsorted(outs)
    ix = nd.index
    table = np.fromiter((ix[o] for o in outs), dtype=np.int32, count=len(outs))
    out_codes = take_table(table, value.data)
    hit = take_table(np.asarray(hits, dtype=bool), value.data)
    return Val(out_codes, _and_valid(value.valid, hit), out_type, nd)


@register("json_extract_scalar")
def _json_extract_scalar(ctx, call, value, path):
    def render(v, ok):
        if not ok or isinstance(v, (dict, list)) or v is None:
            return None
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float) and v == int(v):
            return json.dumps(v)
        return str(v)

    outs, hits = _json_table(value, path, "json_extract_scalar", render)
    return _dict_gather(ctx, value, outs, hits, call.type)


@register("json_extract")
def _json_extract(ctx, call, value, path):
    def render(v, ok):
        return json.dumps(v, separators=(",", ":")) if ok else None

    outs, hits = _json_table(value, path, "json_extract", render)
    return _dict_gather(ctx, value, outs, hits, call.type)


@register("json_array_length")
def _json_array_length(ctx, call, value):
    d = _require_dict(value, "json_array_length")
    lens, hits = [], []
    for s in d.values:
        try:
            doc = json.loads(s)
        except (ValueError, TypeError):
            doc = None
        lens.append(len(doc) if isinstance(doc, list) else 0)
        hits.append(isinstance(doc, list))
    out = take_table(np.asarray(lens, np.int64), value.data)
    hit = take_table(np.asarray(hits, bool), value.data)
    return Val(out, _and_valid(value.valid, hit), call.type)


@register("json_size")
def _json_size(ctx, call, value, path):
    def render(v, ok):
        if not ok:
            return None
        return str(len(v)) if isinstance(v, (dict, list)) else "0"

    outs, hits = _json_table(value, path, "json_size", render)
    v = _dict_gather(ctx, value, outs, hits, T.VARCHAR)
    # decode the small digit dictionary into integers
    table = np.asarray([int(x) if x else 0 for x in v.dictionary.values], np.int64)
    return Val(take_table(table, v.data), v.valid, call.type)


@register("json_parse")
@register("json_format")
def _json_identity(ctx, call, value):
    """JSON is carried as canonical text (dictionary-encoded varchar), so
    parse and format are the identity on valid text."""
    return Val(value.data, value.valid, call.type, value.dictionary)


def _element_renderer(arr: Val, et):
    """Python renderer of one array element for array_join (reference:
    operator/scalar/ArrayJoin.java's per-type casts to varchar)."""
    import datetime

    if arr.dictionary is not None:
        vals = arr.dictionary.values
        return lambda c: vals[int(c)] if 0 <= int(c) < len(vals) else ""
    if et is not None and et.name == "boolean":
        return lambda c: "true" if c else "false"
    if isinstance(et, T.DecimalType) and et.scale > 0:
        q = 10 ** et.scale

        def render(c):
            v = int(c)
            sign = "-" if v < 0 else ""
            return f"{sign}{abs(v) // q}.{abs(v) % q:0{et.scale}d}"

        return render
    if et is not None and et.name == "date":
        return lambda c: (
            datetime.date(1970, 1, 1) + datetime.timedelta(days=int(c))
        ).isoformat()
    if et is not None and et.name == "timestamp":
        return lambda c: (
            datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(c))
        ).isoformat(sep=" ")
    if et is not None and et.name == "timestamp with time zone":
        raise NotImplementedError("array_join over timestamp with time zone arrays")
    if et is not None and et.np_dtype.kind == "f":
        return lambda c: str(float(c))
    return lambda c: str(int(c))


@register("array_join")
def _array_join(ctx, call, arr, sep, *rest):
    """array_join(arr, sep [, null_replacement]) (reference:
    operator/scalar/ArrayJoin.java), rendered on the host.  The rectangular
    arrays carry no NULL elements, so a null_replacement is checked and
    unused."""
    data, lens = _arr2d(ctx, arr)
    s = _literal_str(sep, "array_join")
    if rest:
        _literal_str(rest[0], "array_join")
    et = arr.type.element if isinstance(arr.type, T.ArrayType) else None
    render = _element_renderer(arr, et)
    d = data.cpu().numpy()
    ln = lens.cpu().numpy()
    joined = [s.join(render(c) for c in d[i, : ln[i]]) for i in range(d.shape[0])]
    nd = StringDictionary.from_unsorted(joined)
    codes = ctx.tensor(np.asarray(nd.encode(joined), np.int32), torch.int32)
    return Val(codes, arr.valid, call.type, nd)
