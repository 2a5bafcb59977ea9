"""MAP scalar functions.

Port of trino_tpu/expr/maps.py (reference roles: operator/scalar/
MapConstructor.java, MapKeys/MapValues/MapCardinality,
MapSubscriptOperator.java, MapConcatFunction.java, MapElementAtFunction).

Device layout (types.MapType): a map column is [capacity, 2K] with the key
plane in slots [0:K] and the value plane in [K:2K]; `lengths` counts each
row's entries.  Every lookup is a vectorized equality scan over the key
plane: K is small (a power of two at construction).
"""

from __future__ import annotations

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar.column import pad_slots, take_table, torch_dtype
from trino_tpu_torch.expr.compiler import Val, _and_valid
from trino_tpu_torch.expr.functions import register


def _map2d(ctx, v: Val):
    """Broadcast a map Val to (keys [cap, K], values [cap, K], lengths)."""
    if v.lengths is None or not isinstance(v.type, T.MapType):
        raise NotImplementedError("expected a map value")
    cap = ctx.capacity
    two_k = v.data.shape[-1]
    k = two_k // 2
    data = torch.broadcast_to(v.data, (cap, two_k))
    lens = torch.broadcast_to(v.lengths.to(torch.int32), (cap,))
    return data[:, :k], data[:, k:], lens


def _entry_mask(k: int, lens):
    return torch.arange(k, dtype=torch.int32, device=lens.device)[None, :] < lens[:, None]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def make_map(ctx, call, keys: Val, values: Val) -> Val:
    """MAP(ARRAY[...], ARRAY[...]) (reference: MapConstructor.java).  Rows
    whose key and value arrays differ in length are NULL maps (the
    reference throws)."""
    mt = call.type
    cap = ctx.capacity
    dt = torch_dtype(mt.np_dtype)
    kk = keys.data.shape[-1] if keys.lengths is not None else 0
    kv = values.data.shape[-1] if values.lengths is not None else 0
    k = _pow2(max(kk, kv, 1))
    empty = torch.zeros((cap, 0), dtype=dt, device=ctx.device)
    kd = torch.broadcast_to(keys.data, (cap, kk)) if kk else empty
    vd = torch.broadcast_to(values.data, (cap, kv)) if kv else empty
    zeros = torch.zeros(cap, dtype=torch.int32, device=ctx.device)
    klens = (
        torch.broadcast_to(keys.lengths.to(torch.int32), (cap,))
        if keys.lengths is not None else zeros
    )
    vlens = (
        torch.broadcast_to(values.lengths.to(torch.int32), (cap,))
        if values.lengths is not None else zeros
    )
    # both planes strings: one shared (merged) dictionary
    dictionary = None
    if keys.dictionary is not None and values.dictionary is not None:
        from trino_tpu_torch.columnar.dictionary import union_many

        dictionary, (tk, tv) = union_many([keys.dictionary, values.dictionary])
        if tk is not None:
            kd = take_table(tk, kd)
        if tv is not None:
            vd = take_table(tv, vd)
    elif keys.dictionary is not None:
        dictionary = keys.dictionary
    elif values.dictionary is not None:
        dictionary = values.dictionary
    data = torch.cat([pad_slots(kd.to(dt), k - kk), pad_slots(vd.to(dt), k - kv)], dim=1)
    valid = _and_valid(_and_valid(keys.valid, values.valid), klens == vlens)
    return Val(data, valid, mt, dictionary, klens)


@register("map")
def _map_ctor(ctx, call, keys, values):
    return make_map(ctx, call, keys, values)


@register("map_keys")
def _map_keys(ctx, call, m):
    kd, _, lens = _map2d(ctx, m)
    d = m.dictionary if T.is_string_kind(m.type.key) else None
    at = call.type  # array(K)
    return Val(kd.to(torch_dtype(at.element.np_dtype)), m.valid, at, d, lens)


@register("map_values")
def _map_values(ctx, call, m):
    _, vd, lens = _map2d(ctx, m)
    d = m.dictionary if T.is_string_kind(m.type.value) else None
    at = call.type
    return Val(vd.to(torch_dtype(at.element.np_dtype)), m.valid, at, d, lens)


def _encode_key(ctx, m: Val, key: Val):
    """The probe key in the map's key-plane representation."""
    if T.is_string_kind(m.type.key) and m.dictionary is not None:
        # resolve the probe key against the map's dictionary
        if key.dictionary is m.dictionary:
            return key.data.to(m.data.dtype), key.valid
        if key.dictionary is not None:
            table = np.asarray(
                [m.dictionary.index.get(s, -1) for s in key.dictionary.values],
                dtype=np.int64,
            )
            code = take_table(table, key.data)
            return code.to(m.data.dtype), _and_valid(key.valid, code >= 0)
        raise NotImplementedError("string key without dictionary")
    return key.data.to(m.data.dtype), key.valid


def map_element_at(ctx, call, m: Val, key: Val) -> Val:
    """element_at(map, key) and map[key] (reference: MapSubscriptOperator;
    the subscript throws on a missing key, element_at gives NULL; here
    both give NULL)."""
    kd, vd, lens = _map2d(ctx, m)
    k = kd.shape[1]
    cap = ctx.capacity
    dt = torch_dtype(call.type.np_dtype)
    if k == 0:
        return Val(torch.zeros(cap, dtype=dt, device=ctx.device), False, call.type)
    probe, pvalid = _encode_key(ctx, m, key)
    probe = torch.broadcast_to(probe, (cap,))
    hit = torch.logical_and(_entry_mask(k, lens), kd == probe[:, None])
    found = hit.any(dim=1)
    pos = torch.argmax(hit.to(torch.int8), dim=1)  # the first hit
    out = torch.gather(vd, 1, pos[:, None])[:, 0]
    valid = _and_valid(_and_valid(m.valid, pvalid), found)
    d = m.dictionary if T.is_string_kind(m.type.value) else None
    return Val(out.to(dt), valid, call.type, d)


@register("map_concat")
def _map_concat(ctx, call, *maps):
    """map_concat(m1, m2, ...): a later map wins on a duplicate key
    (reference: MapConcatFunction.java)."""
    acc = maps[0]
    for nxt in maps[1:]:
        acc = _concat2(ctx, call, acc, nxt)
    return acc


def _recode_planes(mt, table, keys, values):
    """A map's string planes recoded into the merged dictionary (a None
    table: already in it)."""
    if table is not None:
        if T.is_string_kind(mt.key):
            keys = take_table(table, keys).to(keys.dtype)
        if T.is_string_kind(mt.value):
            values = take_table(table, values).to(values.dtype)
    return keys, values


def _concat2(ctx, call, a: Val, b: Val) -> Val:
    mt = call.type
    ka, va, la = _map2d(ctx, a)
    kb, vb, lb = _map2d(ctx, b)
    dictionary = a.dictionary
    if a.dictionary is not None or b.dictionary is not None:
        from trino_tpu_torch.columnar.dictionary import union_many

        dictionary, (ta, tb) = union_many([a.dictionary, b.dictionary])
        ka, va = _recode_planes(mt, ta, ka, va)
        kb, vb = _recode_planes(mt, tb, kb, vb)
    na, nb = ka.shape[1], kb.shape[1]
    ema = _entry_mask(na, la)
    emb = _entry_mask(nb, lb)
    # drop the entries of a whose key is also (live) in b: b wins
    dup = torch.logical_and(emb[:, None, :], ka[:, :, None] == kb[:, None, :]).any(dim=2)
    keep_a = torch.logical_and(ema, torch.logical_not(dup))
    # compact a's kept entries to the front
    order = torch.sort(torch.logical_not(keep_a).to(torch.int8), dim=1, stable=True).indices
    ka_s = torch.gather(ka, 1, order)
    va_s = torch.gather(va, 1, order)
    n_keep = keep_a.sum(dim=1).to(torch.int32)
    k = _pow2(max(na + nb, 1))
    dt = torch_dtype(mt.np_dtype)
    keys = pad_slots(ka_s.to(dt), k - na)
    vals = pad_slots(va_s.to(dt), k - na)
    kb_p = pad_slots(kb.to(dt), k - nb)
    vb_p = pad_slots(vb.to(dt), k - nb)
    # b's entries go right after a's kept prefix, per row
    idx = torch.arange(k, dtype=torch.int32, device=keys.device)[None, :]
    from_b = torch.logical_and(idx >= n_keep[:, None], idx < (n_keep + lb)[:, None])
    b_pos = (idx - n_keep[:, None]).clamp(0, k - 1).to(torch.int64)
    keys = torch.where(from_b, torch.gather(kb_p, 1, b_pos), keys)
    vals = torch.where(from_b, torch.gather(vb_p, 1, b_pos), vals)
    return Val(
        torch.cat([keys, vals], dim=1), _and_valid(a.valid, b.valid), mt, dictionary, n_keep + lb
    )
