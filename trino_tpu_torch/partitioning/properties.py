"""Partitioning-property derivation (reference: the ActualProperties /
PropertyDerivations side of AddExchanges).

`derive_partitioning(node, resolver, n_workers)` computes, bottom-up, the
set of *placements* of a (possibly already exchange-placed) plan subtree: a
placement is an ordered tuple of symbol names S such that every row of the
subtree's output lives on worker `exchange_hash(S) % W`.  Two subtrees that
share a placement aligned through join criteria are co-partitioned — their
join needs no repartition exchange; an aggregation whose grouping keys
cover a placement has every group whole on one worker — it runs
single-stage with no exchange.

Soundness notes baked into the rules:

  * a placement on a *subset* of some consumer's keys is enough for
    co-location (equal full-key rows agree on the subset);
  * ordered tuples, not sets: the exchange hash folds key columns in
    order, so ("a", "b") and ("b", "a") are different placement functions;
  * outer joins null out one side's columns on unmatched rows, which
    breaks that side's placements (nulls co-locate only under the hash of
    their own side) — left joins keep only probe placements, full joins
    keep none.
"""

from __future__ import annotations

from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.expr.ir import SymbolRef
from trino_tpu_torch.partitioning.layout import scan_partitioning


def derive_partitioning(node, resolver, n_workers: int) -> tuple:
    """-> tuple of placements (each an ordered tuple of symbol names)."""
    m = _RULES.get(type(node).__name__)
    if m is None:
        # RemoteSourceNode lives in fragmenter (import cycle); match by shape
        if hasattr(node, "exchange_kind"):
            return _d_remote(node)
        return ()
    return m(node, resolver, n_workers)


def _inherit(node, resolver, n_workers):
    return derive_partitioning(node.children[0], resolver, n_workers)


def _d_scan(node, resolver, n_workers):
    hit = scan_partitioning(node, resolver, n_workers)
    if hit is None:
        return ()
    _, names, _ = hit
    return (names,)


def _d_project(node, resolver, n_workers):
    src = derive_partitioning(node.source, resolver, n_workers)
    if not src:
        return ()
    # identity refs rename placements through the projection; a placement
    # with any non-surviving column is lost
    rename = {}
    for sym, e in node.assignments:
        if isinstance(e, SymbolRef):
            rename.setdefault(e.name, sym.name)
    out = []
    for t in src:
        if all(n in rename for n in t):
            out.append(tuple(rename[n] for n in t))
    return tuple(out)


def _d_exchange(node, resolver, n_workers):
    if node.kind == "repartition" and node.partition_symbols:
        return (tuple(s.name for s in node.partition_symbols),)
    return ()


def _d_remote(node):
    if node.exchange_kind == "repartition" and node.partition_symbols:
        return (tuple(s.name for s in node.partition_symbols),)
    return ()


def join_output_placements(probe_placements, criteria, kind: str) -> tuple:
    """Placements of a join's output given the PROBE side's placements.
    Probe rows stay put, so probe placements survive for inner/left joins;
    inner joins additionally satisfy the build-side equivalents of any
    placement fully covered by the join criteria (matched rows agree on
    key values).  Full joins keep nothing (both sides gain null rows)."""
    if kind == "full":
        return ()
    out = list(probe_placements)
    if kind == "inner":
        l2r = {l.name: r.name for l, r in criteria}
        for t in probe_placements:
            if t and all(n in l2r for n in t):
                mapped = tuple(l2r[n] for n in t)
                if mapped not in out:
                    out.append(mapped)
    return tuple(out)


def _d_join(node, resolver, n_workers):
    if node.kind == "cross" or not node.criteria:
        return ()
    probe = derive_partitioning(node.left, resolver, n_workers)
    # build-side equivalents may only be claimed through criteria whose
    # hash is dictionary-independent OR whose two sides share one global
    # dictionary version — a producer-local string pair maps equal values
    # to different codes, so the mirrored claim would be unsound
    usable = hash_aligned_criteria(
        node.criteria, derive_dictionary_coding(node, resolver)
    )
    return join_output_placements(probe, usable, node.kind)


def _d_agg(node, resolver, n_workers):
    src = derive_partitioning(node.source, resolver, n_workers)
    gnames = {s.name for s in node.group_symbols}
    return tuple(t for t in src if t and set(t) <= gnames)


def _d_semi(node, resolver, n_workers):
    return derive_partitioning(node.source, resolver, n_workers)


_RULES = {
    "TableScanNode": _d_scan,
    "FilterNode": _inherit,
    "LimitNode": _inherit,
    "SortNode": _inherit,
    "TopNNode": _inherit,
    "SampleNode": _inherit,
    "UnnestNode": _inherit,
    "WindowNode": _inherit,
    "MarkDistinctNode": _inherit,
    "ProjectNode": _d_project,
    "ExchangeNode": _d_exchange,
    "JoinNode": _d_join,
    "AggregationNode": _d_agg,
    "SemiJoinNode": _d_semi,
}


def hash_aligned_criteria(criteria, coding=None) -> list:
    """Criteria pairs usable for cross-side co-location claims: both key
    types must hash dictionary-independently (plain integer kinds).  A
    dictionary-coded (string) key hashes its producer-local codes, so two
    independently-produced sides place equal strings on DIFFERENT workers —
    eliding their exchange would silently drop matches.

    The one VERSION-GATED exception (`coding`: symbol name -> (key,
    version) global dictionary ref, from `derive_dictionary_coding`): when
    both sides of a string pair carry the SAME versioned global assignment,
    equal strings provably have equal codes everywhere, so the pair hashes
    cross-side like an integer key.  Producer-local keys (no ref) and
    mixed-version pairs stay excluded."""
    from trino_tpu_torch import types as T
    from trino_tpu_torch.partitioning.layout import hashable_layout_type

    out = []
    for l, r in criteria:
        if hashable_layout_type(l.type) and hashable_layout_type(r.type):
            out.append((l, r))
        elif (
            coding is not None
            and T.is_string_kind(l.type)
            and T.is_string_kind(r.type)
            and coding.get(l.name) is not None
            and coding.get(l.name) == coding.get(r.name)
        ):
            out.append((l, r))
    return out


def derive_dictionary_coding(node, resolver) -> dict:
    """Bottom-up map of symbol name -> (key, version) global dictionary ref
    for every string symbol of the subtree's output that is provably coded
    under one versioned mesh-wide assignment (runtime/dictionary_service).
    Empty claims are always sound (they just keep the exclusion); a symbol
    appears ONLY when its codes survive unchanged from a registered scan:
    identity projections, filters, exchanges (global codes ship as-is),
    join pass-through, and group keys.  Derived transforms (upper(x),
    concat, ...) produce fresh dictionaries and drop out."""
    if resolver is None or not getattr(resolver, "global_dicts", True):
        return {}
    return _coding(node, resolver)


def _coding(node, resolver) -> dict:
    name = type(node).__name__
    if name == "TableScanNode":
        from trino_tpu_torch import types as T
        from trino_tpu_torch.runtime.dictionary_service import DICTIONARY_SERVICE

        out = {}
        for sym, col in node.assignments:
            if T.is_string_kind(sym.type):
                ref = DICTIONARY_SERVICE.coding(
                    node.handle, col, getattr(resolver, "catalogs", None)
                )
                if ref is not None:
                    out[sym.name] = ref
        return out
    if name == "ProjectNode":
        src = _coding(node.source, resolver)
        out = {}
        for sym, e in node.assignments:
            if isinstance(e, SymbolRef) and e.name in src:
                out[sym.name] = src[e.name]
        return out
    if name == "AggregationNode":
        src = _coding(node.source, resolver)
        gnames = {s.name for s in node.group_symbols}
        return {n: ref for n, ref in src.items() if n in gnames}
    # everything else (filters, exchanges, joins, sorts, ...): the union of
    # the children's claims — plan symbol names are unique, and these nodes
    # pass key columns through without re-coding.  Fragment boundaries
    # (RemoteSourceNode, no children) claim nothing.
    out = {}
    for c in node.children:
        out.update(_coding(c, resolver))
    return out


def align_through_criteria(placements, criteria, left_side: bool,
                           coding=None):
    """First placement tuple expressible entirely in `criteria` keys of the
    given side, with its opposite-side image: -> (own tuple of Symbols,
    other tuple of Symbols) or None.  Used to co-partition a join: if one
    side is already placed on (a subset of) its keys, the other side only
    needs repartitioning on the ALIGNED opposite keys to co-locate."""
    usable = hash_aligned_criteria(criteria, coding)
    if left_side:
        own = {l.name: (l, r) for l, r in usable}
    else:
        own = {r.name: (r, l) for l, r in usable}
    for t in placements:
        if t and all(n in own for n in t):
            return (
                tuple(own[n][0] for n in t),
                tuple(own[n][1] for n in t),
            )
    return None
