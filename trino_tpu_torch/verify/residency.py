"""Kernel/SPMD verifier: device-residency and step-cache contracts as
assertable facts.

Port of trino_tpu/verify/residency.py.  The mesh keeps fragment chains on
the card and caches every built per-worker step in `spmd.TRACE_CACHE`;
this module turns the counters that show it into contracts:

  * `device_residency(runner, sql)` replays a query on a warmed mesh and
    raises `ResidencyViolation` if a distributed fragment chain performs an
    unexpected host transfer (a host batch re-entering the mesh mid-query),
    if the warm run builds a step, or if its collectives differ from the
    recorded signature and the licensed schedule;
  * `cache_key_audit()` wraps `spmd.TRACE_CACHE` and checks cache-key
    completeness: the step closure's free variables are fingerprinted and
    hashed against the declared cache key — two different closures arriving
    under one key means the key under-describes the step (the class of bug
    that silently serves a stale step, e.g. a dynamic-filter range baked
    into a step but missing from its key).

Torch runs eagerly, so nothing retraces and `retraces` stays 0
(parallel/spmd.py).  The warm contract therefore also requires
`trace_misses == 0`: a warm replay that builds a step means a key missed
the step's shape or semantic state.  Tensors in a closure are fingerprinted
by shape, dtype and device, and small ones by content (after `.cpu()`).
"""

from __future__ import annotations

import hashlib
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from trino_tpu_torch.parallel.spmd import TRACE_CACHE


class ResidencyViolation(Exception):
    """A device-residency or step-cache contract failed."""


class CacheKeyViolation(ResidencyViolation):
    """Two distinct step closures arrived under one step-cache key."""


# -- closure fingerprinting ---------------------------------------------------

_MAX_DEPTH = 5
_MAX_SEQ = 64
_MAX_ARRAY_BYTES = 1 << 16


def _array_fp(v) -> tuple:
    """A tensor or numpy array: shape, dtype (and a tensor's device), plus a
    digest of its bytes when it is small."""
    shape = tuple(v.shape)
    if torch.is_tensor(v):
        meta = ("tensor", shape, str(v.dtype), str(v.device))
        nbytes = v.numel() * v.element_size()
        if nbytes <= _MAX_ARRAY_BYTES:
            data = v.detach().cpu().contiguous().numpy().tobytes()
            return meta + (hashlib.sha1(data).hexdigest()[:16],)
        return meta
    arr = np.asarray(v)
    meta = ("array", shape, str(arr.dtype))
    if arr.nbytes <= _MAX_ARRAY_BYTES:
        return meta + (hashlib.sha1(arr.tobytes()).hexdigest()[:16],)
    return meta


def _value_fp(v, depth: int) -> tuple:
    """Semantic fingerprint of one closure constant.  Primitives by value
    (the dynamic-filter-range class of key bugs), arrays by content hash
    when small, callables recursively, expressions by their structural
    key (a filter step's predicate, with the ranges baked into it), other
    opaque objects by type name only — an operator instance's semantics
    are expected to live in the key already, and object identity would
    only produce false positives."""
    from trino_tpu_torch.expr.ir import Expr

    if depth > _MAX_DEPTH:
        return ("depth",)
    if isinstance(v, Expr):
        return ("expr", v.key())
    if v is None or isinstance(v, (bool, int, str, bytes)):
        return ("prim", v)
    if isinstance(v, float):
        return ("prim", repr(v))  # repr: NaN-stable
    if isinstance(v, (tuple, list)):
        return ("seq", type(v).__name__) + tuple(
            _value_fp(x, depth + 1) for x in v[:_MAX_SEQ]
        )
    if isinstance(v, dict):
        items = sorted(v.items(), key=lambda kv: repr(kv[0]))[:_MAX_SEQ]
        return ("map",) + tuple(
            (repr(k), _value_fp(x, depth + 1)) for k, x in items
        )
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return _array_fp(v)
    if callable(v):
        return ("fn", getattr(v, "__qualname__", type(v).__name__),
                closure_fingerprint(v, depth + 1))
    return ("obj", type(v).__name__)


def closure_fingerprint(fn, depth: int = 0) -> tuple:
    """Fingerprint of a callable's free variables (recursing through nested
    closures).  Two builders with equal fingerprints would compile
    equivalent programs for the purposes of the cache-key contract.
    Always returns a tuple of (name, value-fingerprint) pairs so
    fingerprints diff uniformly."""
    import functools

    code = getattr(fn, "__code__", None)
    if code is None:
        out = [("$type", ("prim", type(fn).__name__))]
        if isinstance(fn, functools.partial) and depth <= _MAX_DEPTH:
            out.append(("$partial.func", ("fn", getattr(fn.func, "__qualname__", ""),
                                          closure_fingerprint(fn.func, depth + 1))))
            out.append(("$partial.args", _value_fp(fn.args, depth + 1)))
            out.append(("$partial.kw", _value_fp(fn.keywords or {}, depth + 1)))
            return tuple(out)
        call = getattr(type(fn), "__call__", None)
        if (
            call is not None
            and getattr(call, "__code__", None) is not None
            and depth <= _MAX_DEPTH
        ):
            # callable object: fingerprint its __call__ closure plus its
            # instance dict (the state a builder object would bake in)
            out.append(("$call", ("fn", type(fn).__name__,
                                  closure_fingerprint(call, depth + 1))))
            inst = getattr(fn, "__dict__", None)
            if inst:
                out.append(("$self", _value_fp(inst, depth + 1)))
        return tuple(out)
    out = [("$code", (code.co_filename, code.co_firstlineno))]
    cells = getattr(fn, "__closure__", None) or ()
    for name, cell in zip(code.co_freevars, cells):
        try:
            val = cell.cell_contents
        except ValueError:  # not yet filled
            out.append((name, ("empty",)))
            continue
        out.append((name, _value_fp(val, depth)))
    defaults = getattr(fn, "__defaults__", None) or ()
    for i, d in enumerate(defaults):
        out.append((f"$default{i}", _value_fp(d, depth)))
    return tuple(out)


class CacheKeyAuditor:
    """Records key -> closure fingerprint across TRACE_CACHE traffic and
    raises when one key arrives with two different closures."""

    def __init__(self):
        self.seen: dict = {}
        self.checked = 0

    def __call__(self, key, build) -> None:
        fp = closure_fingerprint(build)
        self.checked += 1
        prev = self.seen.get(key)
        if prev is None:
            self.seen[key] = fp
            return
        if prev != fp:
            diffs = _fp_diff(prev, fp)
            raise CacheKeyViolation(
                "trace-cache key is incomplete: two step closures with "
                f"different free variables share key {key!r}; differing "
                f"free variables: {diffs}"
            )


def _fp_diff(a: tuple, b: tuple) -> list:
    try:
        da, db = dict(a), dict(b)
    except (TypeError, ValueError):  # defensive: irregular fingerprint shape
        return ["<unstructured fingerprint>"]
    names = sorted(set(da) | set(db))
    return [n for n in names if da.get(n) != db.get(n)]


@contextmanager
def cache_key_audit():
    """Enable the step-cache key-completeness audit for a scope."""
    auditor = CacheKeyAuditor()
    prev = TRACE_CACHE.audit
    TRACE_CACHE.audit = auditor
    try:
        yield auditor
    finally:
        TRACE_CACHE.audit = prev


# -- device residency ---------------------------------------------------------


def _collective_problems(runner, prof, prev_seq) -> list:
    """The warm run's per-fragment mesh-collective sequence must equal the
    previous run's (replays issue the recorded sequence) and match the
    static signature the uniformity pass enumerated at planning time."""
    problems = []
    seq = prof.collective_sequences()
    if prev_seq is not None and seq != prev_seq:
        for fid in sorted(set(seq) | set(prev_seq)):
            a, b = prev_seq.get(fid, ()), seq.get(fid, ())
            if a != b:
                problems.append(
                    f"fragment {fid} issued a different collective "
                    f"sequence on the warm run: {b} (previous run: {a})"
                )
    expected = getattr(runner, "last_collective_signature", None)
    if expected is not None:
        from trino_tpu_torch.verify.collectives import signature_problems

        problems.extend(signature_problems(expected, seq))
    # collective-schedule license (verify/schedule.py): a licensed query's
    # warm replay must issue exactly the LICENSED per-fragment schedule —
    # async pre-dispatch may reorder ACROSS independent fragments, never
    # within one, so the per-fragment witness comparison still holds.
    # The license is normally stamped from the same subplan as
    # last_collective_signature (already checked above); only compare
    # again when the two witnesses actually differ.
    lic = getattr(runner, "last_schedule_license", None)
    if lic is not None and lic.fragments != expected:
        from trino_tpu_torch.verify.collectives import signature_problems

        problems.extend(
            f"[licensed schedule] {p}"
            for p in signature_problems(lic.fragments, seq)
        )
    return problems

#: mesh-profile counters that are LEGITIMATE host boundaries: explicit
#: gathers at SINGLE-fragment/result edges, the batched dynamic-filter sync,
#: scan-cache bookkeeping, and FTE spooling.  `host_restack` is deliberately
#: absent: a host batch re-entering the mesh between distributed fragments
#: is the hidden round-trip this contract exists to catch.
ALLOWED_COUNTERS = (
    "result_gather",
    "host_gather",
    "state_gather",
    "scan_cache_hit",
    "scan_cache_miss",
    "scan_bucketize",
    "dynamic_filter_sync",
    "spool_read",
    "spool_write",
    # partitioning-aware execution: elision bookkeeping is not a transfer,
    # and the speculative join's post-hoc [W] overflow-flag read is a
    # declared tiny boundary.  `join_capacity_sync` (the speculative-off
    # blocking match-count sync) and `join_speculative_retry` are
    # deliberately ABSENT: a warm partitioned join must neither block on
    # capacities nor retry its expand.
    "exchange_elided",
    "repartition_collective",
    "join_overflow_check",
    # proof-licensed execution (verify/capacity.py + verify/schedule.py):
    # bookkeeping, not transfers — a licensed join built at its certified
    # fixed capacity, and a schedule-licensed child fragment
    # pre-dispatched eagerly
    "join_capacity_proven",
    "collective_async",
    # the port's path bookkeeping (no transfer): which aggregation path
    # ran (partial states exchanged, or one single stage per worker), a
    # group-count-licensed exchange slot, and the semi join's on-device
    # all-gather of its filtering side
    "agg_partial_states",
    "agg_single_stage",
    "agg_slot_cap_proven",
    "broadcast",
)


def device_residency(
    runner,
    sql: str,
    warmups: int = 1,
    allowed_counters: tuple = ALLOWED_COUNTERS,
    audit_cache_keys: bool = True,
    check_collectives: bool = True,
) -> dict:
    """Replay `sql` on a warmed mesh and assert the device-residency
    contracts of the distributed pipeline:

      * zero retraces and zero step builds — every per-worker step came
        out of the step cache (a warm build means a cache key misses
        shape or semantic state);
      * zero unexpected host transfers — no counter outside
        `allowed_counters` fires, in particular `host_restack` (a host
        batch re-entering the mesh between distributed fragments);
      * collective-sequence stability — the warm run issues exactly the
        per-fragment mesh-collective sequence the previous run issued AND
        the sequence the static uniformity pass recorded
        (`runner.last_collective_signature`, verify/collectives.py): an
        extra, missing, or reordered collective on a warm replay is a
        divergence hazard even when nothing hung this time;
      * (optional) cache-key completeness over the replay's cache traffic.

    Returns a report dict on success; raises ResidencyViolation on failure.
    `runner` is a DistributedQueryRunner (anything with .execute and
    .last_mesh_profile).
    """
    auditor: Optional[CacheKeyAuditor] = None
    ctx = cache_key_audit() if audit_cache_keys else None
    prev_seq = None
    try:
        if ctx is not None:
            auditor = ctx.__enter__()
        for _ in range(max(0, warmups)):
            runner.execute(sql)
            prev = getattr(runner, "last_mesh_profile", None)
            if prev is not None:
                prev_seq = prev.collective_sequences()
        runner.execute(sql)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    prof = runner.last_mesh_profile
    if prof is None:
        raise ResidencyViolation(
            "query produced no mesh profile — not a distributed execution"
        )
    problems = []
    if prof.retraces:
        problems.append(
            f"warm execution retraced {prof.retraces} step(s) "
            "(a step-cache key misses shape or semantic state)"
        )
    if prof.trace_misses:
        problems.append(
            f"warm execution built {prof.trace_misses} step(s) "
            "(a step-cache key misses shape or semantic state)"
        )
    for name, n in sorted(prof.counters.items()):
        if n and name not in allowed_counters:
            problems.append(
                f"unexpected host transfer: counter '{name}' fired {n}x "
                "on the warm run"
            )
    if check_collectives:
        problems.extend(_collective_problems(runner, prof, prev_seq))
    if problems:
        raise ResidencyViolation(
            f"device residency violated for {sql!r}: " + "; ".join(problems)
        )
    # telemetry contract: the report records whether span tracing was live
    # during the verified replay — a residency pass with tracing_enabled
    # proves the tracer added no host syncs (spans time host wall only)
    props = getattr(runner, "properties", None)
    tracing = bool(props is not None and props.get("query_trace"))
    trace = getattr(runner, "last_trace", None)
    return {
        "sql": sql,
        "retraces": prof.retraces,
        "trace_hits": prof.trace_hits,
        "trace_misses": prof.trace_misses,
        "counters": dict(prof.counters),
        "cache_keys_checked": auditor.checked if auditor else 0,
        "tracing_enabled": tracing,
        "spans": len(trace["traceEvents"]) if (tracing and trace) else 0,
    }
