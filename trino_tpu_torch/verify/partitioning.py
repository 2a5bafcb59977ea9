"""Partitioning invariants for exchange-placed plans.

The exchange placer may ELIDE a repartition when property derivation says
the data is already placed (bucketed layout or upstream exchange).  These
checks re-derive the properties independently and fail the plan when a
node claims a placement nothing produces — the class of bug where an
elided exchange silently turns a distributed join into a per-shard join of
mis-placed rows (wrong results, no crash).

Rules:

  * partitioning-unproduced — a JoinNode with distribution 'colocated'
    whose sides do NOT share an aligned derived placement;
  * partitioning-misaligned — a partitioned JoinNode where one side is a
    repartition exchange but the other side is neither an exchange nor
    placed on keys aligned with that exchange's partition symbols.
"""

from __future__ import annotations

from trino_tpu_torch.planner import plan as P
from trino_tpu_torch.verify.plan_checker import PlanViolation


def _violation(rule: str, node, message: str) -> PlanViolation:
    return PlanViolation(rule, node, message)


def _is_repartition(node) -> bool:
    return (
        isinstance(node, P.ExchangeNode) and node.kind == "repartition"
    ) or (
        hasattr(node, "exchange_kind") and node.exchange_kind == "repartition"
    )


def _aligned(placements, criteria, left_side: bool, coding=None):
    """Placement tuples of one side expressible in its join keys, with the
    opposite-side image: -> list of (own names, other names).  Only
    dictionary-independent keys count — integer kinds, plus string pairs
    whose two sides share one versioned GLOBAL dictionary assignment
    (`coding`) — the same restriction the placer applies, so a colocated
    claim on producer-local string keys is flagged."""
    from trino_tpu_torch.partitioning import hash_aligned_criteria

    usable = hash_aligned_criteria(criteria, coding)
    if left_side:
        m = {l.name: r.name for l, r in usable}
    else:
        m = {r.name: l.name for l, r in usable}
    out = []
    for t in placements:
        if t and all(n in m for n in t):
            out.append((t, tuple(m[n] for n in t)))
    return out


def check_partitioning(root: P.PlanNode, resolver, n_workers: int) -> list:
    from trino_tpu_torch.partitioning import (
        derive_dictionary_coding,
        derive_partitioning,
    )

    violations: list = []
    for node in P.walk(root):
        if not isinstance(node, P.JoinNode) or not node.criteria:
            continue
        # the verifier re-derives the SAME dictionary-version gate the
        # placer used: a string-key claim passes only when both sides
        # share one (key, version) global assignment
        coding = dict(derive_dictionary_coding(node.left, resolver))
        coding.update(derive_dictionary_coding(node.right, resolver))
        if node.distribution == "colocated":
            lprops = derive_partitioning(node.left, resolver, n_workers)
            rprops = derive_partitioning(node.right, resolver, n_workers)
            pairs = _aligned(lprops, node.criteria, True, coding)
            if not any(other in rprops for _, other in pairs):
                violations.append(
                    _violation(
                        "partitioning-unproduced", node,
                        "join claims colocated but no aligned placement is "
                        f"produced by both sides (left={lprops}, "
                        f"right={rprops})",
                    )
                )
        elif node.distribution == "partitioned":
            l_ex = _is_repartition(node.left)
            r_ex = _is_repartition(node.right)
            if l_ex and r_ex:
                continue
            if not l_ex and not r_ex:
                violations.append(
                    _violation(
                        "partitioning-unproduced", node,
                        "partitioned join has no repartition exchange on "
                        "either side and does not claim colocated",
                    )
                )
                continue
            placed, ex_side = (
                (node.left, node.right) if r_ex else (node.right, node.left)
            )
            props = derive_partitioning(placed, resolver, n_workers)
            pairs = _aligned(props, node.criteria, r_ex, coding)
            ex_names = tuple(
                s.name for s in getattr(ex_side, "partition_symbols", ())
            )
            if not any(other == ex_names for _, other in pairs):
                violations.append(
                    _violation(
                        "partitioning-misaligned", node,
                        "one join side skips its repartition but holds no "
                        f"placement aligned with the exchange keys "
                        f"{ex_names} (placements={props})",
                    )
                )
    return violations
