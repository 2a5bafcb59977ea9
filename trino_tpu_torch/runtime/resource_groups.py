"""Resource groups: admission control and fair queuing.

Reference: execution/resourcegroups/InternalResourceGroup.java +
InternalResourceGroupManager.java — queries are admitted into a tree of
groups, each with hard concurrency and queue limits; queued queries start
as running ones finish.

Engine mapping: the scarce resource is the device, so `hard_concurrency`
bounds concurrent engine executions per group and `max_queued` bounds the
backlog.  A selector picks the group by user/source (the resource-group
manager plugin's role, reduced to prefix rules).

Extensions toward the airlift analog:

  * ``weight`` — the group's share under the dispatcher's weighted-fair
    scheduler (runtime/dispatcher.QueryDispatcher picks the next eligible
    group by weighted virtual time, not FIFO across groups);
  * ``memory_limit_bytes`` — a per-group sub-pool of the shared
    MemoryContext tree (`ResourceGroup.memory_context`): queries admitted
    through the group reserve under the group node, so a group at its
    limit degrades through the revoke -> wave -> kill ladder WITHIN the
    group (`GroupMemoryEscalation`) and can never kill a bystander
    group's query;
  * a properties-file format (`ResourceGroupManager.from_properties`):
    ``resource-groups.<name>.max-concurrency|max-queued|weight|
    memory-limit-bytes`` plus ``resource-groups.user.<user>=<name>``
    selector rules (the resource-group configuration manager's role).

Port of trino_tpu/runtime/resource_groups.py: a copy, with the package renamed.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

#: the dispatcher-owned group prewarm replays admit through (weight-capped
#: so a post-grow replay cannot starve live user queries, where holding
#: the engine lock outright would)
SYSTEM_PREWARM_GROUP = "system.prewarm"


class QueryQueueFullError(RuntimeError):
    """Reference: QUERY_QUEUE_FULL error code."""


@dataclass
class ResourceGroupConfig:
    name: str
    hard_concurrency: int = 1
    max_queued: int = 100
    #: weighted-fair share under the dispatcher (admissions of a saturated
    #: group pair with weights w1:w2 converge to the w1:w2 ratio)
    weight: int = 1
    #: per-group memory sub-pool limit (0 = no group limit): wired as a
    #: child of the shared pool root by ResourceGroup.memory_context
    memory_limit_bytes: int = 0


class ResourceGroup:
    def __init__(self, config: ResourceGroupConfig):
        self.config = config
        self.running = 0
        self.queued: deque = deque()
        self.lock = threading.Lock()
        #: peak/telemetry counters (system.runtime-style observability)
        self.total_admitted = 0
        self.total_queued = 0
        #: the group's memory sub-pool (memory_context()); binding is
        #: created once and immutable after — readers need no lock
        self._memory = None
        #: dispatcher hook: called (outside the group lock) whenever a
        #: slot may have freed, so a LEGACY release() also wakes tickets
        #: waiting in the dispatcher's weighted-fair queue — without it a
        #: dispatcher ticket queued behind a dbapi-held slot would wait
        #: until some unrelated dispatcher event happened to fire
        self.on_slot_freed = None

    def memory_context(self, pool_root):
        """The group's sub-pool node under the shared pool root (created
        once, on first use): queries admitted through this group reserve
        under it, so `memory_limit_bytes` bounds the GROUP's total and a
        breach escalates within the group only (GroupMemoryEscalation).
        Returns None when the group declares no memory limit — unlimited
        groups reserve directly on the pool root, exactly as before."""
        if not self.config.memory_limit_bytes:
            return None
        with self.lock:
            if self._memory is None:
                ctx = pool_root.child(f"group:{self.config.name}")
                ctx.limit_bytes = int(self.config.memory_limit_bytes)
                ctx.on_exceeded = GroupMemoryEscalation(self.config.name)
                self._memory = ctx
            return self._memory

    def try_acquire_now(self) -> bool:
        """Non-blocking admission (the dispatcher's slot grab): True when a
        concurrency slot was taken.  Shares the `running` counter with the
        blocking acquire() path, so legacy holders (dbapi, direct tests)
        and dispatcher admissions see one consistent limit."""
        with self.lock:
            if self.running < self.config.hard_concurrency:
                self.running += 1
                self.total_admitted += 1
                return True
            return False

    def has_slot(self) -> bool:
        with self.lock:
            return self.running < self.config.hard_concurrency

    def acquire(self, timeout: Optional[float] = None) -> None:
        """Block until admitted; raise QueryQueueFullError when the queue
        is at max_queued (reference: InternalResourceGroup.run).  A timeout
        ALWAYS raises TimeoutError: when the wait expires but release() has
        already signaled our gate (the timeout/grant race), the granted slot
        is handed to the next waiter under the lock instead of being
        swallowed by a caller that has given up — a leaked slot there
        permanently shrinks the group's effective concurrency."""
        gate = None
        with self.lock:
            if self.running < self.config.hard_concurrency:
                self.running += 1
                self.total_admitted += 1
                return
            if len(self.queued) >= self.config.max_queued:
                raise QueryQueueFullError(
                    f"resource group {self.config.name} queue is full "
                    f"({self.config.max_queued})"
                )
            gate = self._make_gate()
            self.queued.append(gate)
            self.total_queued += 1
        if not gate.wait(timeout=timeout):
            with self.lock:
                try:
                    self.queued.remove(gate)
                except ValueError:
                    # raced with release(): the slot was granted to us after
                    # we timed out — pass it on, we are no longer waiting
                    self.total_admitted -= 1  # the grant never ran
                    self._hand_off_locked()
            self._notify_slot_freed()
            raise TimeoutError(
                f"queued in resource group {self.config.name} past timeout"
            )

    def _make_gate(self) -> threading.Event:
        """Seam for the timeout/grant race regression test (a gate whose
        wait() deterministically 'times out' after release() signals it)."""
        return threading.Event()

    def _hand_off_locked(self) -> None:  # lint: allow(unguarded-state)
        """Transfer one held slot onward (caller holds self.lock): wake the
        next waiter, or return the slot to the pool when nobody waits."""
        if self.queued:
            gate = self.queued.popleft()
            self.total_admitted += 1
            gate.set()
        else:
            self.running = max(0, self.running - 1)

    def release(self) -> None:
        with self.lock:
            self._hand_off_locked()
        self._notify_slot_freed()

    def _notify_slot_freed(self) -> None:
        """Run the dispatcher's scheduling kick (if attached) OUTSIDE the
        group lock — the dispatcher takes its own lock first, then this
        group's, and inverting that order here would be a deadlock."""
        cb = self.on_slot_freed
        if cb is not None:
            cb()

    def stats(self) -> dict:
        with self.lock:
            mem = self._memory
            return {
                "name": self.config.name,
                "running": self.running,
                "queued": len(self.queued),
                "hard_concurrency": self.config.hard_concurrency,
                "max_queued": self.config.max_queued,
                "weight": self.config.weight,
                "memory_limit_bytes": self.config.memory_limit_bytes,
                "memory_reserved_bytes": (
                    int(mem.reserved) if mem is not None else 0
                ),
                "total_admitted": self.total_admitted,
                "total_queued": self.total_queued,
            }


class GroupMemoryEscalation:
    """Per-group `on_exceeded` hook (installed on the group's sub-pool
    node): when a GROUP limit blocks a reservation, degrade strictly
    within the group — revoke the largest wave-capable operator whose
    memory lives under this group, then kill the group's own largest
    query — and NEVER touch a bystander group (the pool-root hook's
    cluster-wide largest-victim choice does not apply to group limits).
    Returning False propagates the exception to the requester, whose
    partition-wave fallback already plans against the group limit
    (spill.effective_budget walks the ancestor chain)."""

    def __init__(self, group_name: str):
        self.group_name = group_name
        #: (requesting group, victim query name) log — the chaos suite's
        #: zero-cross-group-kill witness
        self.kill_log: list = []

    @staticmethod
    def _under(ctx, group_node) -> bool:
        node = ctx
        while node is not None:
            if node is group_node:
                return True
            node = node.parent
        return False

    def __call__(self, group_node, requesting, delta: int) -> bool:
        from trino_tpu_torch.runtime.spill import REVOCABLES

        # revoke tier, group-scoped: largest registered revocable whose
        # reservation lives under this group spills + releases
        for h in sorted(
            REVOCABLES.live(), key=lambda e: e.reserved_bytes(), reverse=True
        ):
            if h.ctx is None or not self._under(h.ctx, group_node):
                continue
            if h.revoke() > 0:
                from trino_tpu_torch.telemetry.metrics import (
                    memory_revocations_counter,
                )

                memory_revocations_counter().inc()
                return True
        # kill tier, group-scoped: same largest-victim semantics as the
        # LowMemoryKiller, candidates restricted to THIS group's queries
        req_query = requesting.query_root()
        candidates = [
            q
            for q in getattr(group_node, "query_children", ())
            if q.reserved > 0
        ]
        if not candidates:
            return False
        victim = max(candidates, key=lambda q: q.reserved)
        if victim is req_query:
            # the requester holds the group's largest reservation: failing
            # its reservation IS the kill (degrades to waves, never shoots
            # a smaller in-group bystander, never ANY out-of-group query)
            return False
        from trino_tpu_torch.telemetry.metrics import memory_kills_counter

        memory_kills_counter().inc()
        self.kill_log.append((self.group_name, victim.name))
        owner = getattr(victim, "owner", None)
        if owner is not None:
            owner.kill(
                "memory",
                detail=(
                    f"killed by resource group '{self.group_name}' memory "
                    f"limit: largest in-group reservation "
                    f"({victim.reserved} bytes) when {requesting.name} "
                    f"requested {delta} more"
                ),
            )
        victim.force_release()
        return True


#: resource-groups properties-file knob names -> ResourceGroupConfig field
_GROUP_KNOBS = {
    "max-concurrency": ("hard_concurrency", int),
    "hard-concurrency": ("hard_concurrency", int),
    "max-queued": ("max_queued", int),
    "weight": ("weight", int),
    "memory-limit-bytes": ("memory_limit_bytes", int),
}

_RG_PREFIX = "resource-groups."


class ResourceGroupManager:
    """Selector + group registry (InternalResourceGroupManager role).
    Selection: exact user match first, then the default group."""

    def __init__(self, default: Optional[ResourceGroupConfig] = None):
        self.groups: dict[str, ResourceGroup] = {}
        self.default = self.add(
            default or ResourceGroupConfig("global", hard_concurrency=1)
        )
        self._user_rules: dict[str, str] = {}

    @classmethod
    def from_properties(cls, props: Optional[dict] = None) -> "ResourceGroupManager":
        """Build a manager from ``resource-groups.*`` properties (the
        resource-group configuration manager's file format)::

            resource-groups.global.max-concurrency=4
            resource-groups.etl.weight=2
            resource-groups.etl.max-queued=16
            resource-groups.etl.memory-limit-bytes=268435456
            resource-groups.user.batch=etl

        Unknown knob names raise (a typo must not silently become an
        unlimited group); ``global`` stays the default selector target."""
        configs: dict[str, dict] = {}
        rules: dict[str, str] = {}
        for k, v in (props or {}).items():
            if not k.startswith(_RG_PREFIX):
                continue
            rest = k[len(_RG_PREFIX):]
            if rest.startswith("user."):
                rules[rest[len("user."):]] = str(v).strip()
                continue
            if "." not in rest:
                raise ValueError(f"malformed resource-group key: {k!r}")
            name, knob = rest.rsplit(".", 1)
            if knob not in _GROUP_KNOBS:
                raise ValueError(
                    f"unknown resource-group knob {knob!r} in {k!r} "
                    f"(supported: {sorted(_GROUP_KNOBS)})"
                )
            field_name, typ = _GROUP_KNOBS[knob]
            configs.setdefault(name, {})[field_name] = typ(v)
        mgr = cls(
            ResourceGroupConfig("global", **configs.pop("global", {}))
        )
        for name, kw in sorted(configs.items()):
            mgr.add(ResourceGroupConfig(name, **kw))
        for user, group in rules.items():
            if group not in mgr.groups:
                raise ValueError(
                    f"resource-groups.user.{user} names unknown group "
                    f"{group!r}"
                )
            mgr.add_user_rule(user, group)
        return mgr

    def add(self, config: ResourceGroupConfig) -> ResourceGroup:
        g = ResourceGroup(config)
        self.groups[config.name] = g
        return g

    def ensure(self, config: ResourceGroupConfig) -> ResourceGroup:
        """The group, creating it from `config` when absent (the
        dispatcher's system.prewarm bootstrap)."""
        g = self.groups.get(config.name)
        return g if g is not None else self.add(config)

    def add_user_rule(self, user: str, group_name: str) -> None:
        self._user_rules[user] = group_name

    def select(self, user: Optional[str] = None) -> ResourceGroup:
        if user is not None and user in self._user_rules:
            return self.groups[self._user_rules[user]]
        return self.default

    def stats(self) -> list:
        return [g.stats() for g in self.groups.values()]
