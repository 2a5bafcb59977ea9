"""Speculative join output capacity (Spark-AQE-style guess-and-retry).

The pre-PR distributed join blocked the accelerator on a host sync of the
per-probe-row match counts to size the expand program's static output
capacity.  Speculative execution replaces the sync: pick a pow2 `out_cap`
from history (or a conservative cold guess), run the fused locate+expand
program with the per-worker emitted total and an on-device overflow flag in
its outputs, and only if some worker overflowed, retry at the exact pow2
bucket of the observed totals.  The host never reads match counts before
dispatching the join; the post-hoc flag read is a tiny [W] transfer that
overlaps completed device work.

`CapacityHistory` remembers the last good capacity per join fingerprint, so
a warm query replays at the right bucket with zero retries (asserted by
`verify.device_residency` over the partitioned-join path).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from trino_tpu_torch.ops.common import next_pow2

#: smallest speculative bucket (matches the old host-sync path's floor)
CAP_FLOOR = 1024


class CapacityHistory:
    """join fingerprint -> last good pow2 out_cap (process-wide, bounded).

    `version` bumps only when a record CHANGES the mapping (new key or new
    cap), so callers can tell "this run LEARNED a capacity" apart from the
    warm path's re-record of the same value — the signal
    tools/prewarm_manifest.py uses to treat capacity learning as part of
    the cold phase.  `snapshot`/`seed` serialize the history through the
    prewarm manifest: a restarted (or prewarming) process seeds the learned
    caps so its FIRST run takes the fused speculative path at the right
    bucket instead of re-learning — the Q3 fused_expand recompile PR 6
    flagged."""

    def __init__(self, limit: int = 1024):
        self.limit = limit
        self._caps: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        #: bumped on every mapping CHANGE (never on a same-value re-record)
        self.version = 0

    def guess(self, key, default: int) -> int:
        with self._lock:
            cap = self._caps.get(key)
            if cap is not None:
                self._caps.move_to_end(key)
                return cap
        return default

    def record(self, key, cap: int) -> None:
        with self._lock:
            if self._caps.get(key) != cap:
                self.version += 1
            self._caps[key] = cap
            self._caps.move_to_end(key)
            while len(self._caps) > self.limit:
                self._caps.popitem(last=False)

    def snapshot(self) -> list:
        """JSON-serializable [{key, cap}] (keys as reprs — they are tuples
        of strings/ints by construction, so `seed` can literal_eval them)."""
        with self._lock:
            return [
                {"key": repr(k), "cap": int(v)} for k, v in self._caps.items()
            ]

    def seed(self, entries) -> int:
        """Restore entries from a `snapshot()` (e.g. a prewarm manifest's
        cap_history section); returns how many were installed.  Entries
        whose key repr does not literal_eval (a future key shape) are
        skipped — seeding is an optimization, never a correctness
        dependency."""
        import ast

        n = 0
        for e in entries or ():
            try:
                key = ast.literal_eval(e["key"])
                cap = int(e["cap"])
            except (KeyError, TypeError, ValueError, SyntaxError):
                continue
            self.record(key, cap)
            n += 1
        return n

    def clear(self) -> None:
        with self._lock:
            self._caps.clear()
            self.version += 1


#: the process-wide history (cleared only by tests)
CAP_HISTORY = CapacityHistory()


def speculation_mode(properties):
    """Parse the `join_speculative_capacity` session property:
    -> None (off) | 0 (on, auto initial cap) | pow2 int (initial-cap
    override)."""
    try:
        raw = str(properties.get("join_speculative_capacity")).strip().lower()
    except KeyError:  # older property sets
        return 0
    if raw in ("off", "false", "no", "0"):
        return None
    if raw in ("on", "true", "yes", ""):
        return 0
    try:
        return next_pow2(max(1, int(raw)), floor=1)
    except ValueError:
        raise ValueError(
            f"join_speculative_capacity must be on|off|<initial cap>, got {raw!r}"
        )


def initial_cap(history_key, override: int):
    """Speculative capacity to launch at: the recorded history (tight —
    the exact bucket the cold sizing pass measured), else the session
    override.  Returns None when neither exists: the caller runs the cold
    sizing pass (one tiny [W] totals read) instead of speculating on a
    guess — a wrong guess either overflows (retry) or, worse, silently
    oversizes the expand and every downstream static shape."""
    cap = CAP_HISTORY.guess(history_key, 0)
    if cap:
        return cap
    return override or None


def next_cap(observed_total: int, current: int) -> int:
    """Retry bucket after an overflow at `current`."""
    return max(next_pow2(max(1, observed_total), floor=CAP_FLOOR), current * 2)
