"""Typed engine configuration: the dispatcher, memory, profile, audit and
coordinator sections.

Port of part of trino_tpu/config.py (the airlift ``@Config`` analog).
Each field carries its properties key; a knob resolves, first hit wins,
from the environment (``TRINO_TPU_<KEY>`` with ``.``/``-`` -> ``_``,
uppercased), the properties dict, then the dataclass default.

Ported: the ``dispatcher`` section (runtime/dispatcher.py's lanes,
Retry-After and drain waits), ``memory`` (``memory.pool-limit-bytes``,
``memory.spill-dir``), ``profile`` (the profile archive,
telemetry/profile_store.py), ``audit`` (the audit log,
telemetry/audit.py) and ``coordinator`` (the result page size and long-poll
bound of server/coordinator.py), with `get_config` / `install_config` /
`reset_config` / `load_config`; installing a config with a pool limit
arms the shared memory pool's limit.  Not ported: the ``breaker``
section (the circuit breakers of the multi-host HTTP tier), the
``lifecycle`` section (its HTTP request timeouts), the JAX package's
per-worker and per-catalog overrides (``<key>@<token>``) with
`breaker_for` / `section_for`, and the sections of the other unported
pieces (heartbeat, remote, worker, compile cache, prewarm, dictionary).
`load_cluster_config` raises NotImplementedError naming the piece for a
``breaker.`` or ``lifecycle.`` key or an override, and `breaker_for` /
`section_for` raise; runtime/config.py raises for the knobs of the other pieces when
an etc/ directory sets them.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field, fields
from typing import Optional

ENV_PREFIX = "TRINO_TPU_"


def knob(default, key: str, help: str = ""):
    """A config field bound to a properties key (the ``@Config`` marker)."""
    return field(default=default, metadata={"key": key, "help": help})


def _env_name(key: str) -> str:
    return ENV_PREFIX + key.upper().replace(".", "_").replace("-", "_")


def _coerce(value: str, typ: type):
    if typ is bool:
        low = str(value).strip().lower()
        if low in ("true", "yes", "on", "1"):
            return True
        if low in ("false", "no", "off", "0"):
            return False
        raise ValueError(f"not a boolean: {value!r}")
    return typ(value)


class ConfigSection:
    """Base for typed config dataclasses: `from_properties` resolves every
    `knob()` field through env > properties > default."""

    @classmethod
    def from_properties(cls, props: Optional[dict] = None, env=None):
        props = props or {}
        env = os.environ if env is None else env
        values = {}
        for f in fields(cls):
            key = f.metadata.get("key")
            if key is None:
                continue
            typ = type(f.default)
            raw = env.get(_env_name(key))
            if raw is None:
                raw = props.get(key)
            if raw is None:
                continue
            try:
                values[f.name] = _coerce(raw, typ)
            except (TypeError, ValueError) as e:
                raise ValueError(
                    f"bad value for config key {key!r}: {raw!r}"
                ) from e
        return cls(**values)

    def describe(self) -> list:
        """[(properties key, value, help)] — the config's SQL/debug view."""
        out = []
        for f in fields(self):
            key = f.metadata.get("key")
            if key is not None:
                out.append((key, getattr(self, f.name), f.metadata.get("help", "")))
        return out


# -- sections ------------------------------------------------------------------


@dataclass
class DispatcherConfig(ConfigSection):
    """Concurrent query dispatcher (runtime/dispatcher.QueryDispatcher):
    admission control, weighted-fair resource groups, load shedding."""

    lanes: int = knob(
        4, "dispatcher.lanes",
        "engine lanes (concurrent query executions) the dispatcher "
        "interleaves onto the device; runners that cannot be cloned "
        "(multi-host) are clamped to 1",
    )
    retry_after_s: float = knob(
        1.0, "dispatcher.retry-after",
        "Retry-After seconds a shed statement (HTTP 429: resource-group "
        "queue full) advertises to clients",
    )
    drain_wait_s: float = knob(
        30.0, "dispatcher.drain-wait",
        "seconds a dispatcher drain waits for running queries before "
        "force-killing them through their lifecycle tokens",
    )
    drain_grace_s: float = knob(
        5.0, "dispatcher.drain-grace",
        "seconds a drain waits AFTER force-kill for the canceled queries "
        "to reach their next cooperative check and release their lanes",
    )


@dataclass
class MemoryConfig(ConfigSection):
    """Shared-pool memory knobs (runtime/lifecycle LowMemoryKiller)."""

    pool_limit_bytes: int = knob(
        0, "memory.pool-limit-bytes",
        "shared device-memory pool limit arming the revoke -> kill "
        "escalation (0 = unlimited)",
    )
    spill_dir: str = knob(
        "", "memory.spill-dir",
        "directory for partition-wave spill files (filesystem SPI; "
        "empty = a per-process temp directory)",
    )


@dataclass
class ProfileConfig(ConfigSection):
    """Query performance observatory: the persistent per-query profile
    archive (telemetry/profile_store.ProfileStore).  At completion every
    statement's profile — phases, per-fragment stats, collective bytes,
    compile events, admission info, gate wait, peak memory — is assembled
    into ONE structured artifact and persisted through the filesystem SPI
    off the hot path, so regressions can be *diffed* (tools/profile_diff)
    instead of re-measured from memory of last week's numbers."""

    archive_dir: str = knob(
        "", "profile.archive-dir",
        "profile-artifact archive location (filesystem SPI; empty = "
        "in-memory ring only when a store is attached, nothing otherwise)",
    )
    retention_max_age_s: float = knob(
        0.0, "profile.retention-max-age",
        "seconds an archived artifact is retained before the sweep "
        "deletes it (0 = keep forever)",
    )
    retention_max_count: int = knob(
        0, "profile.retention-max-count",
        "archived artifacts retained on disk, oldest pruned first "
        "(0 = unbounded)",
    )
    ring_limit: int = knob(
        256, "profile.ring-limit",
        "recent artifacts held in memory (the system.runtime."
        "query_profiles window; archived files are not bounded by this)",
    )


@dataclass
class AuditConfig(ConfigSection):
    """Structured JSONL query audit log (telemetry/audit.QueryAuditLog):
    one line per QueryCompletedEvent through the filesystem SPI, with
    size-based rotation — the machine-readable trail an external audit
    pipeline tails (reference role: http/kafka event listeners)."""

    log_path: str = knob(
        "", "audit.log-path",
        "audit log location (filesystem SPI; empty = audit log off)",
    )
    rotate_bytes: int = knob(
        64 * 1024 * 1024, "audit.rotate-bytes",
        "rotate the audit log when it would exceed this size "
        "(0 = never rotate)",
    )
    rotate_keep: int = knob(
        2, "audit.rotate-keep",
        "rotated audit segments kept (<path>.1 .. <path>.N, newest first)",
    )


@dataclass
class CoordinatorConfig(ConfigSection):
    """Coordinator protocol knobs (server/coordinator.py)."""

    result_page_rows: int = knob(
        4096, "coordinator.result-page-rows",
        "rows per paged statement response",
    )
    poll_wait_s: float = knob(
        1.0, "coordinator.poll-wait",
        "statement/trace long-poll bound",
    )


@dataclass
class ClusterConfig:
    """The ported sections plus the raw properties."""

    dispatcher: DispatcherConfig = field(default_factory=DispatcherConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    audit: AuditConfig = field(default_factory=AuditConfig)
    coordinator: CoordinatorConfig = field(default_factory=CoordinatorConfig)
    properties: dict = field(default_factory=dict)

    def breaker_for(self, worker: str):
        raise NotImplementedError(
            "breaker_for: circuit breakers (the multi-host HTTP tier): not ported yet"
        )

    def section_for(self, section: str, worker: Optional[str] = None,
                    catalog: Optional[str] = None):
        raise NotImplementedError(
            "section_for: per-worker and per-catalog overrides: not ported yet"
        )


#: config.properties key prefixes of sections that are not ported, and the
#: piece each configures
UNPORTED_SECTIONS = (
    ("breaker.", "circuit breakers (the multi-host HTTP tier)"),
    ("lifecycle.", "HTTP request timeouts (the multi-host HTTP tier)"),
)


def load_cluster_config(props: Optional[dict] = None, env=None) -> ClusterConfig:
    """Build a ClusterConfig from a properties dict (e.g. the parsed
    ``etc/config.properties``) + environment overrides."""
    props = dict(props or {})
    env = os.environ if env is None else env
    for key in props:
        for prefix, piece in UNPORTED_SECTIONS:
            if key.startswith(prefix):
                raise NotImplementedError(f"{key} ({piece}): not ported yet")
        if "@" in key:
            raise NotImplementedError(
                f"{key} (per-worker and per-catalog overrides): not ported yet"
            )
    return ClusterConfig(
        dispatcher=DispatcherConfig.from_properties(props, env),
        memory=MemoryConfig.from_properties(props, env),
        profile=ProfileConfig.from_properties(props, env),
        audit=AuditConfig.from_properties(props, env),
        coordinator=CoordinatorConfig.from_properties(props, env),
        properties=props,
    )


def load_config(path: Optional[str] = None, props: Optional[dict] = None,
                env=None) -> ClusterConfig:
    """Load + install the process config from a .properties file path or a
    dict; returns the installed ClusterConfig."""
    if path is not None:
        from trino_tpu_torch.runtime.config import load_properties

        props = load_properties(path)
    cfg = load_cluster_config(props, env)
    install_config(cfg)
    return cfg


_LOCK = threading.Lock()
_CURRENT = ClusterConfig()


def get_config() -> ClusterConfig:
    """The installed process configuration (defaults when none loaded)."""
    return _CURRENT


def install_config(cfg: ClusterConfig) -> None:
    """Install `cfg` process-wide; a memory pool limit takes effect now."""
    global _CURRENT
    with _LOCK:
        _CURRENT = cfg
    if cfg.memory.pool_limit_bytes:
        from trino_tpu_torch.runtime.lifecycle import set_memory_pool_limit

        set_memory_pool_limit(cfg.memory.pool_limit_bytes)


def reset_config() -> None:
    """Restore compiled-in defaults (tests only)."""
    global _CURRENT
    with _LOCK:
        _CURRENT = ClusterConfig()
