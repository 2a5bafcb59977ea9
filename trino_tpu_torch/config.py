"""Typed engine configuration (the airlift ``@Config`` analog).

Port of trino_tpu/config.py.  Each field carries its properties key; a
knob resolves, first hit wins, from:

  1. the environment: ``TRINO_TPU_<KEY>`` with ``.``/``-`` -> ``_`` and
     uppercased (``breaker.failure-threshold`` ->
     ``TRINO_TPU_BREAKER_FAILURE_THRESHOLD``);
  2. a per-catalog override ``<key>@<catalog>`` (the EXACT catalog name a
     resolution is scoped to);
  3. a per-worker override ``<key>@<token>``, where ``<token>`` is a
     substring of the worker id/url (``breaker.failure-threshold@8123=5``
     tunes only the worker whose url contains ``8123``);
  4. the properties dict: ``<key>=<value>``;
  5. the dataclass default.

Sections: ``breaker`` (the per-worker circuit breakers, runtime/retry.py),
``heartbeat`` (runtime/membership.HeartbeatDetector), ``lifecycle`` (the
HTTP tier's request timeouts), ``remote`` (parallel/remote.py's retry
budgets), ``worker`` (server/worker.py), ``coordinator``, ``dispatcher``,
``memory``, ``prewarm`` (runtime/prewarm's executor), ``dictionary``
(how much of runtime/dictionary_service's state a manifest inlines),
``profile`` and ``audit``, with
`get_config` / `install_config` / `reset_config` / `load_config`;
installing a config with a pool limit arms the shared memory pool's
limit.  The JAX package's ``compile-cache`` section configures XLA's
on-disk compilation cache and has no section here: its torch counterpart
is the kernel build directory (``build/trino_tpu_torch/``, where
kernels/build.py keeps each nvcc output under the hash of its source),
which already survives a restart, so a restarted process loads its
kernels without compiling them again.
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
    `knob()` field through env > per-worker override > properties > default."""

    @classmethod
    def from_properties(cls, props: Optional[dict] = None, env=None,
                        worker: Optional[str] = None,
                        catalog: Optional[str] = None):
        props = props or {}
        env = os.environ if env is None else env
        values = {}
        for f in fields(cls):
            key = f.metadata.get("key")
            if key is None:
                continue
            typ = type(f.default)
            raw = env.get(_env_name(key))
            if raw is None and catalog is not None:
                raw = props.get(f"{key}@{catalog}")
            if raw is None and worker is not None:
                raw = _worker_override(props, key, worker)
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


def _worker_override(props: dict, key: str, worker: str) -> Optional[str]:
    """``<key>@<token>`` entries whose token occurs in the worker id win
    over the base key (longest matching token wins — the most specific
    override).  Tokens are substrings because worker ids are urls and the
    properties syntax cannot carry ``:`` inside a key."""
    best = None
    best_len = -1
    prefix = key + "@"
    for k, v in props.items():
        if not k.startswith(prefix):
            continue
        token = k[len(prefix):]
        if token and token in worker and len(token) > best_len:
            best, best_len = v, len(token)
    return best


# -- sections ------------------------------------------------------------------


@dataclass
class BreakerConfig(ConfigSection):
    """Per-worker circuit breakers on the multi-host HTTP tier (the
    knobs, loadable; reference: the failure-detection half of
    HttpRemoteTask)."""

    failure_threshold: int = knob(
        3, "breaker.failure-threshold",
        "consecutive failures before a worker's breaker trips OPEN",
    )
    cooldown_s: float = knob(
        5.0, "breaker.cooldown",
        "seconds an OPEN breaker holds traffic before one half-open probe",
    )


@dataclass
class HeartbeatConfig(ConfigSection):
    """Coordinator-side heartbeat failure detection (reference:
    failuredetector/HeartbeatFailureDetector)."""

    interval_s: float = knob(
        1.0, "heartbeat.interval",
        "seconds between failure-detector probe rounds",
    )
    miss_threshold: int = knob(
        3, "heartbeat.miss-threshold",
        "consecutive missed probes before a worker is declared DEAD",
    )
    probe_timeout_s: float = knob(
        5.0, "heartbeat.probe-timeout",
        "per-probe HTTP timeout (GET /v1/info)",
    )


@dataclass
class LifecycleConfig(ConfigSection):
    """HTTP-tier timeout bounds (the lifecycle constants): every socket
    wait is additionally capped by the executing query's remaining run time
    via `lifecycle.request_timeout`."""

    request_timeout_s: float = knob(
        600.0, "lifecycle.request-timeout",
        "default per-request HTTP bound when no query deadline caps it",
    )
    submit_timeout_s: float = knob(
        60.0, "lifecycle.submit-timeout",
        "task submission POST bound (small body, worker answers fast)",
    )
    cancel_timeout_s: float = knob(
        10.0, "lifecycle.cancel-timeout",
        "best-effort task cancel DELETE bound",
    )
    probe_timeout_s: float = knob(
        5.0, "lifecycle.probe-timeout",
        "worker liveness probe bound (GET /v1/info)",
    )


@dataclass
class RemoteConfig(ConfigSection):
    """Coordinator-side remote scheduling knobs (parallel/remote.py — the
    module the no-module-level-knob lint now keeps literal-free)."""

    submit_attempts: int = knob(
        3, "remote.submit-attempts",
        "transient-submit retries against one worker before it is "
        "declared gone (REFUSED skips them)",
    )
    fetch_attempts: int = knob(
        3, "remote.fetch-attempts",
        "transient result-fetch retries against the SAME worker before "
        "task replacement",
    )
    probe_ttl_s: float = knob(
        15.0, "remote.probe-ttl",
        "seconds a cached liveness-probe verdict stays fresh",
    )
    backoff_base_s: float = knob(
        0.05, "remote.backoff-base",
        "full-jitter backoff base for submit/fetch retries",
    )
    backoff_cap_s: float = knob(
        1.0, "remote.backoff-cap",
        "full-jitter backoff ceiling for submit/fetch retries",
    )
    max_replans: int = knob(
        8, "remote.max-replans",
        "mesh-shrink re-planning attempts per query before giving up",
    )
    max_task_retries: int = knob(
        4, "remote.max-task-retries",
        "same-plan recovery attempts per query under "
        "fault_tolerant_execution (lost tasks re-run on survivors, "
        "spooled fragments resume) before classifying the mesh as shrunk "
        "below the plan's requirements and re-planning",
    )


@dataclass
class WorkerConfig(ConfigSection):
    """Worker-server execution knobs (server/worker.py)."""

    max_concurrent_tasks: int = knob(
        4, "worker.max-concurrent-tasks",
        "tasks running concurrently on one worker (TaskExecutor slots)",
    )
    result_wait_s: float = knob(
        600.0, "worker.result-wait",
        "result long-poll bound when a task carries no deadline",
    )
    status_wait_s: float = knob(
        1.0, "worker.status-wait",
        "task status long-poll bound",
    )
    drain_task_wait_s: float = knob(
        600.0, "worker.drain-task-wait",
        "max seconds graceful drain waits on each running task",
    )
    drain_grace_s: float = knob(
        5.0, "worker.drain-grace",
        "seconds a drained server lingers after its last task finishes so "
        "downstream consumers can still pull its results",
    )
    coordinator_url: str = knob(
        "", "worker.coordinator-url",
        "coordinator base url a starting worker announces itself to "
        "(PUT /v1/worker/register) so a restarted worker resurrects its "
        "membership entry without operator action; empty = no announce",
    )


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
class PrewarmConfig(ConfigSection):
    """AOT prewarm executor (runtime/prewarm.py): replay a persisted
    workload manifest at server start / after mesh growth so the first
    real query finds every (step, bucket, mesh) key already built."""

    manifest_path: str = knob(
        "", "prewarm.manifest-path",
        "workload-manifest location (filesystem SPI; empty = prewarm off): "
        "SQL replay set + cap_history seed + closure watermark",
    )
    on_start: bool = knob(
        True, "prewarm.on-start",
        "replay the manifest in a background thread at coordinator/worker "
        "server start",
    )
    on_grow: bool = knob(
        True, "prewarm.on-grow",
        "replay the manifest after add_worker grows the mesh, re-tracing "
        "at the NEW mesh signature before the next query arrives",
    )


@dataclass
class DictionaryConfig(ConfigSection):
    """Global dictionary service (runtime/dictionary_service.py): the
    coordinator-owned versioned code assignment that makes varchar keys
    first-class in exchanges, co-located joins, and capacity licenses.

    The JAX package's section also has `dictionary.snapshot-path`, which
    no code there reads; it has no knob here.  Snapshots are taken with
    an explicit path (dictionary_service.save_snapshot / load_snapshot),
    and a restarted coordinator gets its codes from the prewarm manifest
    (runtime/prewarm)."""

    max_inline_values: int = knob(
        1 << 16, "dictionary.max-inline-values",
        "largest dictionary whose values inline into snapshots/manifests; "
        "bigger (and pattern-backed) dictionaries snapshot as metadata "
        "only and re-adopt their recorded version at re-registration",
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
    """All ported sections plus the raw properties (kept for per-worker
    override resolution at breaker-creation time)."""

    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    heartbeat: HeartbeatConfig = field(default_factory=HeartbeatConfig)
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    remote: RemoteConfig = field(default_factory=RemoteConfig)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    coordinator: CoordinatorConfig = field(default_factory=CoordinatorConfig)
    dispatcher: DispatcherConfig = field(default_factory=DispatcherConfig)
    memory: MemoryConfig = field(default_factory=MemoryConfig)
    prewarm: PrewarmConfig = field(default_factory=PrewarmConfig)
    dictionary: DictionaryConfig = field(default_factory=DictionaryConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    audit: AuditConfig = field(default_factory=AuditConfig)
    properties: dict = field(default_factory=dict)

    def breaker_for(self, worker: str) -> BreakerConfig:
        """Breaker knobs for ONE worker: base config plus any
        ``breaker.<knob>@<token>`` overrides matching its id."""
        return BreakerConfig.from_properties(
            self.properties, env=self._env, worker=worker
        )

    def section_for(self, section: str, worker: Optional[str] = None,
                    catalog: Optional[str] = None) -> ConfigSection:
        """Re-resolve one subsystem section ('breaker', 'worker', ...)
        scoped to a worker and/or catalog: ``<key>@<catalog>`` (exact
        catalog name, between env and the per-worker tier) and
        ``<key>@<token>`` overrides apply on top of the base config."""
        cls = type(getattr(self, section))
        return cls.from_properties(
            self.properties, env=self._env, worker=worker, catalog=catalog
        )

    #: env mapping captured at load so breaker_for stays reproducible
    _env = None


def load_cluster_config(props: Optional[dict] = None, env=None) -> ClusterConfig:
    """Build a ClusterConfig from a properties dict (e.g. the parsed
    ``etc/config.properties``) + environment overrides."""
    props = dict(props or {})
    env = os.environ if env is None else env
    cfg = ClusterConfig(
        breaker=BreakerConfig.from_properties(props, env),
        heartbeat=HeartbeatConfig.from_properties(props, env),
        lifecycle=LifecycleConfig.from_properties(props, env),
        remote=RemoteConfig.from_properties(props, env),
        worker=WorkerConfig.from_properties(props, env),
        coordinator=CoordinatorConfig.from_properties(props, env),
        dispatcher=DispatcherConfig.from_properties(props, env),
        memory=MemoryConfig.from_properties(props, env),
        prewarm=PrewarmConfig.from_properties(props, env),
        dictionary=DictionaryConfig.from_properties(props, env),
        profile=ProfileConfig.from_properties(props, env),
        audit=AuditConfig.from_properties(props, env),
        properties=props,
    )
    cfg._env = env
    return cfg


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
