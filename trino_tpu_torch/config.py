"""Typed engine configuration: the memory section.

Port of part of trino_tpu/config.py (the airlift ``@Config`` analog).
Each field carries its properties key; a knob resolves, first hit wins,
from the environment (``TRINO_TPU_<KEY>`` with ``.``/``-`` -> ``_``,
uppercased), the properties dict, then the dataclass default.  (The JAX
package's per-catalog and per-worker overrides serve sections that are
not ported.)

Ported: the ``memory`` section (``memory.pool-limit-bytes``,
``memory.spill-dir``), `get_config` / `install_config` /
`reset_config`; installing a config with a pool limit arms the shared
memory pool's limit.  The other sections (breaker, heartbeat, lifecycle,
remote, worker, coordinator, dispatcher, compile cache, prewarm,
dictionary, profile, audit) are not ported yet.
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
        """[(properties key, value, help)]."""
        out = []
        for f in fields(self):
            key = f.metadata.get("key")
            if key is not None:
                out.append((key, getattr(self, f.name), f.metadata.get("help", "")))
        return out


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
class ClusterConfig:
    """The ported sections plus the raw properties."""

    memory: MemoryConfig = field(default_factory=MemoryConfig)
    properties: dict = field(default_factory=dict)


def load_cluster_config(props: Optional[dict] = None, env=None) -> ClusterConfig:
    """Build a ClusterConfig from a properties dict + environment overrides."""
    props = dict(props or {})
    env = os.environ if env is None else env
    return ClusterConfig(
        memory=MemoryConfig.from_properties(props, env), properties=props
    )


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
