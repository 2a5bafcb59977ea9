"""Configuration file loading.

Reference roles: the launcher's etc/ directory layout —
`etc/config.properties` (node/coordinator config read by
io.airlift.configuration), `etc/catalog/<name>.properties` (one catalog per
file, `connector.name=` selects the plugin; server/CatalogManager loading),
and pointer files for password authentication / access control / resource
groups.

The properties syntax is the java.util.Properties subset the reference uses:
`key=value` or `key: value`, `#`/`!` comments, trailing-backslash line
continuation.

Port of trino_tpu/runtime/config.py.  The `tpch`, `tpcds`, `memory` and
`blackhole` connectors load; the `hive`, `iceberg` and `parquet`
factories raise NotImplementedError naming themselves (their connectors
are not ported).  The file event listener is ported, and so are the
query performance observatory's knobs: `profile.archive-dir` attaches a
profile store and `audit.log-path` an audit log to the runner, and
`access-control.config-file` (a JSON file of rules under "tables" or
"rules") installs a RuleBasedAccessControl.  `prewarm.manifest-path`
attaches the prewarm executor (runtime/prewarm) to the runner, which the
CoordinatorServer replays at start; unset, it does nothing, as in the JAX
package.  `runner_from_etc` builds a LocalQueryRunner on the card unless
`device=` names another device.
"""

from __future__ import annotations

import os
from typing import Optional


def load_properties(path: str) -> dict:
    """Parse one .properties file into {key: value} (strings)."""
    out: dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as fh:
        pending = ""
        for raw in fh:
            line = pending + raw.strip()
            pending = ""
            if not line or line[0] in "#!":
                continue
            if line.endswith("\\"):
                pending = line[:-1]
                continue
            for sep in ("=", ":"):
                if sep in line:
                    k, v = line.split(sep, 1)
                    out[k.strip()] = v.strip()
                    break
            else:
                out[line] = ""
    return out


#: connector.name -> factory(properties dict) -> Connector
#: (reference: spi ConnectorFactory registration via Plugin.getConnectorFactories)
def _factories() -> dict:
    from trino_tpu_torch.connectors.blackhole import BlackholeConnector
    from trino_tpu_torch.connectors.memory import MemoryConnector
    from trino_tpu_torch.connectors.tpch import TpchConnector

    reg = {
        "tpch": lambda p: TpchConnector(),
        "memory": lambda p: MemoryConnector(),
        "blackhole": lambda p: BlackholeConnector(),
    }
    try:
        from trino_tpu_torch.connectors.tpcds import TpcdsConnector

        reg["tpcds"] = lambda p: TpcdsConnector()
    except ImportError:  # pragma: no cover
        pass

    def unported(name: str):
        def factory(p):
            raise NotImplementedError(
                f"the {name} connector (connector.name={name}): not ported yet"
            )

        return factory

    hive = unported("hive")
    iceberg = unported("iceberg")
    parquet = unported("parquet")

    reg["hive"] = hive
    reg["iceberg"] = iceberg
    reg["parquet"] = parquet
    return reg


class EtcConfig:
    """Everything loaded from an etc/ directory."""

    def __init__(self, node_properties: dict, catalogs, session_defaults: dict,
                 cluster=None):
        self.node_properties = node_properties
        self.catalogs = catalogs
        self.session_defaults = session_defaults
        #: the typed ClusterConfig (trino_tpu_torch/config) parsed from the same
        #: config.properties — the dispatcher and memory knobs
        self.cluster = cluster


def load_etc(etc_dir: str, install: bool = True) -> EtcConfig:
    """Load config.properties + etc/catalog/*.properties into a CatalogManager
    and node/session settings (reference: the server launcher's config
    loading + CatalogStore).  The same properties feed the TYPED config
    system (trino_tpu_torch/config): the dispatcher and memory
    knobs, installed process-wide unless `install=False` — installation
    also applies the eager sections (the memory pool limit)."""
    from trino_tpu_torch.connectors.api import CatalogManager

    node_props: dict = {}
    cfg = os.path.join(etc_dir, "config.properties")
    if os.path.exists(cfg):
        node_props = load_properties(cfg)
    from trino_tpu_torch.config import install_config, load_cluster_config

    cluster = load_cluster_config(node_props)
    if install:
        install_config(cluster)
    cm = CatalogManager()
    factories = _factories()
    cat_dir = os.path.join(etc_dir, "catalog")
    if os.path.isdir(cat_dir):
        for fn in sorted(os.listdir(cat_dir)):
            if not fn.endswith(".properties"):
                continue
            name = fn[: -len(".properties")]
            props = load_properties(os.path.join(cat_dir, fn))
            conn_name = props.get("connector.name")
            if conn_name is None:
                raise ValueError(f"{fn}: missing connector.name")
            factory = factories.get(conn_name)
            if factory is None:
                raise ValueError(f"{fn}: unknown connector.name {conn_name!r}")
            cm.register(name, factory(props))
    # session property defaults: `session.<name>=value` entries
    session_defaults = {}
    for k, v in node_props.items():
        if k.startswith("session."):
            session_defaults[k[len("session."):]] = _coerce(v)
    return EtcConfig(node_props, cm, session_defaults, cluster=cluster)


def _coerce(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def runner_from_etc(etc_dir: str, **kw):
    """LocalQueryRunner wired from an etc/ directory (catalogs, session
    defaults, the event listener, the profile store and the audit log);
    `kw` goes to the runner (`device=`)."""
    from trino_tpu_torch.runtime.runner import LocalQueryRunner

    cfg = load_etc(etc_dir)
    catalog = cfg.node_properties.get("default.catalog", "tpch")
    schema = cfg.node_properties.get("default.schema", "tiny")
    if catalog not in cfg.catalogs.names():
        names = cfg.catalogs.names()
        if names:
            catalog = sorted(names)[0]
    r = LocalQueryRunner(
        catalog=catalog,
        schema=schema,
        catalogs=cfg.catalogs,
        **kw,
    )
    for k, v in cfg.session_defaults.items():
        try:
            r.properties.set(k, v)
        except Exception:
            pass
    # event-listener plugin loading (reference: etc/event-listener.properties
    # with event-listener.name=...)
    el_path = os.path.join(etc_dir, "event-listener.properties")
    if os.path.exists(el_path):
        el_props = load_properties(el_path)
        el_name = el_props.get("event-listener.name")
        if el_name != "file":
            raise ValueError(
                f"event-listener.properties: unknown event-listener.name "
                f"{el_name!r} (supported: 'file')"
            )
        if "file.path" not in el_props:
            raise ValueError("event-listener.properties: missing file.path")
        from trino_tpu_torch.runtime.events import FileEventListener

        r.events.add(FileEventListener(el_props["file.path"]))
    # query performance observatory: the JSONL audit log (`audit.log-path`)
    # and the per-query profile archive (`profile.archive-dir`) attach when
    # configured — both no-ops without their knobs (load_etc installed the
    # typed config they read)
    from trino_tpu_torch.telemetry.audit import attach_audit_log
    from trino_tpu_torch.telemetry.profile_store import attach_profile_store

    attach_profile_store(r)
    attach_audit_log(r)
    # restart resilience: an etc/-driven runner gets its prewarm executor
    # (runtime/prewarm) when `prewarm.manifest-path` is configured — the
    # CoordinatorServer then replays it at start, and grow paths re-build
    # at the new mesh signature (no-op without the knob)
    from trino_tpu_torch.runtime.prewarm import attach_prewarm

    attach_prewarm(r)
    ac_file = cfg.node_properties.get("access-control.config-file")
    if ac_file:
        import json

        from trino_tpu_torch.server.security import RuleBasedAccessControl

        with open(ac_file) as fh:
            doc = json.load(fh)
        r.access_control = RuleBasedAccessControl.from_dicts(
            doc.get("tables", doc.get("rules", []))
        )
    return r
