"""Global dictionary service: versioned mesh-wide string codes.

Dictionary codes used to be producer-local (code == local sort rank), which
forced `partitioning/properties.hash_aligned_criteria` to exclude string
keys from every cross-side placement claim and forced exchanges to ship and
re-unify dictionary VALUES.  This service makes the code assignment a
coordinator-owned, versioned fact per (catalog, schema, table, column):

  * **assignment** — connectors register the one dictionary their string
    column is coded against (`Connector.global_dictionary`); registration is
    idempotent by fingerprint, and a re-registration that APPENDS values is
    a version bump under which every existing code keeps its meaning (the
    append-only contract that keeps cached scans and compiled traces keyed
    by dictionary identity valid).  A rewrite that re-maps codes (e.g. the
    memory connector's sorted-union append) is still a version bump, but a
    `remap` one: claims are keyed on exact (key, version), so stale-version
    data can never silently co-locate with new codes.
  * **snapshot** — `save_snapshot`/`load_snapshot` persist the assignment
    atomically through the filesystem SPI (the SpoolManager/manifest
    pattern); `snapshot_doc` inlines it into the prewarm manifest so a
    restarted coordinator (and every prewarming worker) resolves codes
    before the first real query, never blocking a warm path.  A missing or
    torn snapshot degrades LOUDLY to producer-local codes — slower plans
    (exchanges come back), never wrong results.
  * **resolution** — exchanges ship `(key, version)` refs instead of
    dictionary values (`parallel/serde`); a receiver resolves refs locally,
    by re-asking its own connectors (generated catalogs are deterministic),
    or through the coordinator's `GET /v1/dictionary/...` endpoint.
  * **claims** — `coding(handle, column, catalogs)` is what the planner and
    verifier consult: two join sides whose key symbols map to the SAME
    (key, version) provably place equal strings on equal workers, so the
    placer may lift the dictionary exclusion and co-locate varchar keys
    like integer keys.  `unique` entries (null-free bijections such as the
    TPC-DS `*_id` business keys) are additionally admissible as
    `exact_distinct` uniqueness sources for capacity certificates.

Late materialization falls out of the existing engine shape: device kernels
only ever see i32 codes, and values are materialized from the (shared)
dictionary at result gather.
"""

from __future__ import annotations

import json
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from trino_tpu_torch.columnar.dictionary import (
    PatternDictionary,
    StringDictionary,
    UnorderedDictionary,
)

log = logging.getLogger(__name__)

SNAPSHOT_VERSION = 1

#: a dictionary larger than this is snapshotted as metadata only (the
#: connector re-adopts its recorded version on re-registration) — the
#: snapshot is a restart artifact, not a data lake
DEFAULT_MAX_INLINE_VALUES = 1 << 16


def dictionary_fingerprint(d: StringDictionary) -> tuple:
    """Cheap content identity: pattern dictionaries by (pattern_key, n)
    (never materializing the lazy values), materialized ones by the cached
    value-tuple hash."""
    if isinstance(d, PatternDictionary):
        return ("pattern", str(d.pattern_key), len(d.values))
    return ("values", len(d.values), hash(d))


@dataclass
class DictionaryEntry:
    """One immutable (key, version) assignment."""

    key: tuple  # (catalog, schema, table, column)
    version: int
    dictionary: StringDictionary
    #: null-free bijection over the table's rows (code space == row space):
    #: admissible as an exact_distinct uniqueness source (verify.capacity)
    unique: bool = False
    fingerprint: tuple = ()
    #: False for append bumps (codes of the prior version keep their
    #: meaning), True when the registration re-mapped codes (memory
    #: connector rewrites) — consumers key claims on exact versions either
    #: way, this is bookkeeping for tests/operators
    remap: bool = False

    @property
    def ref(self) -> tuple:
        return (self.key, self.version)


def _is_extension(old: StringDictionary, new: StringDictionary) -> bool:
    """True when `new` appends to `old` (old codes keep their meaning)."""
    if len(new.values) < len(old.values):
        return False
    if isinstance(old, PatternDictionary) and isinstance(new, PatternDictionary):
        # same monotone generator, more rows: a prefix by construction
        return old.pattern_key == new.pattern_key
    if isinstance(old, PatternDictionary) or isinstance(new, PatternDictionary):
        return False  # don't materialize a lazy sequence to compare
    return tuple(new.values[: len(old.values)]) == tuple(old.values)


class GlobalDictionaryService:
    """Process-wide registry of versioned global code assignments.

    Thread-safe; the coordinator owns the authoritative instance and
    workers hold replicas fed by snapshots, connector re-registration, or
    the coordinator resolution endpoint."""

    def __init__(self):
        self._lock = threading.RLock()
        #: (key, version) -> DictionaryEntry (ALL versions stay resolvable)
        self._entries: dict[tuple, DictionaryEntry] = {}
        #: key -> latest version number
        self._latest: dict[tuple, int] = {}
        #: fingerprint -> ref, for serde's reverse lookup (any equal
        #: dictionary resolves the ref, so collisions across keys are fine)
        self._by_fp: dict[tuple, tuple] = {}
        #: key -> {fingerprint-repr: (version, unique)} adopted from a
        #: metadata-only snapshot entry: a later registration with the same
        #: fingerprint takes the RECORDED version so refs shipped before
        #: the restart stay valid
        self._adopt: dict[tuple, dict] = {}
        #: optional callable (key, version) -> StringDictionary | None used
        #: when a shipped ref is not locally resolvable (HTTP workers point
        #: this at the coordinator's /v1/dictionary endpoint)
        self.fetch_hook = None
        #: catalogs consulted for lazy registration during resolution
        self._catalogs = None

    # -- registration ----------------------------------------------------------

    def attach_catalogs(self, catalogs) -> None:
        """Catalogs used to lazily (re-)register dictionaries during ref
        resolution (worker processes resolving generated-table refs)."""
        self._catalogs = catalogs

    def register(self, catalog: str, schema: str, table: str, column: str,
                 dictionary: StringDictionary, unique: bool = False
                 ) -> DictionaryEntry:
        """Idempotent by fingerprint; a changed dictionary bumps the
        version (append-only when it extends the previous one)."""
        key = (catalog, schema, table, column)
        fp = dictionary_fingerprint(dictionary)
        with self._lock:
            latest = self._latest.get(key)
            if latest is not None:
                cur = self._entries[(key, latest)]
                if cur.fingerprint == fp:
                    if unique and not cur.unique:
                        cur.unique = True
                    return cur
            adopted = self._adopt.get(key, {}).pop(repr(fp), None)
            if adopted is not None:
                version, rec_unique = adopted
                unique = unique or rec_unique
            else:
                version = (latest or 0) + 1
                # never collide with a version recorded in a snapshot
                for v, _ in self._adopt.get(key, {}).values():
                    version = max(version, v + 1)
            remap = False
            if latest is not None:
                remap = not _is_extension(
                    self._entries[(key, latest)].dictionary, dictionary
                )
                version = max(version, latest + 1)
            ent = DictionaryEntry(key, version, dictionary, unique, fp, remap)
            self._entries[(key, version)] = ent
            self._latest[key] = max(latest or 0, version)
            self._by_fp[fp] = ent.ref
            return ent

    def extend(self, key: tuple, new_values) -> DictionaryEntry:
        """Append-only version bump: existing codes NEVER re-map.  The
        result is unordered past the original prefix, so order-dependent
        dictionary operations (range predicates, LIKE prefix ranges) raise
        instead of silently misordering — appended epochs serve equality
        joins/group-bys and late materialization only."""
        with self._lock:
            latest = self._latest.get(tuple(key))
            if latest is None:
                raise KeyError(f"no dictionary registered for {key}")
            cur = self._entries[(tuple(key), latest)]
            old = tuple(cur.dictionary.values)
            seen = set(old)
            appended = [v for v in new_values if v not in seen]
            if not appended:
                return cur
            d = UnorderedDictionary(old + tuple(appended))
            ent = DictionaryEntry(
                tuple(key), latest + 1, d, False, dictionary_fingerprint(d)
            )
            self._entries[ent.ref] = ent
            self._latest[tuple(key)] = ent.version
            self._by_fp[ent.fingerprint] = ent.ref
            return ent

    # -- lookup ----------------------------------------------------------------

    def lookup(self, handle, column: str, catalogs=None
               ) -> Optional[DictionaryEntry]:
        """Latest entry for a scan column, consulting the connector for
        lazy (re-)registration when catalogs are available.  Returns None
        when the column has no global assignment (producer-local codes)."""
        catalogs = catalogs if catalogs is not None else self._catalogs
        if catalogs is not None:
            try:
                conn = catalogs.get(handle.catalog)
            except KeyError:
                conn = None
            if conn is not None:
                got = conn.global_dictionary(handle, column)
                if got is not None:
                    d, unique = got
                    return self.register(
                        handle.catalog, handle.schema, handle.table, column,
                        d, unique,
                    )
        key = (handle.catalog, handle.schema, handle.table, column)
        with self._lock:
            latest = self._latest.get(key)
            if latest is None:
                return None
            return self._entries[(key, latest)]

    def coding(self, handle, column: str, catalogs=None) -> Optional[tuple]:
        """(key, version) ref the column's codes are assigned under, or
        None — the planner/verifier claim gate."""
        ent = self.lookup(handle, column, catalogs)
        return None if ent is None else ent.ref

    def ref_of(self, dictionary: StringDictionary) -> Optional[tuple]:
        """Reverse lookup for serde: a ref whose entry holds an EQUAL
        dictionary, or None (producer-local — ship values)."""
        if dictionary is None:
            return None
        fp = dictionary_fingerprint(dictionary)
        with self._lock:
            return self._by_fp.get(fp)

    def entry(self, key, version: int) -> DictionaryEntry:
        """Exact (key, version) entry, consulting connectors for lazy
        re-registration (the coordinator resolution endpoint's lookup);
        raises KeyError when the exact version is unknown."""
        key = tuple(key)
        with self._lock:
            ent = self._entries.get((key, version))
        if ent is not None:
            return ent
        if self._catalogs is not None:
            catalog, schema, table, column = key
            from trino_tpu_torch.connectors.api import TableHandle

            self.lookup(TableHandle(catalog, schema, table), column)
            with self._lock:
                ent = self._entries.get((key, version))
            if ent is not None:
                return ent
        raise KeyError(f"no global dictionary entry {key} v{version}")

    def resolve(self, key, version: int) -> StringDictionary:
        """Dictionary for a shipped (key, version) ref.  Tries the local
        registry, then connector re-registration (generated catalogs are
        deterministic, so the re-derived version matches), then the fetch
        hook; an unresolvable ref RAISES — decoding through a wrong
        dictionary would be silently wrong results."""
        key = tuple(key)
        try:
            return self.entry(key, version).dictionary
        except KeyError:
            pass
        if self.fetch_hook is not None:
            d = self.fetch_hook(key, version)
            if d is not None:
                catalog, schema, table, column = key
                ent = DictionaryEntry(
                    key, version, d, False, dictionary_fingerprint(d)
                )
                with self._lock:
                    self._entries.setdefault((key, version), ent)
                    self._latest[key] = max(self._latest.get(key, 0), version)
                    self._by_fp.setdefault(ent.fingerprint, ent.ref)
                return d
        raise KeyError(
            f"unresolvable global dictionary ref {key} v{version} "
            "(no local entry, connector, or fetch hook)"
        )

    # -- snapshots -------------------------------------------------------------

    def snapshot_doc(self, max_inline: int = DEFAULT_MAX_INLINE_VALUES) -> dict:
        """JSON-able snapshot of every (key, version).  Values inline up to
        `max_inline`; larger and pattern-backed dictionaries snapshot as
        metadata only — a re-registering connector adopts the recorded
        version so pre-restart refs stay valid."""
        entries = []
        with self._lock:
            items = sorted(self._entries.items())
        for (key, version), ent in items:
            rec = {
                "key": list(key),
                "version": version,
                "unique": ent.unique,
                "fingerprint": repr(ent.fingerprint),
                "len": len(ent.dictionary.values),
                "remap": ent.remap,
                "values": None,
            }
            d = ent.dictionary
            if (
                not isinstance(d, PatternDictionary)
                and len(d.values) <= max_inline
            ):
                rec["values"] = list(d.values)
                rec["ordered"] = not isinstance(d, UnorderedDictionary)
            entries.append(rec)
        return {"version": SNAPSHOT_VERSION, "entries": entries}

    def load_doc(self, doc) -> int:
        """Adopt a snapshot document (tolerant — see load_snapshot).
        Returns the number of entries restored or marked for adoption."""
        if not doc:
            return 0
        n = 0
        for rec in doc.get("entries") or ():
            try:
                key = tuple(rec["key"])
                version = int(rec["version"])
                unique = bool(rec.get("unique"))
                values = rec.get("values")
            except (KeyError, TypeError, ValueError):
                log.warning("global dictionary snapshot entry ignored: %r", rec)
                continue
            with self._lock:
                if values is not None:
                    if (key, version) in self._entries:
                        n += 1
                        continue
                    cls = (
                        StringDictionary if rec.get("ordered", True)
                        else UnorderedDictionary
                    )
                    try:
                        d = cls(values)
                    except AssertionError:
                        log.warning(
                            "global dictionary snapshot entry for %s v%d is "
                            "not sorted-unique; ignored", key, version,
                        )
                        continue
                    ent = DictionaryEntry(
                        key, version, d, unique, dictionary_fingerprint(d),
                        bool(rec.get("remap")),
                    )
                    self._entries[(key, version)] = ent
                    self._latest[key] = max(self._latest.get(key, 0), version)
                    self._by_fp[ent.fingerprint] = ent.ref
                else:
                    fp = rec.get("fingerprint")
                    if fp:
                        self._adopt.setdefault(key, {})[fp] = (version, unique)
            n += 1
        return n

    def save_snapshot(self, location: str,
                      max_inline: int = DEFAULT_MAX_INLINE_VALUES) -> None:
        """Persist atomically through the filesystem SPI (tmp + rename —
        a reader never observes a torn snapshot)."""
        from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

        fs = filesystem_for(location)
        doc = self.snapshot_doc(max_inline)
        fs.write(
            strip_scheme(location),
            (json.dumps(doc, indent=1) + "\n").encode(),
        )

    def load_snapshot(self, location: str) -> int:
        """Load a snapshot; a missing/torn/unreadable one degrades LOUDLY
        to producer-local codes (plans lose varchar co-location — slower,
        never wrong).  Returns entries adopted (0 on degrade)."""
        from trino_tpu_torch.filesystem import filesystem_for, strip_scheme

        try:
            fs = filesystem_for(location)
            path = strip_scheme(location)
            if not fs.exists(path):
                log.warning(
                    "global dictionary snapshot missing at %s: degrading to "
                    "producer-local codes (varchar keys lose co-location "
                    "until connectors re-register)", location,
                )
                return 0
            doc = json.loads(fs.read(path).decode())
        except (NotImplementedError, OSError, ValueError) as e:
            log.warning(
                "global dictionary snapshot unreadable at %s (%s): degrading "
                "to producer-local codes (never wrong results, but varchar "
                "keys repartition until connectors re-register)", location, e,
            )
            return 0
        return self.load_doc(doc)

    # -- maintenance -----------------------------------------------------------

    def reset(self) -> None:
        """Drop every assignment (tests)."""
        with self._lock:
            self._entries.clear()
            self._latest.clear()
            self._by_fp.clear()
            self._adopt.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "keys": len(self._latest),
                "versions": len(self._entries),
                "unique": sum(
                    1 for e in self._entries.values() if e.unique
                ),
            }


#: the process singleton (coordinator-authoritative; workers are replicas)
DICTIONARY_SERVICE = GlobalDictionaryService()


def coordinator_fetch_hook(base_url: str):
    """fetch_hook resolving refs from a coordinator's
    GET /v1/dictionary/{catalog}/{schema}/{table}/{column}?version=N."""
    import urllib.request

    def fetch(key, version):
        catalog, schema, table, column = key
        url = (
            f"{base_url.rstrip('/')}/v1/dictionary/{catalog}/{schema}/"
            f"{table}/{column}?version={int(version)}"
        )
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                doc = json.loads(r.read().decode())
        except (OSError, ValueError) as e:
            log.warning("dictionary fetch failed for %s v%s: %s",
                        key, version, e)
            return None
        values = doc.get("values")
        if values is None or int(doc.get("version", -1)) != int(version):
            return None
        cls = StringDictionary if doc.get("ordered", True) else UnorderedDictionary
        return cls(values)

    return fetch
