"""Connector SPI (reference: core/trino-spi/src/main/java/io/trino/spi/connector/).

The plugin boundary: the engine sees tables as (metadata, splits, page
sources).  A PageSource yields host-side numpy column data for a split which
the scan operator turns into device Batches.  Connectors may implement
predicate pushdown (TupleDomain-style min/max pruning) and report row-count
statistics the planner uses for capacity planning — on a shape-static device,
stats are not just cost hints but *allocation* inputs.

Key interface analogs:
  Connector                -> spi/connector/Connector.java
  ConnectorMetadata        -> spi/connector/ConnectorMetadata.java:63
  ConnectorSplitManager    -> splits() here
  ConnectorPageSource      -> spi/connector/ConnectorPageSource.java:24
  TableStatistics          -> spi/statistics/TableStatistics.java
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

import numpy as np

from trino_tpu_torch.types import Type
from trino_tpu_torch.columnar import StringDictionary


@dataclass(frozen=True)
class ColumnMeta:
    name: str
    type: Type
    #: whether the generator can bound this column's values per split
    #: (enables min/max split pruning, the TupleDomain analog)
    ordered: bool = False


@dataclass(frozen=True)
class TableMetadata:
    schema: str
    name: str
    columns: tuple[ColumnMeta, ...]

    def column_index(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self.column_index(name)]


@dataclass(frozen=True)
class TableHandle:
    catalog: str
    schema: str
    table: str


@dataclass(frozen=True)
class ColumnRange:
    """Min/max bound of a column within a split (for pruning)."""

    low: object
    high: object


@dataclass(frozen=True)
class Split:
    """A unit of scan parallelism (reference: spi/connector/ConnectorSplit.java).

    `row_start`/`row_count` describe the slice for generator/memory
    connectors; file connectors put their own info in `info`.
    """

    table: TableHandle
    seq: int
    row_start: int = 0
    row_count: int = 0
    info: object = None
    #: optional per-column (name, (low, high)) ranges for pruning
    ranges: tuple = ()


@dataclass
class ColumnData:
    """Host-side column produced by a PageSource."""

    values: np.ndarray
    valid: Optional[np.ndarray] = None
    dictionary: Optional[StringDictionary] = None


class PageSource:
    """Produces host column data for one split, projected columns only."""

    def pages(self) -> Iterator[list[ColumnData]]:
        raise NotImplementedError

    def row_count(self) -> int:
        raise NotImplementedError


@dataclass(frozen=True)
class ColumnStatistics:
    distinct_count: Optional[float] = None
    null_fraction: float = 0.0
    low: object = None
    high: object = None
    #: distinct_count is STRUCTURALLY exact (dense surrogate keys, literal
    #: enumerations) rather than an estimate or probabilistic upper bound.
    #: Only exact counts are admissible as UNIQUENESS proofs
    #: (verify.capacity.unique_sets): a random FK column of a tiny table
    #: may claim ndv == rows and still collide — that claim must never
    #: license a join fanout certificate.
    exact_distinct: bool = False


@dataclass(frozen=True)
class TableStatistics:
    row_count: Optional[int] = None
    columns: dict = field(default_factory=dict)  # name -> ColumnStatistics


class ConnectorMetadata:
    def list_schemas(self) -> Sequence[str]:
        raise NotImplementedError

    def list_tables(self, schema: str) -> Sequence[str]:
        raise NotImplementedError

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        raise NotImplementedError

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        return TableStatistics()


class Connector:
    """One catalog's implementation."""

    name: str = "connector"

    def metadata(self) -> ConnectorMetadata:
        raise NotImplementedError

    def splits(
        self,
        handle: TableHandle,
        target_splits: int,
        predicate=None,
    ) -> Sequence[Split]:
        raise NotImplementedError

    def page_source(
        self,
        split: Split,
        columns: Sequence[str],
        max_rows_per_page: int = 1 << 20,
    ) -> PageSource:
        raise NotImplementedError

    def table_layout(self, handle: TableHandle):
        """Declared hash-bucketed layout of `handle`, or None (reference
        role: ConnectorMetadata.getTableProperties' partitioning handle).
        Consulted by partitioning.LayoutResolver AFTER session-property and
        engine-registry declarations."""
        return None

    def global_dictionary(self, handle: TableHandle, column: str):
        """(dictionary, unique) when every scan of `handle.column` codes its
        data against ONE dictionary that is stable across splits, workers,
        and processes — the registration source for the global dictionary
        service (runtime/dictionary_service).  `unique=True` additionally
        asserts the column is a NULL-FREE BIJECTION over the table's rows
        (dense business keys: dictionary size == row count, every row a
        distinct value) — the structural claim that makes it an
        exact_distinct uniqueness source for capacity certificates; never
        claim it for merely-probably-distinct columns.  Return None (the
        default) for producer-local coding."""
        return None

    def scan_version(self, handle: TableHandle):
        """Cache token for scan results of `handle`: scans of the same split
        + columns + version may be served from the engine's buffer pool.
        Return None (default) if the data can change without a version bump
        — such tables are never cached.  Immutable/generated tables return a
        constant.  (Reference role: the split-level caching contract file
        connectors get from immutable files + OS page cache.)"""
        return None

    # -- write path (memory/blackhole connectors; reference: ConnectorPageSink)

    def supports_writes(self) -> bool:
        return False

    def page_sink(self, handle: TableHandle, column_names, column_types):
        raise NotImplementedError

    def create_table(self, schema: str, table: str, columns) -> None:
        raise NotImplementedError

    def drop_table(self, handle: TableHandle) -> None:
        raise NotImplementedError


def scan_predicate_triples(node) -> "Optional[list]":
    """Connector-pruning triples for a TableScanNode's pushed predicate
    (None when nothing is pushed) — the one conversion both the local and
    the SPMD planner feed into `Connector.splits(predicate=...)`."""
    if node.pushed_predicate is None:
        return None
    return extract_predicate_triples(
        node.pushed_predicate, {s.name: c for s, c in node.assignments}
    )


def extract_predicate_triples(expr, sym_to_col: dict) -> list:
    """Pushed-down predicate -> [(column, op, literal-value)] conjunct
    triples a connector can prune splits/partitions with (reference role:
    TupleDomain extraction in HivePartitionManager).  Conjuncts that don't
    fit the shape are simply omitted — they still filter on device."""
    from trino_tpu_torch.expr.ir import Call, Form, Literal, SpecialForm, SymbolRef, InputRef

    def colname(e):
        if isinstance(e, SymbolRef):
            return sym_to_col.get(e.name)
        return None

    def litval(e):
        if isinstance(e, Literal) and e.value is not None:
            return e.value
        return None

    ops = {"$eq": "=", "$lt": "<", "$le": "<=", "$gt": ">", "$ge": ">="}
    flipped = {"=": "=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}
    out = []

    def walk(e):
        if isinstance(e, SpecialForm) and e.form == Form.AND:
            for a in e.args:
                walk(a)
            return
        if isinstance(e, SpecialForm) and e.form == Form.BETWEEN:
            c = colname(e.args[0])
            lo, hi = litval(e.args[1]), litval(e.args[2])
            if c is not None and lo is not None:
                out.append((c, ">=", lo))
            if c is not None and hi is not None:
                out.append((c, "<=", hi))
            return
        if isinstance(e, SpecialForm) and e.form == Form.IN:
            c = colname(e.args[0])
            vals = [litval(a) for a in e.args[1:]]
            if c is not None and all(v is not None for v in vals):
                out.append((c, "in", tuple(vals)))
            return
        if isinstance(e, Call) and e.name in ops and len(e.args) == 2:
            l, r = e.args
            c, v = colname(l), litval(r)
            if c is not None and v is not None:
                out.append((c, ops[e.name], v))
                return
            c, v = colname(r), litval(l)
            if c is not None and v is not None:
                out.append((c, flipped[ops[e.name]], v))

    walk(expr)
    return out


class CatalogManager:
    """catalog name -> Connector (reference: connector/StaticCatalogManager.java)."""

    def __init__(self):
        self._catalogs: dict[str, Connector] = {}

    def register(self, name: str, connector: Connector) -> None:
        self._catalogs[name] = connector

    def get(self, name: str) -> Connector:
        if name not in self._catalogs:
            raise KeyError(f"catalog not found: {name}")
        return self._catalogs[name]

    def names(self):
        return sorted(self._catalogs)


def default_catalogs() -> CatalogManager:
    """The standard test/bench catalog set: tpch and tpcds (the memory
    and blackhole connectors are not ported yet)."""
    from trino_tpu_torch.connectors.tpch import TpchConnector
    from trino_tpu_torch.connectors.tpcds import TpcdsConnector

    cm = CatalogManager()
    cm.register("tpch", TpchConnector())
    cm.register("tpcds", TpcdsConnector())
    return cm
