"""Hive-style partitioned file connector (parquet + ORC).

Reference roles: plugin/trino-hive (HiveMetadata / HivePartitionManager
partition pruning, BackgroundHiveSplitLoader's directory walk,
ParquetPageSourceFactory + OrcPageSourceFactory) — the host decode is the
port's own parquet reader (`formats/parquet`, row groups) and ORC reader
(`formats/orc`, stripes), the metastore is the directory layout itself:

    root/<schema>/<table>/<pcol>=<val>/.../part-*.parquet|.orc

Partition columns live in directory names (values typed by inference:
int-looking -> bigint, date-looking -> date, else varchar).  Split
enumeration prunes partitions against pushed-down predicate conjuncts
(HivePartitionManager.getPartitions analog) BEFORE any file IO, then splits
per parquet row group / per ORC stripe.  Partition values surface as
constant columns welded onto each page (HivePageSource's prefilled blocks).
A table whose partitions hold both formats reads each file by its
extension, its schema from the first file, as the JAX package's does.

Port of trino_tpu/connectors/hive.py.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Sequence

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import StringDictionary
from trino_tpu_torch.connectors.api import (
    ColumnData,
    ColumnMeta,
    Connector,
    ConnectorMetadata,
    PageSource,
    Split,
    TableHandle,
    TableMetadata,
    TableStatistics,
)
from trino_tpu_torch.connectors.parquet import read_table_columns, slice_column
from trino_tpu_torch.formats.orc import writer as orc_writer
from trino_tpu_torch.formats.orc.reader import OrcFile
from trino_tpu_torch.formats.parquet import writer as parquet_writer
from trino_tpu_torch.formats.parquet.reader import ParquetFile

_DATA_EXT = (".parquet", ".orc")
#: `codec=` of write_partitioned, read for ORC as Trino's HiveCompressionCodec
#: maps it (GZIP is ORC's ZLIB)
_ORC_CODECS = {"GZIP": "ZLIB", "UNCOMPRESSED": "NONE"}


def _is_orc(path: str) -> bool:
    return path.endswith(".orc")


_INT_RE = re.compile(r"^-?\d+$")
_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")


def _infer_partition_type(values: Sequence[str]) -> T.Type:
    if all(_INT_RE.match(v) for v in values):
        return T.BIGINT
    if all(_DATE_RE.match(v) for v in values):
        return T.DATE
    return T.VARCHAR


def _partition_value(raw: str, t: T.Type):
    """Directory-name string -> logical python value."""
    if t is T.BIGINT:
        return int(raw)
    if t is T.DATE:
        y, m, d = (int(x) for x in raw.split("-"))
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    return raw


class _HiveMetadata(ConnectorMetadata):
    def __init__(self, conn: "HiveConnector"):
        self.conn = conn

    def list_schemas(self) -> Sequence[str]:
        root = self.conn.root
        if not os.path.isdir(root):
            return []
        return sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )

    def list_tables(self, schema: str) -> Sequence[str]:
        base = os.path.join(self.conn.root, schema)
        if not os.path.isdir(base):
            return []
        return sorted(
            d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
        )

    def table_metadata(self, schema: str, table: str) -> TableMetadata:
        parts = self.conn._partitions(schema, table)
        if not parts:
            raise KeyError(f"hive table not found or empty: {schema}.{table}")
        pcols = parts[0].keys_in_order
        sample = parts[0].files[0]
        file_cols = self.conn._file_schema(sample)
        ptypes = {}
        for k in pcols:
            ptypes[k] = _infer_partition_type(
                [p.values[k] for p in parts]
            )
        cols = tuple(
            list(file_cols)
            + [ColumnMeta(k, ptypes[k]) for k in pcols]
        )
        return TableMetadata(schema, table, cols)

    def table_statistics(self, schema: str, table: str) -> TableStatistics:
        rows = 0
        for p in self.conn._partitions(schema, table):
            for f in p.files:
                rows += _file_rows(f)
        return TableStatistics(row_count=rows)


class _Partition:
    __slots__ = ("keys_in_order", "values", "files")

    def __init__(self, keys_in_order, values, files):
        self.keys_in_order = keys_in_order
        self.values = values  # {pcol: raw string}
        self.files = files


def _file_rows(path: str) -> int:
    return (OrcFile if _is_orc(path) else ParquetFile)(path).num_rows


class _HivePageSource(PageSource):
    def __init__(self, split: Split, columns, types, page_rows: int):
        self.split = split
        self.columns = list(columns)
        self.types = list(types)
        self.page_rows = page_rows

    def row_count(self) -> int:
        return self.split.row_count

    def pages(self):
        path, piece, pvals, ptypes = self.split.info
        file_cols = [c for c in self.columns if c not in pvals]
        if not file_cols:
            # partition-columns-only projection: no file read at all, emit
            # constant pages sized by the piece's row count
            n = self.split.row_count
            for start in range(0, max(n, 1), self.page_rows):
                rows = min(self.page_rows, n - start)
                if rows <= 0 and start > 0:
                    break
                yield [
                    _constant_column(pvals[c], ptypes[c], max(rows, 0))
                    for c in self.columns
                ]
            return
        tmap = dict(zip(self.columns, self.types))
        cols = _read_piece(path, piece, file_cols, [tmap[c] for c in file_cols])
        n = len(cols[0].values)
        for start in range(0, max(n, 1), self.page_rows):
            stop = min(start + self.page_rows, n)
            if stop <= start and start > 0:
                break
            out = []
            for c, t in zip(self.columns, self.types):
                if c in pvals:
                    out.append(_constant_column(pvals[c], ptypes[c], stop - start))
                else:
                    out.append(slice_column(cols[file_cols.index(c)], start, stop))
            yield out


def _read_piece(path: str, piece, columns, types):
    if _is_orc(path):
        return OrcFile(path).read_stripe(piece, columns, types)
    return ParquetFile(path).read_row_group(piece, columns, types)


def _constant_column(raw: str, t: T.Type, n: int) -> ColumnData:
    """Partition value as a constant column (HivePageSource prefilled
    blocks; RLE on device is just a broadcast)."""
    v = _partition_value(raw, t)
    if t is T.VARCHAR:
        d = StringDictionary.from_unsorted([v])
        return ColumnData(np.zeros(n, np.int32), None, d)
    return ColumnData(np.full(n, v, dtype=t.np_dtype), None)


class HiveConnector(Connector):
    name = "hive"

    def __init__(self, root: str):
        self.root = root
        self._metadata = _HiveMetadata(self)

    def metadata(self) -> _HiveMetadata:
        return self._metadata

    # -- directory walk (BackgroundHiveSplitLoader role) ---------------------

    def _file_schema(self, path: str):
        return (OrcFile if _is_orc(path) else ParquetFile)(path).columns()

    def _partitions(self, schema: str, table: str) -> list:
        base = os.path.join(self.root, schema, table)
        if not os.path.isdir(base):
            return []
        out = []

        def walk(d, keys, vals):
            files = []
            subdirs = []
            for name in sorted(os.listdir(d)):
                p = os.path.join(d, name)
                if os.path.isfile(p) and name.endswith(_DATA_EXT):
                    files.append(p)
                elif os.path.isdir(p) and "=" in name:
                    subdirs.append((name, p))
            if files:
                out.append(
                    _Partition(tuple(keys), dict(zip(keys, vals)), files)
                )
            for name, p in subdirs:
                k, _, v = name.partition("=")
                walk(p, keys + [k], vals + [v])

        walk(base, [], [])
        return out

    def scan_version(self, handle: TableHandle):
        try:
            sig = []
            for p in self._partitions(handle.schema, handle.table):
                for f in p.files:
                    sig.append((f, int(os.path.getmtime(f)), os.path.getsize(f)))
            return tuple(sig)
        except OSError:
            return None

    # -- partition pruning (HivePartitionManager.getPartitions) --------------

    def _prune(self, partitions: list, predicate, ptypes: dict) -> list:
        """`predicate` is a list of (column, op, value) conjunct triples the
        engine extracted from the pushed-down predicate; conjuncts on
        non-partition columns are ignored (they filter on device later)."""
        if not predicate:
            return partitions
        kept = []
        for part in partitions:
            ok = True
            for col, op, val in predicate:
                if col not in part.values:
                    continue
                pv = _partition_value(part.values[col], ptypes[col])
                if op == "=":
                    ok = pv == val
                elif op == "in":
                    ok = pv in val
                elif op == "<":
                    ok = pv < val
                elif op == "<=":
                    ok = pv <= val
                elif op == ">":
                    ok = pv > val
                elif op == ">=":
                    ok = pv >= val
                if not ok:
                    break
            if ok:
                kept.append(part)
        return kept

    def splits(self, handle: TableHandle, target_splits: int, predicate=None):
        parts = self._partitions(handle.schema, handle.table)
        if not parts:
            return []
        meta = self._metadata.table_metadata(handle.schema, handle.table)
        tmap = {c.name: c.type for c in meta.columns}
        ptypes = {k: tmap[k] for k in parts[0].keys_in_order}
        keep = {
            id(p) for p in self._prune(parts, predicate, ptypes)
        }
        out = []
        seq = 0
        row_start = 0
        # seq numbers come from the UNPRUNED enumeration so a split's
        # identity (and therefore its buffer-pool cache key) is stable no
        # matter which predicate selected it
        for part in parts:
            for path in part.files:
                for piece, nrows in _pieces(path):
                    if id(part) in keep:
                        out.append(
                            Split(
                                handle,
                                seq,
                                row_start=row_start,
                                row_count=nrows,
                                info=(path, piece, part.values, ptypes),
                            )
                        )
                    seq += 1
                    row_start += nrows
        return out

    def page_source(
        self, split: Split, columns: Sequence[str], max_rows_per_page: int = 1 << 20
    ) -> PageSource:
        meta = self._metadata.table_metadata(
            split.table.schema, split.table.table
        )
        tmap = {c.name: c.type for c in meta.columns}
        types = [tmap[c] for c in columns]
        return _HivePageSource(split, columns, types, max_rows_per_page)


def _pieces(path: str):
    """(piece_index, rows) per split unit: parquet row group / ORC stripe."""
    if _is_orc(path):
        f = OrcFile(path)
        return [(i, f.stripe_rows(i)) for i in range(f.num_stripes)]
    pf = ParquetFile(path)
    return [(rg, pf.row_group_rows(rg)) for rg in range(pf.num_row_groups)]


# -- partitioned export helper (writer role of plugin/trino-hive) ------------


def write_partitioned(
    connector: Connector,
    schema: str,
    table: str,
    out_root: str,
    partition_by: Sequence[str],
    fmt: str = "parquet",
    row_group_rows: int = 1 << 20,
    codec: str = "GZIP",
) -> int:
    """Export a connector table into hive layout, partitioned by
    `partition_by` columns.  Returns partition count.  Partitions come in
    order of first appearance; a row whose partition key is NULL is written
    to no partition, and its combination's directory (`k=None`) holds an
    empty file, as the JAX package's Arrow filter leaves it.  `fmt` is
    "parquet" (`row_group_rows` rows a row group) or "orc" (a stripe every
    `row_group_rows` rows); `codec` is GZIP (ORC's ZLIB) or UNCOMPRESSED."""
    if fmt == "orc":
        if codec not in _ORC_CODECS:
            raise NotImplementedError(
                f"hive write_partitioned: codec {codec} for ORC (GZIP and "
                "UNCOMPRESSED are supported)")

        def write(path, names, types, columns):
            orc_writer.write_columns(path, names, types, columns,
                                     stripe_rows=row_group_rows, codec=_ORC_CODECS[codec])
    elif fmt == "parquet":
        def write(path, names, types, columns):
            parquet_writer.write_columns(path, names, types, columns,
                                         row_group_rows=row_group_rows, codec=codec)
    else:
        raise ValueError(f"unsupported format {fmt}")
    names, types, cols = read_table_columns(connector, schema, table, row_group_rows)
    by = {n: (t, cd) for n, t, cd in zip(names, types, cols)}
    data = [(n, t, cd) for n, t, cd in zip(names, types, cols) if n not in partition_by]
    nrows = len(cols[0].values) if cols else 0
    keys = []
    nulls = np.zeros(nrows, bool)
    for k in partition_by:
        t, cd = by[k]
        v = np.asarray(cd.values)
        keys.append(v.reshape(nrows, -1).astype(np.int64))
        if cd.valid is not None:
            nulls |= ~np.asarray(cd.valid, bool)
    key = np.concatenate(keys + [nulls[:, None].astype(np.int64)], axis=1)
    _, first, inverse = np.unique(key, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    nparts = 0
    for g in np.argsort(first, kind="stable").tolist():
        row = int(first[g])
        rendered = []
        for k in partition_by:
            t, cd = by[k]
            v = "None" if _is_null(cd, row) else _render(_py_value(t, cd, row))
            rendered.append(f"{k}={v}")
        idx = np.flatnonzero((inverse == g) & ~nulls)
        d = os.path.join(out_root, schema, table, *rendered)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"part-0.{fmt}")
        write(
            path,
            [n for n, _, _ in data],
            [t for _, t, _ in data],
            [_take(cd, idx) for _, _, cd in data],
        )
        nparts += 1
    return nparts


def _is_null(cd: ColumnData, i: int) -> bool:
    return cd.valid is not None and not bool(cd.valid[i])


def _take(cd: ColumnData, idx: np.ndarray) -> ColumnData:
    valid = None
    if cd.valid is not None:
        valid = np.asarray(cd.valid, bool)[idx]
        if valid.all():
            valid = None
    return ColumnData(np.asarray(cd.values)[idx], valid, cd.dictionary)


def _py_value(t: T.Type, cd: ColumnData, i: int):
    """Row i's value as the Python object Arrow's to_pylist gives."""
    import decimal

    v = np.asarray(cd.values)[i]
    if cd.dictionary is not None:
        return cd.dictionary.values[int(v)]
    if isinstance(t, T.DecimalType):
        if t.is_long:
            from trino_tpu_torch.types.int128 import join_py

            unscaled = join_py(int(v[0]), int(v[1]))
        else:
            unscaled = int(v)
        return decimal.Decimal(unscaled).scaleb(-t.scale, context=decimal.Context(prec=60))
    if t is T.DATE:
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
    if t is T.TIMESTAMP:
        return datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(v))
    return v.item()


def _render(v) -> str:
    if isinstance(v, datetime.date):
        return v.isoformat()
    return str(v)
