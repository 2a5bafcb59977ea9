"""Row pattern recognition operator (MATCH_RECOGNIZE).

Port of trino_tpu/ops/pattern.py (reference roles: sql/planner/rowpattern/
(IrRowPattern + Parser), operator/window/matcher/Matcher.java (the NFA
program interpreter) and PatternRecognitionPartition).

The split of the work: everything per-row and data-parallel — the sort by
(partition, order) keys and the DEFINE predicates, PREV/NEXT navigation
included (partition-masked shifts, `$nav_prev`/`$nav_next` in
expr/functions.py) — runs on the device over the whole sorted input, one
vectorized mask per variable.  Only the sequential part — walking the
leftmost-greedy regex over each partition's classification bits, and
building the measures — runs on the host, over numpy copies; the
reference also runs that part one row at a time.  PATTERN_LOG records
each run's device and host seconds.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.batch import concat_batches
from trino_tpu_torch.columnar.dictionary import StringDictionary
from trino_tpu_torch.expr.ir import Call, Expr, InputRef, Literal, visit
from trino_tpu_torch.ops.common import SortKey, multi_key_sort_perm, next_pow2

#: one entry per operator run: (rows, partitions, matches, device seconds
#: (compaction, sort, DEFINE masks, the copy to the host), host seconds of
#: the pattern walk, host seconds of the measures and output columns);
#: read and cleared by callers that time the walk (bounded)
PATTERN_LOG: deque = deque(maxlen=4096)


# -- pattern AST + parser ----------------------------------------------------
# grammar (SqlBase.g4 rowPattern, the concatenation/alternation/quantifier
# subset): alt := seq ('|' seq)* ; seq := factor+ ; factor := primary quant? ;
# primary := VAR | '(' alt ')' ; quant := '*' | '+' | '?' | '{' n [',' [m]] '}'


@dataclass
class PVar:
    name: str


@dataclass
class PSeq:
    parts: list


@dataclass
class PAlt:
    options: list


@dataclass
class PQuant:
    child: object
    lo: int
    hi: Optional[int]  # None = unbounded
    greedy: bool = True


def parse_pattern(text: str):
    tokens: list = []
    i = 0
    while i < len(text):
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "()|*+?{}," or c.isdigit():
            tokens.append(c)
            i += 1
        elif c.isalpha() or c == "_":
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] == "_"):
                j += 1
            tokens.append(text[i:j].lower())
            i = j
        else:
            raise ValueError(f"unsupported pattern token {c!r} in {text!r}")
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def alt():
        opts = [seq()]
        while peek() == "|":
            take()
            opts.append(seq())
        return opts[0] if len(opts) == 1 else PAlt(opts)

    def seq():
        parts = []
        while peek() is not None and peek() not in ")|":
            parts.append(factor())
        if not parts:
            raise ValueError(f"empty pattern branch in {text!r}")
        return parts[0] if len(parts) == 1 else PSeq(parts)

    def number():
        ds = ""
        while peek() is not None and peek().isdigit():
            ds += take()
        if not ds:
            raise ValueError(f"expected number in quantifier of {text!r}")
        return int(ds)

    def factor():
        t = take()
        if t == "(":
            node = alt()
            if take() != ")":
                raise ValueError(f"unbalanced parens in {text!r}")
        elif t is not None and (t[0].isalpha() or t[0] == "_"):
            node = PVar(t)
        else:
            raise ValueError(f"unexpected {t!r} in pattern {text!r}")
        q = peek()
        if q == "*":
            take()
            return PQuant(node, 0, None)
        if q == "+":
            take()
            return PQuant(node, 1, None)
        if q == "?":
            take()
            return PQuant(node, 0, 1)
        if q == "{":
            take()
            lo = number()
            hi: Optional[int] = lo
            if peek() == ",":
                take()
                hi = number() if peek() is not None and peek().isdigit() else None
            if take() != "}":
                raise ValueError(f"unbalanced {{}} in {text!r}")
            return PQuant(node, lo, hi)
        return node

    out = alt()
    if pos[0] != len(tokens):
        raise ValueError(f"trailing pattern input in {text!r}")
    return out


def pattern_variables(node, acc=None) -> list:
    if acc is None:
        acc = []
    if isinstance(node, PVar):
        if node.name not in acc:
            acc.append(node.name)
    elif isinstance(node, PSeq):
        for p in node.parts:
            pattern_variables(p, acc)
    elif isinstance(node, PAlt):
        for p in node.options:
            pattern_variables(p, acc)
    elif isinstance(node, PQuant):
        pattern_variables(node.child, acc)
    return acc


# -- matcher -----------------------------------------------------------------


def _match_from(node, i: int, end: int, ok, var_ix: dict, labels: list):
    """Generator of end positions for matching `node` starting at row i,
    in regex preference order (greedy quantifiers try longest first).
    `labels` accumulates the classifier per consumed row; generators restore
    it on backtrack."""
    if isinstance(node, PVar):
        v = var_ix[node.name]
        if i < end and ok[v][i]:
            labels.append(node.name)
            yield i + 1
            labels.pop()
        return
    if isinstance(node, PSeq):
        yield from _match_seq(node.parts, 0, i, end, ok, var_ix, labels)
        return
    if isinstance(node, PAlt):
        for opt in node.options:
            yield from _match_from(opt, i, end, ok, var_ix, labels)
        return
    if isinstance(node, PQuant):
        yield from _match_quant(node, i, end, ok, var_ix, labels, 0)
        return
    raise TypeError(node)


def _match_seq(parts, k, i, end, ok, var_ix, labels):
    if k == len(parts):
        yield i
        return
    for j in _match_from(parts[k], i, end, ok, var_ix, labels):
        mark = len(labels)
        yield from _match_seq(parts, k + 1, j, end, ok, var_ix, labels)
        del labels[mark:]


def _match_quant(node, i, end, ok, var_ix, labels, count):
    """Greedy: consume as many repetitions as possible first; `count` is
    repetitions consumed so far."""
    if node.hi is None or count < node.hi:
        for j in _match_from(node.child, i, end, ok, var_ix, labels):
            if j == i:
                break  # zero-width repetition guard
            mark = len(labels)
            yield from _match_quant(node, j, end, ok, var_ix, labels, count + 1)
            del labels[mark:]
    if count >= node.lo:
        yield i


# -- operator ----------------------------------------------------------------


class _HostColumn:
    """One sorted source column on the host: numpy data, validity and
    dictionary, read by row."""

    __slots__ = ("data", "valid", "dictionary")

    def __init__(self, col: Column, n: int):
        self.data = col.data[:n].cpu().numpy()
        self.valid = None if col.valid is None else col.valid[:n].cpu().numpy()
        self.dictionary = col.dictionary

    def value(self, r: int):
        if self.valid is not None and not self.valid[r]:
            return None
        v = self.data[r]
        if self.dictionary is not None:
            return self.dictionary.values[int(v)]
        return v


class PatternRecognitionOperator:
    """Materialize -> device sort -> device DEFINE masks -> host regex walk
    -> host-built output batch."""

    def __init__(self, node, source_symbols: list, device: torch.device):
        self.node = node  # P.PatternRecognitionNode, DEFINEs over the source layout
        self.source_symbols = list(source_symbols)
        self.device = device
        self.pattern = parse_pattern(node.pattern)
        # variables without a DEFINE entry match any row (the reference's
        # implicit TRUE definition): `ok` starts all-true in process()
        self.vars = pattern_variables(self.pattern)

    def _channel(self, name: str) -> int:
        for i, s in enumerate(self.source_symbols):
            if s.name == name:
                return i
        raise KeyError(name)

    def process(self, stream):
        batches = list(stream)
        if not batches:
            return
        t0 = time.perf_counter()
        big = concat_batches(batches) if len(batches) > 1 else batches[0]
        n = big.num_rows_host()
        if n == 0:
            return
        cap = next_pow2(n, floor=1)
        big = big.compact_device(out_capacity=cap)
        node = self.node
        keys = [SortKey(self._channel(s.name)) for s in node.partition_by] + [
            SortKey(self._channel(s.name), ascending=asc, nulls_first=nf)
            for s, asc, nf in node.order_by
        ]
        if keys:
            perm = multi_key_sort_perm(big, keys)
            big = big.gather(perm, valid=big.mask()[perm])
        host = [_HostColumn(c, n) for c in big.columns]
        live_h = big.mask()[:n].cpu().numpy()
        # partition ids from the sorted partition-key runs: a partition
        # starts wherever any key's (value, validity) changes — collision
        # free and null-safe
        change = np.zeros(n, dtype=bool)
        for s in node.partition_by:
            c = host[self._channel(s.name)]
            neq = c.data[1:] != c.data[:-1]
            change[1:] |= neq.any(axis=1) if neq.ndim > 1 else neq
            if c.valid is not None:
                change[1:] |= c.valid[1:] != c.valid[:-1]
        pid = np.cumsum(change)
        # DEFINE masks on the device: prev/next become $nav calls over the
        # pid channel appended to the batch; dead slots get pid -1, so
        # navigation never treats them as in-partition
        pid_col = Column(
            torch.from_numpy(np.pad(pid, (0, cap - n), constant_values=-1)).to(big.device),
            T.BIGINT,
        )
        dev = Batch(list(big.columns) + [pid_col], big.row_mask)
        pid_ch = len(big.columns)

        def rewrite_nav(e: Expr) -> Expr:
            def fn(x: Expr) -> Expr:
                if isinstance(x, Call) and x.name in ("prev", "next"):
                    k = x.args[1] if len(x.args) > 1 else Literal(1, T.BIGINT)
                    return Call(
                        "$nav_prev" if x.name == "prev" else "$nav_next",
                        [x.args[0], k, InputRef(pid_ch, T.BIGINT)],
                        x.type,
                    )
                return x

            return visit(e, fn)

        from trino_tpu_torch.expr import ExprCompiler

        compiler = ExprCompiler(dev)
        defines = dict(node.defines)
        masks = []
        for v in self.vars:
            cond = defines.get(v)
            masks.append(
                torch.ones(n, dtype=torch.bool, device=big.device) if cond is None
                else compiler.filter_mask(rewrite_nav(cond))[:n]
            )
        ok = torch.stack(masks).cpu().numpy() & live_h[None, :]
        t1 = time.perf_counter()
        var_ix = {v: i for i, v in enumerate(self.vars)}
        matches = self._walk(n, pid, ok, var_ix)
        t2 = time.perf_counter()
        out = self._build_output(host, matches)
        PATTERN_LOG.append(
            (n, int(pid[-1]) + 1, len(matches), t1 - t0, t2 - t1, time.perf_counter() - t2)
        )
        yield out

    # -- matching + output ----------------------------------------------------

    def _walk(self, n: int, pid, ok, var_ix) -> list:
        """(start, end, labels, match_number) of every match: the leftmost
        greedy match from each candidate row of each partition."""
        after_past_last = self.node.after_match == "past_last"
        rows_ok = [row.tolist() for row in ok]  # list indexing beats numpy's per row
        starts = np.flatnonzero(np.concatenate(([True], pid[1:] != pid[:-1])))
        bounds = starts.tolist() + [n]
        matches = []
        for b in range(len(bounds) - 1):
            lo, hi = bounds[b], bounds[b + 1]
            i = lo
            mno = 0  # MATCH_NUMBER() restarts per partition (SQL-2016)
            while i < hi:
                labels: list = []
                got = None
                for end in _match_from(self.pattern, i, hi, rows_ok, var_ix, labels):
                    got = (end, list(labels))
                    break
                if got is not None and got[0] > i:
                    mno += 1
                    matches.append((i, got[0], got[1], mno))
                    i = got[0] if after_past_last else i + 1
                else:
                    i += 1
        return matches

    def _measure_values(self, host: list, s0: int, e0: int, labels, mno) -> list:
        out = []
        for _sym, m in self.node.measures:
            if m.kind == "match_number":
                out.append(mno)
                continue
            if m.kind == "classifier":
                out.append(labels[-1] if labels else None)
                continue
            if m.kind == "agg" and m.source is None:  # count(*)
                out.append(e0 - s0)
                continue
            rows = range(s0, e0)
            if m.var is not None:
                rows = [r for r, lab in zip(range(s0, e0), labels) if lab == m.var]
            col = host[self._channel(m.source.name)]
            vals = [col.value(r) for r in rows]
            if m.kind in ("first", "last"):
                ix = m.offset if m.kind == "first" else len(vals) - 1 - m.offset
                out.append(vals[ix] if 0 <= ix < len(vals) else None)
                continue
            live_vals = [v for v in vals if v is not None]
            if m.agg == "count":
                out.append(len(live_vals))
            elif not live_vals:
                out.append(None)
            elif m.agg == "sum":
                out.append(sum(live_vals))
            elif m.agg == "min":
                out.append(min(live_vals))
            elif m.agg == "max":
                out.append(max(live_vals))
            elif m.agg == "avg":
                out.append(float(sum(live_vals)) / len(live_vals))
            else:
                raise NotImplementedError(f"measure agg {m.agg}")
        return out

    def _build_output(self, host: list, matches) -> Batch:
        node = self.node
        one = node.rows_per_match == "one"
        per_col: list = [[] for _ in node.outputs]
        part_ch = [self._channel(s.name) for s in node.partition_by]
        for s0, e0, labels, mno in matches:
            measures = self._measure_values(host, s0, e0, labels, mno)
            if one:
                row = [host[ch].value(s0) for ch in part_ch] + measures
                for ci, v in enumerate(row):
                    per_col[ci].append(v)
                continue
            for off, r in enumerate(range(s0, e0)):
                row_measures = list(measures)
                # the per-row classifier under ALL ROWS PER MATCH
                for mi, (_s, m) in enumerate(node.measures):
                    if m.kind == "classifier":
                        row_measures[mi] = labels[off]
                row = [c.value(r) for c in host] + row_measures
                for ci, v in enumerate(row):
                    per_col[ci].append(v)
        count = len(per_col[0]) if per_col else 0
        cap = next_pow2(count, floor=1)  # dead slots pad to a power of two
        cols = [
            _column_from_python(sym.type, values, cap, self.device)
            for sym, values in zip(node.outputs, per_col)
        ]
        mask = torch.arange(cap, device=self.device) < count
        return Batch(cols, mask)


def _column_from_python(t: T.Type, values: list, cap: int, device: torch.device) -> Column:
    """A device column of `cap` slots from raw host values (decimals as
    their scaled integers, dates as days, strings as Python str), None
    for NULL."""
    valid = np.zeros(cap, dtype=bool)
    valid[: len(values)] = [v is not None for v in values]
    if T.is_string_kind(t):
        present = [v for v in values if v is not None]
        d = StringDictionary.from_unsorted(present)
        codes = np.zeros(cap, dtype=np.int32)
        codes[: len(values)] = d.encode(values)
        return Column.from_numpy(codes, t, valid, d, device=device)
    long_dec = isinstance(t, T.DecimalType) and t.is_long
    arr = np.zeros((cap, 2) if long_dec else cap, dtype=t.np_dtype)
    for i, v in enumerate(values):
        if v is None:
            continue
        if long_dec and np.ndim(v) == 0:
            from trino_tpu_torch.types.int128 import split_py

            v = split_py(int(v))
        arr[i] = v
    return Column.from_numpy(arr, t, valid, device=device)
