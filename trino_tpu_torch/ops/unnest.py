"""UNNEST operator: array columns expanded into rows.

Port of trino_tpu/ops/unnest.py (reference: operator/unnest/
UnnestOperator.java + UnnestBlockBuilder): each input row is replicated
once per element of its unnested array(s); several arrays zip, the shorter
padded with NULLs; WITH ORDINALITY appends the 1-based element index.

Arrays are rectangular [capacity, K] blocks (columnar/column.py), so the
unnest is a reshape: row r is replicated to K output slots and slot (r, k)
is live iff k < the largest of the row's array lengths.  The output
capacity is capacity * K; the next operator that needs dense rows compacts.
"""

from __future__ import annotations

import torch

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column
from trino_tpu_torch.columnar.column import pad_slots
from trino_tpu_torch.expr import ExprCompiler


class UnnestOperator:
    """`exprs` evaluate to array values over the input batch; every input
    channel passes through, replicated."""

    def __init__(self, exprs, with_ordinality: bool = False):
        self.exprs = list(exprs)
        self.with_ordinality = with_ordinality

    def step(self, batch: Batch) -> Batch:
        c = ExprCompiler(batch)
        cap = batch.capacity
        dev = batch.device
        arrays = []
        for e in self.exprs:
            v = c.value(e)
            if v.lengths is None:
                raise NotImplementedError("UNNEST of non-array value")
            data = torch.broadcast_to(v.data, (cap, v.data.shape[-1]))
            lens = torch.broadcast_to(v.lengths.to(torch.int32), (cap,))
            if v.valid is False:
                lens = torch.zeros_like(lens)
            elif v.valid is not None:
                lens = torch.where(v.valid, lens, 0)  # a NULL array has no rows
            arrays.append((data, lens, v))
        k = max(1, max(a[0].shape[1] for a in arrays))
        pos = torch.arange(k, dtype=torch.int32, device=dev)[None, :]  # [1, K]
        max_lens = arrays[0][1]
        for _, lens, _v in arrays[1:]:
            max_lens = torch.maximum(max_lens, lens)
        live2 = torch.logical_and(batch.mask()[:, None], pos < max_lens[:, None])
        # the replicated source columns: each row index repeats K times
        rep = torch.arange(cap, dtype=torch.int64, device=dev).repeat_interleave(k)
        cols = [col.gather(rep) for col in batch.columns]
        for data, lens, v in arrays:
            flat = pad_slots(data, k - data.shape[1]).reshape(cap * k)
            evalid = (pos < lens[:, None]).reshape(cap * k)
            cols.append(Column(flat, v.type.element, evalid, v.dictionary))
        if self.with_ordinality:
            ordv = (pos + 1).to(torch.int64).expand(cap, k).reshape(cap * k)
            cols.append(Column(ordv, T.BIGINT))
        return Batch(cols, live2.reshape(cap * k))

    def process(self, stream):
        for batch in stream:
            yield self.step(batch)
