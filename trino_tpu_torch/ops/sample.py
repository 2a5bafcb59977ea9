"""Row sampling operator (reference: operator/SampleOperator.java —
BERNOULLI keeps each row with probability p).

Port of trino_tpu/ops/sample.py.  The keep/drop decision is a splitmix64
hash of the row's arrival position under a salt derived from the
operator's plan position: a row is kept when the top 53 bits of
splitmix64(position + salt), read as a fraction of 2**53, fall below the
ratio.  Positions advance by each batch's capacity, dead slots included,
so the kept rows depend on the batches' capacities and their order; the
scan pads a page to the same power of two on every device, and the local
planner feeds the scans under a sample serially (runtime/local_planner.py
`_visit_SampleNode`), so the same statement samples the same rows on the
CPU and on the card, run after run.  uint64 arithmetic runs on int64 bit
patterns (ops/common.py `splitmix64`).
"""

from __future__ import annotations

import torch

from trino_tpu_torch.columnar import Batch
from trino_tpu_torch.ops.common import _i64_const, _shr_logical, splitmix64


def _salt(seed: int) -> int:
    """splitmix64(seed * 2 + 1) as a Python uint64."""
    u = splitmix64(torch.tensor([seed * 2 + 1], dtype=torch.int64))
    return int(u[0]) & ((1 << 64) - 1)


def sample_step(batch: Batch, offset: int, ratio: float) -> Batch:
    """Keep the rows where splitmix64(offset + slot) < ratio; `offset` is a
    Python uint64 (the salted arrival position of slot 0)."""
    pos = torch.arange(batch.capacity, dtype=torch.int64, device=batch.device)
    u = splitmix64(pos + _i64_const(offset & ((1 << 64) - 1)))
    # the top 53 bits -> uniform [0, 1)
    unif = _shr_logical(u, 11).to(torch.float64) * 2.0**-53
    return batch.filter(unif < ratio)


class SampleOperator:
    def __init__(self, ratio: float, seed: int = 0):
        self.ratio = float(ratio)
        self.salt = _salt(seed)
        self._offset = 0

    def process(self, stream):
        if self.ratio >= 1.0:
            yield from stream
            return
        for b in stream:
            if self.ratio <= 0.0:
                yield b.filter(torch.zeros(b.capacity, dtype=torch.bool, device=b.device))
            else:
                yield sample_step(b, self._offset + self.salt, self.ratio)
            self._offset += b.capacity
