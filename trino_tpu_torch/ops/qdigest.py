"""Log-bucketed quantile sketch for the global approx_percentile.

Port of trino_tpu/ops/qdigest.py (reference: operator/aggregation/
ApproximateLongPercentileAggregations.java, qdigest states): a fixed-size,
mergeable quantile state, so a global approx_percentile never gathers
whole groups on one node.  The reference's qdigest is a sparse tree over
value prefixes; here the same log-structured bucketing is flattened to a
dense count vector, so building is one scatter-add and merging is an
elementwise addition.

Buckets: sign x (256 octaves) x (32 sub-buckets per octave), plus a zero
bucket — 16,385 slots, ascending by value.  Relative value resolution is
1/64 per bucket (~1.6%); the rank is exact within the histogram, so the
estimate is the true percentile's bucket representative.

Every step is exact integer or exact frexp arithmetic, so the state equals
the JAX package's bit for bit.  Two rules follow XLA's conversions there:
a subnormal counts as zero (XLA flushes denormals), and an infinity takes
frexp's exponent 0 and the top sub-bucket (a saturating float-to-int
cast); NaN counts in the zero bucket.
"""

from __future__ import annotations

import numpy as np
import torch

SUB_BITS = 5
SUBS = 1 << SUB_BITS  # 32 sub-buckets per octave
OCTAVES = 256  # exponents -128..127
HALF = OCTAVES * SUBS  # buckets per sign
NBUCKETS = 2 * HALF + 1  # negatives, zero, positives

#: the smallest normal float64: below it a value counts as zero
_F64_TINY = 2.2250738585072014e-308


def bucket_ids(f: torch.Tensor) -> torch.Tensor:
    """float64 values -> ascending bucket ids in [0, NBUCKETS), int64."""
    f = f.to(torch.float64)
    a = f.abs()
    normal = a >= _F64_TINY  # False for NaN and subnormals
    finite = torch.isfinite(a)
    m, e = torch.frexp(torch.where(finite, a, 1.0))  # a = m * 2**e, m in [0.5, 1)
    e = torch.where(finite, e.to(torch.int64), 0)
    e = (e + 128).clamp(0, OCTAVES - 1)
    sub = torch.where(finite, ((m - 0.5) * (2 * SUBS)).to(torch.int64), SUBS - 1)
    mag = e * SUBS + sub.clamp(0, SUBS - 1)  # ascending magnitude
    pos = torch.logical_and(normal, f > 0)
    neg = torch.logical_and(normal, f < 0)
    return torch.where(pos, HALF + 1 + mag, torch.where(neg, HALF - 1 - mag, HALF))


def _rep_table() -> np.ndarray:
    """Representative (midpoint) value per bucket, ascending."""
    e = np.arange(OCTAVES) - 128
    sub = np.arange(SUBS)
    m_mid = 0.5 + (sub[None, :] + 0.5) / (2 * SUBS)  # [oct, sub]
    # frexp convention: a = m * 2**e with m in [0.5, 1)
    mag = (m_mid * np.exp2(e[:, None])).reshape(-1)  # ascending
    table = np.empty(NBUCKETS, np.float64)
    table[HALF] = 0.0
    table[HALF + 1:] = mag
    table[:HALF] = -mag[::-1]
    return table


REPS = _rep_table()


def histogram(f: torch.Tensor, valid: torch.Tensor, nbuckets: int = NBUCKETS) -> torch.Tensor:
    """int64 count vector [nbuckets] over the valid values (the partial
    state); integer adds, so any order gives the same counts."""
    ids = bucket_ids(f)
    counts = torch.zeros(nbuckets, dtype=torch.int64, device=f.device)
    return counts.index_add_(0, ids, valid.to(torch.int64))


def estimate(counts: torch.Tensor, p: float):
    """(value estimate float64, total count) from a merged count vector,
    both 0-dim tensors."""
    counts = counts.to(torch.int64)
    total = counts.sum()
    target = torch.floor(p * (total - 1).clamp(min=0).to(torch.float64)).to(torch.int64)
    cum = torch.cumsum(counts, 0)
    # the first bucket whose cumulative count exceeds the target rank (the
    # first, 0, when none does: the JAX package's argmax)
    idx = (cum > target).to(torch.int8).argmax()
    reps = torch.from_numpy(REPS).to(counts.device)
    return reps[idx], total
