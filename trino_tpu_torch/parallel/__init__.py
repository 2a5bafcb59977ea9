"""Distributed execution over a mesh of logical workers.

Port of trino_tpu/parallel (reference layer: execution/scheduler +
operator/exchange + execution/buffer).  Here a "worker" is a logical worker
on one torch device; stages run per worker over stacked per-worker batches;
exchanges are on-device permutations of the stacked tensors (all-to-all
repartition, all-gather broadcast, gather to the coordinator's local
engine).  A mesh across several cards is not ported yet.
"""

from trino_tpu_torch.parallel.spmd import WorkerMesh, stack_batches, unstack_batch
from trino_tpu_torch.parallel.runner import DistributedQueryRunner
