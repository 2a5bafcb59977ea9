"""Table layouts & partitioning-aware execution.

Makes partitioning a first-class property flowing from storage to the mesh:
connectors declare hash-bucketed `TableLayout`s; `derive_partitioning`
propagates "placed on symbols S across W workers" through the plan so the
exchange placer elides repartitions for co-partitioned joins and plans
single-stage aggregations; `speculative` sizes join expands without a host
capacity sync.  See each module's docstring for the contracts.
"""

from trino_tpu_torch.partitioning.layout import (
    GLOBAL_LAYOUTS,
    LayoutResolver,
    TableLayout,
    bucket_rows,
    declare_layout,
    drop_layout,
    hashable_layout_type,
    host_bucket_hash,
    parse_layout_property,
    scan_partitioning,
)
from trino_tpu_torch.partitioning.properties import (
    align_through_criteria,
    derive_dictionary_coding,
    derive_partitioning,
    hash_aligned_criteria,
    join_output_placements,
)
from trino_tpu_torch.partitioning.speculative import (
    CAP_HISTORY,
    CapacityHistory,
    initial_cap,
    next_cap,
    speculation_mode,
)

__all__ = [
    "GLOBAL_LAYOUTS",
    "LayoutResolver",
    "TableLayout",
    "bucket_rows",
    "declare_layout",
    "drop_layout",
    "hashable_layout_type",
    "host_bucket_hash",
    "parse_layout_property",
    "scan_partitioning",
    "align_through_criteria",
    "derive_dictionary_coding",
    "derive_partitioning",
    "hash_aligned_criteria",
    "join_output_placements",
    "CAP_HISTORY",
    "CapacityHistory",
    "initial_cap",
    "next_cap",
    "speculation_mode",
]
