"""Physical operators on torch (port of trino_tpu/ops).

Each operator is a host-side generator over Batch streams; device math is
torch over whole columnar batches:

  ScanFilterAndProjectOperator  -> scan.ScanOperator + filter_project
  HashAggregationOperator       -> aggregation (direct / sort-based reduce,
                                   grouped_sums kernel behind `pallas_agg`)
  TopNOperator                  -> sort.TopNOperator
  OrderByOperator               -> sort.OrderByOperator
  LimitOperator                 -> sort.LimitOperator
  ValuesOperator                -> values.ValuesOperator
  WindowOperator                -> window.WindowOperator
"""
