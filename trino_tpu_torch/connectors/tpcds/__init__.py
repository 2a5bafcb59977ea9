"""TPC-DS generator connector (reference: plugin/trino-tpcds —
TpcdsConnectorFactory/TpcdsMetadata/TpcdsRecordSet over the teradata dsdgen
port).  Schema/row-counts follow the public TPC-DS spec; data is produced by
the same counter-based vectorized generator design as the tpch connector
(pure function of (table, column, row)), not a dsdgen port — distributions
are simplified but key structure, FK consistency, calendar dimensions, and
sales/returns linkage are spec-shaped, and the pandas oracle runs over the
identical data.
"""

from trino_tpu_torch.connectors.tpcds.connector import TpcdsConnector
