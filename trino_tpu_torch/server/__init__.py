"""Coordinator HTTP server + client protocol.

Reference layer: core/trino-main/.../server + server/protocol — the
`/v1/statement` REST protocol (QueuedStatementResource.java:102,
ExecutingStatementResource.java:73): POST submits SQL, the client follows
`nextUri` long-polls until FINISHED, receiving paged JSON rows.

Port of trino_tpu/server/: the coordinator, the statement protocol,
authentication and access control, the web UI and the proxy are copies
with the package renamed; of worker.py only the intra-cluster secret and
body signature are ported (its WorkerServer and task tier are not yet).
"""

from trino_tpu_torch.server.coordinator import CoordinatorServer
