"""Intra-cluster authentication of the worker tier.

Reference role: internal-communication.shared-secret — when
TRINO_TPU_CLUSTER_SECRET is set, every intra-cluster mutation carries an
HMAC-SHA256 of its body under X-Cluster-Auth.  The coordinator's PUT
/v1/worker/register and /v1/worker/drain gate on it.

Port of `cluster_secret` and `sign_body` from trino_tpu/server/worker.py.
The rest of that module — WorkerServer, remote task execution over HTTP
and its exchange data plane — is not ported yet.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import os
from typing import Optional


def cluster_secret() -> Optional[bytes]:
    """Shared intra-cluster secret (reference:
    internal-communication.shared-secret)."""
    s = os.environ.get("TRINO_TPU_CLUSTER_SECRET")
    return s.encode() if s else None


def sign_body(secret: bytes, body: bytes) -> str:
    return _hmac.new(secret, body, hashlib.sha256).hexdigest()
