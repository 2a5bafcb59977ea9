"""Coordinator reverse proxy.

Reference role: client/trino-proxy (ProxyResource.java — forwards
/v1/statement and nextUri traffic to a backing coordinator, rewriting the
URIs in responses so clients keep talking to the proxy).

Port of trino_tpu/server/proxy.py: a copy that also forwards the client's
Authorization header, so a coordinator with an authenticator can sit behind
it (the JAX proxy drops the header), and listens with the coordinator's
backlog.  Its backend request timeout is the
JAX package's compiled-in default (the lifecycle config section that
overrides it there is not ported).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import Optional

from trino_tpu_torch.server.coordinator import HTTPServer

#: per-request timeout of a forwarded call (seconds)
HTTP_TIMEOUT_S = 600.0


class ProxyServer:
    """HTTP proxy in front of a coordinator: POST /v1/statement and GET
    nextUri pages pass through; URIs in the JSON are rewritten to point at
    the proxy."""

    def __init__(self, backend_url: str, port: int = 0):
        self.backend_url = backend_url.rstrip("/")
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n)
                proxy._forward(self, "POST", self.path, body)

            def do_GET(self):
                proxy._forward(self, "GET", self.path, None)

            def do_DELETE(self):
                proxy._forward(self, "DELETE", self.path, None)

        self._httpd = HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "ProxyServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="proxy"
        )
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- forwarding ----------------------------------------------------------

    def _forward(self, handler, method: str, path: str, body) -> None:
        req = urllib.request.Request(
            self.backend_url + path, data=body, method=method
        )
        for h in ("Content-Type", "Authorization", "X-Trino-User", "X-Trino-Session"):
            v = handler.headers.get(h)
            if v:
                req.add_header(h, v)
        try:
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
                payload = resp.read()
                status = resp.status
                ctype = resp.headers.get("Content-Type", "application/json")
        except urllib.error.HTTPError as e:
            payload = e.read()
            status = e.code
            ctype = e.headers.get("Content-Type", "application/json")
        except Exception as e:  # backend down
            payload = json.dumps({"error": str(e)}).encode()
            status = 502
            ctype = "application/json"
        payload = self._rewrite(payload)
        handler.send_response(status)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(payload)))
        handler.end_headers()
        handler.wfile.write(payload)

    def _rewrite(self, payload: bytes) -> bytes:
        """Point nextUri/infoUri at the proxy (ProxyResource's URI rewrite)."""
        try:
            doc = json.loads(payload)
        except (ValueError, UnicodeDecodeError):
            return payload
        changed = self._rewrite_uris(doc)
        return json.dumps(doc).encode() if changed else payload

    def _rewrite_uris(self, doc) -> bool:
        changed = False
        if isinstance(doc, dict):
            for key, val in doc.items():
                if (
                    key in ("nextUri", "infoUri", "partialCancelUri")
                    and isinstance(val, str)
                    and val.startswith(self.backend_url)
                ):
                    doc[key] = self.url + val[len(self.backend_url):]
                    changed = True
                else:
                    changed |= self._rewrite_uris(val)
        elif isinstance(doc, list):
            for item in doc:
                changed |= self._rewrite_uris(item)
        return changed
