"""HTTP serving of pose estimation, standard library only (port of
``islx/serve/http.py``, same wire contract).

    POST /pose      image bytes (jpg/png) -> JSON {candidate, subset, hands}
    GET  /healthz   liveness and the batcher's stats -> JSON {ok, ...}

A body over 32 MB (or empty) gets 413 after a bounded drain, an image
cv2 cannot decode 400, any other path 404. Requests go through one
:class:`islx_torch.serve.batcher.MicroBatcher`, so concurrent clients share
fused steps; ThreadingHTTPServer gives each connection a thread, and all
device work stays on the batcher's worker. Decoding a POST body needs cv2.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from islx_torch.serve.batcher import MicroBatcher

MAX_BODY = 32 * 1024 * 1024


def _json_bytes(obj) -> bytes:
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.integer, np.floating)):
            return o.item()
        raise TypeError(type(o))

    return json.dumps(obj, default=default).encode()


def _decode(data: bytes) -> Optional[np.ndarray]:
    """Image bytes -> u8 BGR frame, or None where cv2 cannot decode them."""
    import cv2

    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


class PoseServer:
    """Own the batcher and the HTTP server; start()/close() lifecycle."""

    def __init__(self, pipe, host: str = "127.0.0.1", port: int = 8008,
                 max_batch: int = 8, max_wait_ms: float = 15.0,
                 request_timeout_s: float = 120.0, quantize_after=None,
                 aot_dir=None):
        self.batcher = MicroBatcher(pipe, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms,
                                    quantize_after=quantize_after,
                                    aot_dir=aot_dir)
        self._timeout = request_timeout_s
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: bytes,
                       ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, _json_bytes(
                        {"ok": True, **server.batcher.stats()}))
                else:
                    self._reply(404, b'{"error": "not found"}')

            def do_POST(self):
                if self.path != "/pose":
                    self._reply(404, b'{"error": "not found"}')
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._reply(400, b'{"error": "bad Content-Length"}')
                    return
                if n <= 0 or n > MAX_BODY:
                    # drain in bounded chunks so the client can read the
                    # error; an empty read is a client that went away
                    left = n
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            break
                        left -= len(chunk)
                    self._reply(413, b'{"error": "body must be 1B-32MB"}')
                    return
                try:
                    img = _decode(self.rfile.read(n))
                except ImportError:
                    self._reply(500, b'{"error": "decoding needs cv2"}')
                    return
                if img is None:
                    self._reply(400, b'{"error": "undecodable image"}')
                    return
                try:
                    res = server.batcher.pose(img, timeout=server._timeout)
                except Exception as exc:
                    self._reply(500, _json_bytes({"error": str(exc)}))
                    return
                self._reply(200, _json_bytes({
                    "candidate": res.candidate, "subset": res.subset,
                    "hands": list(res.hands)}))

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
