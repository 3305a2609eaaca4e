"""REST controller for the serving registry (``openembedding_tpu/serving/rest.py``).

Routes, bodies and status codes follow the JAX package's controller:

* ``POST /models {"model_uri", "model_sign"?, "replica_num"=3,
  "block"=false}`` -> 201 + Location header
* ``GET /models`` / ``GET /models/<sign>`` -> status JSON;
  ``DELETE /models/<sign>``
* ``POST /models/<sign>/lookup {"variable", "indices", "int64"?}`` ->
  ``{"rows": [...]}``
* ``POST /models/<sign>/lookup_bin``: one JSON header line
  ``{"variable", "dtype", "shape"}`` then the raw ids; the response is a
  header line ``{"shape"}`` then raw float32 rows (byte-compatible with
  the JAX server; response compression is not offered)
* ``POST /models/<sign>/delta``: the bytes of
  ``checkpoint_delta.encode_delta`` -> ``{"applied", "version", ...}``
  (hot-swap; a stale seq 200 with ``applied: false``, a gap 409, garbage
  bytes 400)
* ``GET /health`` -> liveness + model catalog

Unknown routes are 404. In a GET or DELETE an unknown sign is 404; in a
POST a missing key or bad value is 400 (as in the JAX server, where an
unknown sign in a lookup is also 400), a model that is not NORMAL 409,
anything else 500. No spans or ``/metrics`` in this slice.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..utils.device import DeviceLike
from .registry import ModelRegistry

DEFAULT_PORT = 8010


def _host_f32(rows: torch.Tensor) -> np.ndarray:
    return rows.detach().to(torch.float32).cpu().numpy()


def make_handler(registry: ModelRegistry):

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive needs Content-Length on every response (all
        # paths send it); TCP_NODELAY keeps header and body from waiting on
        # the peer's delayed ACK; the timeout bounds an idle connection's
        # handler thread
        protocol_version = "HTTP/1.1"
        timeout = 5
        disable_nagle_algorithm = True

        def log_message(self, *a):  # quiet test output
            pass

        def _send(self, code: int, obj=None, location: str = None):
            body = json.dumps(obj).encode() if obj is not None else b""
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if location:
                self.send_header("Location", location)
            self.end_headers()
            self.wfile.write(body)

        def _send_bytes(self, payload: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _raw(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def _body(self):
            return json.loads(self._raw() or b"{}")

        def do_GET(self):
            try:
                if self.path == "/health":
                    models = registry.show_models()
                    return self._send(200, {
                        "ok": True, "models": models,
                        "applied_seq": max(
                            (int(m.get("version", 0)) for m in models),
                            default=0)})
                if self.path == "/models":
                    return self._send(200, registry.show_models())
                m = re.fullmatch(r"/models/([^/]+)", self.path)
                if m:
                    return self._send(200, registry.show_model(m.group(1)))
                self._send(404, {"error": "not found"})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

        def do_POST(self):
            try:
                if self.path == "/models":
                    req = self._body()
                    sign = registry.create_model(
                        req["model_uri"],
                        model_sign=req.get("model_sign"),
                        replica_num=int(req.get("replica_num", 3)),
                        num_shards=int(req.get("num_shards", -1)),
                        shard_index=int(req.get("shard_index", 0)),
                        shard_count=int(req.get("shard_count", 1)),
                        block=bool(req.get("block", False)))
                    return self._send(201, {"model_sign": sign},
                                      location=f"/models/{sign}")
                m = re.fullmatch(r"/models/([^/]+)/lookup", self.path)
                if m:
                    req = self._body()
                    rows = registry.lookup(
                        m.group(1), req["variable"],
                        np.asarray(req["indices"], dtype=np.int64
                                   if req.get("int64") else np.int32))
                    return self._send(200,
                                      {"rows": _host_f32(rows).tolist()})
                m = re.fullmatch(r"/models/([^/]+)/delta", self.path)
                if m:
                    # a trainer-published delta (encode_delta frame)
                    # patched into the loaded model under version gating
                    return self._send(200, registry.apply_delta(
                        m.group(1), self._raw()))
                m = re.fullmatch(r"/models/([^/]+)/lookup_bin", self.path)
                if m:
                    raw = self._raw()
                    nl = raw.index(b"\n")
                    head = json.loads(raw[:nl])
                    idx = np.frombuffer(
                        raw[nl + 1:], dtype=np.dtype(head["dtype"])
                    ).reshape(head.get("shape", [-1]))
                    rows = _host_f32(registry.lookup(
                        m.group(1), head["variable"], idx))
                    hdr = json.dumps({"shape": list(rows.shape)}).encode()
                    return self._send_bytes(hdr + b"\n" + rows.tobytes())
                self._send(404, {"error": "not found"})
            except (KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except RuntimeError as e:
                self._send(409, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

        def do_DELETE(self):
            try:
                m = re.fullmatch(r"/models/([^/]+)", self.path)
                if m:
                    registry.delete_model(m.group(1))
                    return self._send(200, {"deleted": m.group(1)})
                self._send(404, {"error": "not found"})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

    return Handler


class ControllerServer:
    """Threaded HTTP controller in front of a ``ModelRegistry``.

    ``registry=None`` makes one on ``device`` (cuda unless named). ``port=0``
    binds a free port, readable from ``.port``.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1", *,
                 device: DeviceLike = None):
        self.registry = registry if registry is not None \
            else ModelRegistry(device=device)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.registry))
        # non-daemon handler threads: server_close() joins in-flight
        # requests, so stop() never cuts a response short
        self.httpd.daemon_threads = False
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True,
                                        name=f"oe-rest-{self.port}")

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        """Stop accepting, join in-flight requests and async loads."""
        if self._thread.ident is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.registry.close(timeout)
