"""REST controller for the serving registry (``openembedding_tpu/serving/rest.py``).

Routes, bodies and status codes follow the JAX package's controller:

* ``POST /models {"model_uri", "model_sign"?, "replica_num"=3,
  "block"=false}`` -> 201 + Location header
* ``GET /models`` / ``GET /models/<sign>`` -> status JSON;
  ``DELETE /models/<sign>``
* ``POST /models/<sign>/lookup {"variable", "indices", "int64"?}`` ->
  ``{"rows": [...]}``
* ``POST /models/<sign>/lookup_bin``: one JSON header line
  ``{"variable", "dtype", "shape", "accept_compress"?}`` then the raw ids;
  the response is a header line ``{"shape", "compress"?}`` then the raw
  float32 rows, compressed when the server has a codec and the client
  advertised it (byte-compatible with the JAX server)
* ``POST /models/<sign>/delta``: the bytes of
  ``checkpoint_delta.encode_delta`` -> ``{"applied", "version", ...}``
  (hot-swap; a stale seq 200 with ``applied: false``, a gap 409, garbage
  bytes 400)
* ``GET /models/<sign>/meta`` -> the model's meta, version and variables
  (the peer restore reads it); ``GET /models/<sign>/rows?variable=V&
  offset=O&limit=L[&compress=C]`` -> one JSON header line ``{"n",
  "total", "dim", "dtype", "compress"?}`` then ``n`` int64 ids and their
  rows (a bfloat16 table's rows as raw 16-bit words)
* ``GET /health`` -> liveness + model catalog; ``GET /cluster`` -> the
  liveness of this replica's peers; ``GET /metrics`` -> the Prometheus
  text of ``observability.prometheus_text``
* ``GET /nodes`` / ``GET /nodes/<id>`` -> the registry's device;
  ``DELETE /nodes/<id>`` is 501 (one serving process has no per-node
  shutdown)

Unknown routes are 404. In a GET or DELETE an unknown sign is 404 and a
bad codec 400; in a POST a missing key or bad value is 400 (an unknown
sign in a lookup too, as in JAX), a full batcher queue 429, a model that
is not NORMAL 409, anything else 500. Each request runs under an
``http`` span (method, route and status labels) in the trace of the
client's ``X-OE-Trace`` header, and counts in ``serving_requests`` by
method, route and status.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..analysis import scope
from ..utils.device import DeviceLike
from .batcher import BusyError
from .registry import ModelRegistry

DEFAULT_PORT = 8010

# clients stamp each request with this header (ha.RoutingClient) and the
# handler re-enters the id, so server-side spans join the client's trace
TRACE_HEADER = "X-OE-Trace"

# per-model operations get their own route label; the <sign> segment is
# folded away to keep the labels few
_MODEL_OPS = ("lookup_bin", "lookup", "delta", "rows", "meta")


def _route(path: str) -> str:
    """Low-cardinality route label: the first path segment
    (``/models/<sign>`` -> ``/models``) plus the operation of a per-model
    op (``/models/<sign>/lookup_bin`` -> ``/models/lookup_bin``)."""
    segs = path.lstrip("/").split("?", 1)[0].split("/")
    if not segs or not segs[0]:
        return "/"
    if segs[0] == "models" and len(segs) >= 3:
        op = segs[2]
        if op in _MODEL_OPS:
            return f"/models/{op}"
    return "/" + segs[0]


def probe_health(endpoint: str, timeout: float = 1.0):
    """GET /health against ``host:port``; the JSON, or None if dead."""
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://{endpoint}/health",
                                    timeout=timeout) as r:
            return json.loads(r.read())
    except Exception:  # noqa: BLE001 — any failure = not alive
        return None


def probe_nodes(endpoints):
    """Liveness and catalog of each endpoint (``/cluster`` and
    ``RoutingClient.nodes``)."""
    out = []
    for ep in endpoints:
        h = probe_health(ep)
        out.append({"endpoint": ep, "alive": bool(h and h.get("ok")),
                    "models": [m.get("model_sign")
                               for m in (h or {}).get("models", [])]})
    return out


def _host_f32(rows) -> np.ndarray:
    """Rows as host float32: a device tensor (direct lookup) or the host
    array a batched lookup answers."""
    if isinstance(rows, torch.Tensor):
        return rows.detach().to(torch.float32).cpu().numpy()
    return np.asarray(rows, dtype=np.float32)


def _row_page(rows: torch.Tensor):
    """A ``/rows`` page's rows: (dtype name, raw bytes)."""
    if rows.dtype == torch.bfloat16:
        return "bfloat16", rows.contiguous().view(torch.int16).numpy() \
            .tobytes()
    arr = rows.contiguous().numpy()
    return arr.dtype.name, arr.tobytes()


def make_handler(registry: ModelRegistry, peers=None, compress: str = ""):
    """``compress``: the codec of binary response bodies. A ``lookup_bin``
    response is compressed only when the client advertised the codec
    (``accept_compress``); a row page takes the requester's
    ``&compress=``."""
    from ..utils import compress as compress_lib
    compress = compress_lib.check(compress)
    peers = list(peers or [])

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

        def send_response(self, code, message=None):
            # every response path passes here: stamp the status on the
            # request span
            sp = getattr(self, "_span", None)
            if sp is not None:
                sp.set_label("status", str(int(code)))
            super().send_response(code, message)

        def _serve(self, method: str, handler):
            """One request under the client's trace id and an ``http``
            span, counted by method, route and status."""
            tid = (self.headers.get(TRACE_HEADER) or "")[:64]
            route = _route(self.path)
            with scope.trace_context(tid) if tid \
                    else contextlib.nullcontext():
                with scope.span("http", method=method, route=route,
                                detail={"path": self.path}) as sp:
                    self._span = sp
                    try:
                        handler()
                    finally:
                        self._span = None
                        status = (sp.labels or {}).get("status", "none")
                        scope.HISTOGRAMS.inc("serving_requests",
                                             method=method, route=route,
                                             status=status)

        def _send(self, code: int, obj=None, location: str = None):
            body = json.dumps(obj).encode() if obj is not None else b""
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if location:
                self.send_header("Location", location)
            self.end_headers()
            self.wfile.write(body)

        def _send_bytes(self, payload: bytes,
                        content_type: str = "application/octet-stream"):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _raw(self) -> bytes:
            return self.rfile.read(int(self.headers.get("Content-Length", 0)))

        def _body(self):
            return json.loads(self._raw() or b"{}")

        def do_GET(self):
            self._serve("GET", self._handle_GET)

        def _handle_GET(self):
            try:
                if self.path == "/health":
                    models = registry.show_models()
                    return self._send(200, {
                        "ok": True, "models": models,
                        "applied_seq": max(
                            (int(m.get("version", 0)) for m in models),
                            default=0)})
                if self.path == "/cluster":
                    return self._send(200, probe_nodes(peers))
                if self.path == "/metrics":
                    from ..utils.observability import prometheus_text
                    return self._send_bytes(prometheus_text().encode(),
                                            "text/plain; version=0.0.4")
                if self.path == "/models":
                    return self._send(200, registry.show_models())
                m = re.fullmatch(r"/models/([^/]+)/meta", self.path)
                if m:
                    # what a peer restore rebuilds the specs from, and the
                    # version its streamed rows reflect
                    model = registry.find_model(m.group(1))
                    st = registry.show_model(m.group(1))
                    return self._send(200, {
                        "meta": model.meta.dumps(),
                        "shard_index": st.get("shard_index", 0),
                        "shard_count": st.get("shard_count", 1),
                        "version": model.version,
                        "variables": [
                            {"name": name,
                             "use_hash": model.collection.specs[
                                 name].use_hash}
                            for name in model.collection.specs]})
                m = re.fullmatch(
                    r"/models/([^/]+)/rows\?variable=([^&]+)"
                    r"&offset=(\d+)&limit=(\d+)(?:&compress=(\w+))?",
                    self.path)
                if m:
                    model = registry.find_model(m.group(1))
                    ids, rows, total = model.export_rows(
                        m.group(2), int(m.group(3)), int(m.group(4)))
                    codec = compress_lib.check(m.group(5) or "")
                    dtype, row_bytes = _row_page(rows)
                    head = {"n": int(ids.shape[0]), "total": int(total),
                            "dim": int(rows.shape[1]) if rows.dim() == 2
                            else 0,
                            "dtype": dtype}
                    body = ids.astype(np.int64).tobytes() + row_bytes
                    if codec:
                        head["compress"] = codec
                        body = compress_lib.compress(codec, body)
                    return self._send_bytes(
                        json.dumps(head).encode() + b"\n" + body)
                m = re.fullmatch(r"/models/([^/]+)", self.path)
                if m:
                    return self._send(200, registry.show_model(m.group(1)))
                if self.path == "/nodes":
                    return self._send(200, registry.show_nodes())
                m = re.fullmatch(r"/nodes/(\d+)", self.path)
                if m:
                    nodes = [n for n in registry.show_nodes()
                             if n["node_id"] == int(m.group(1))]
                    if not nodes:
                        return self._send(404, {"error": "no such node"})
                    return self._send(200, nodes[0])
                self._send(404, {"error": "not found"})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except ValueError as e:
                # an unknown codec: the client's error (a peer restore
                # falls back to raw pages on it)
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

        def do_POST(self):
            self._serve("POST", self._handle_POST)

        def _handle_POST(self):
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
                    rhead = {"shape": list(rows.shape)}
                    body = rows.tobytes()
                    if compress and compress in head.get(
                            "accept_compress", ()):
                        rhead["compress"] = compress
                        body = compress_lib.compress(compress, body)
                    hdr = json.dumps(rhead).encode()
                    return self._send_bytes(hdr + b"\n" + body)
                self._send(404, {"error": "not found"})
            except (KeyError, ValueError) as e:
                self._send(400, {"error": str(e)})
            except BusyError as e:
                # the batcher's bounded queue refused the offer (a
                # RuntimeError, so caught before the 409 below)
                scope.HISTOGRAMS.inc("serving_rejected_requests")
                self._send(429, {"error": str(e)})
            except RuntimeError as e:
                self._send(409, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

        def do_DELETE(self):
            self._serve("DELETE", self._handle_DELETE)

        def _handle_DELETE(self):
            try:
                m = re.fullmatch(r"/models/([^/]+)", self.path)
                if m:
                    registry.delete_model(m.group(1))
                    return self._send(200, {"deleted": m.group(1)})
                if re.fullmatch(r"/nodes/\d+", self.path):
                    return self._send(501, {
                        "error": "single SPMD serving process has no "
                                 "per-node shutdown; stop the process"})
                self._send(404, {"error": "not found"})
            except KeyError as e:
                self._send(404, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the client
                self._send(500, {"error": str(e)})

    return Handler


class ControllerServer:
    """Threaded HTTP controller in front of a ``ModelRegistry``.

    ``registry=None`` makes one on ``device`` (cuda unless named). ``port=0``
    binds a free port, readable from ``.port``. ``peers``: the endpoints
    ``/cluster`` probes; ``compress``: the codec of ``lookup_bin``
    responses to clients that accept it.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 port: int = DEFAULT_PORT, host: str = "127.0.0.1", *,
                 device: DeviceLike = None, peers=None, compress: str = ""):
        self.registry = registry if registry is not None \
            else ModelRegistry(device=device)
        self.httpd = ThreadingHTTPServer(
            (host, port),
            make_handler(self.registry, peers, compress=compress))
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
        """Stop accepting, join in-flight requests and async loads, drain
        the registry's batchers."""
        if self._thread.ident is not None:
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout)
        self.registry.close(timeout)
