"""Replicated serving (``openembedding_tpu/serving/ha.py``): replica
daemons, failover routing, restore on respawn.

A serving process holds one full copy of every table on its device, so a
process IS a replica and replication is "run N identical daemons":

- :func:`replica_main` (``python -m openembedding_tpu_torch.serving.ha``)
  and :func:`spawn_replica`: one replica daemon, a registry behind a REST
  controller, on ``--device`` (cuda unless ``cpu`` is named; with no GPU
  and no device named it raises). Booting with ``--peers`` restores the
  catalog of a living replica (GET /health) by loading each model from
  its checkpoint URI, or, when the URI cannot be read, by streaming its
  rows from the peer (:func:`restore_model_from_peer`, ``GET
  /models/<sign>/rows``);
- :class:`RoutingClient`: lookups start at a random replica, rotate past
  dead and busy ones (409/429/503) and back off under one deadline
  (:class:`RetryPolicy`) before failing; keep-alive connections, one per
  thread and endpoint, with Nagle off (:class:`_NoDelayHTTPConnection`);
  ``create_model`` and ``push_delta`` go to every replica;
- liveness: every replica answers GET /health, GET /cluster probes its
  peers, and :meth:`RoutingClient.nodes` probes the fleet.

- shard groups: a model larger than one process serves from ``G``
  groups of replicas, group ``k`` holding the ids or keys ≡ k (mod G)
  (``--shard_index k --shard_count G``, ``registry.create_model``);
  :class:`ShardedRoutingClient` partitions a lookup by owner, sends each
  group its part through that group's failover rotation and merges the
  rows by position. A replica of a group restores its slice, from the
  dump or from a peer of its group.
"""

from __future__ import annotations

import dataclasses
import http.client
import io
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analysis import scope
from ..analysis.concurrency import sync_point
from ..utils import compress as compress_lib
from ..utils import observability
from .rest import TRACE_HEADER, probe_health, probe_nodes

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --- replica daemon ---------------------------------------------------------

def replica_main(argv: Optional[Sequence[str]] = None) -> int:
    """Entry point of one serving replica: registry + REST controller.

    --port P          REST port (0 = ephemeral, printed on stdout)
    --load SIGN=URI   model(s) to serve at boot (repeatable)
    --peers H:P,...   living replicas; restore their catalog on boot
    --device D        cuda (default when a GPU is present) or cpu
    """
    import argparse
    p = argparse.ArgumentParser(prog="python -m openembedding_tpu_torch."
                                     "serving.ha")
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--load", action="append", default=[])
    p.add_argument("--peers", default="")
    p.add_argument("--device", default=None,
                   help="cuda or cpu; with no GPU and no device named "
                        "the replica refuses to start")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1,
                   help=">1 serves a shard slice (a later slice: the "
                        "load raises)")
    p.add_argument("--hash_capacity", type=int, default=None)
    p.add_argument("--config", default="",
                   help="EnvConfig JSON file (serving section: port, "
                        "hash_capacity, message_compress, batch_*)")
    p.add_argument("--compress", default=None,
                   help="binary data-plane codec (''|zlib|zstd); "
                        "overrides the config file")
    p.add_argument("--batch-rows", type=int, default=None,
                   help="arm the micro-batcher with this per-flush row "
                        "cap (0 = unbatched)")
    p.add_argument("--batch-wait-us", type=int, default=None,
                   help="the flush's wait budget in microseconds")
    p.add_argument("--batch-queue-rows", type=int, default=None,
                   help="bounded batcher queue in rows; offers past it "
                        "get 429")
    p.add_argument("--adaptive", action="store_true",
                   help="arm the online tuner inside the config's plan "
                        "envelope (as OE_PLAN_ONLINE=1)")
    p.add_argument("--trace-out", default="",
                   help="record spans and write them as Chrome-trace JSON "
                        "here at a SIGTERM or ctrl-C shutdown")
    args = p.parse_args(argv)

    from .registry import ModelRegistry
    from .rest import ControllerServer
    from ..utils.envconfig import EnvConfig

    cfg_tree = EnvConfig.load(path=args.config or None)
    cfg = cfg_tree.serving
    chaos = cfg_tree.apply_chaos()
    if chaos is not None:
        print(f"replica: CHAOS armed ({len(chaos.faults)} fault(s))",
              flush=True)
    port = args.port if args.port is not None else cfg.port
    hash_capacity = (args.hash_capacity if args.hash_capacity is not None
                     else cfg.hash_capacity)
    compress = (args.compress if args.compress is not None
                else cfg.message_compress)

    registry = ModelRegistry(device=args.device,
                             default_hash_capacity=hash_capacity)
    # SIGTERM is an orderly unwind: the finally below drains the batchers,
    # writes the trace and reports the kernel launches (SIGKILL loses all)
    import signal as signal_mod
    signal_mod.signal(signal_mod.SIGTERM, lambda *_: sys.exit(0))
    if args.trace_out:
        scope.set_tracing(True)
    batch_rows = (args.batch_rows if args.batch_rows is not None
                  else cfg.batch_rows)
    if batch_rows > 0:
        plan_cfg = cfg_tree.plan
        if args.adaptive and not plan_cfg.online:
            plan_cfg = dataclasses.replace(plan_cfg, online=True)
        registry.enable_batching(
            max_batch_rows=batch_rows,
            max_wait_us=(args.batch_wait_us
                         if args.batch_wait_us is not None
                         else cfg.batch_wait_us),
            max_queue_rows=(args.batch_queue_rows
                            if args.batch_queue_rows is not None
                            else cfg.batch_queue_rows),
            plan=plan_cfg if plan_cfg.online else None)
        mode = (f"adaptive [{plan_cfg.rows_floor}, "
                f"{plan_cfg.rows_ceiling}]" if plan_cfg.online
                else "static")
        print(f"replica: micro-batching armed (rows={batch_rows}, "
              f"{mode})", flush=True)
    peers = [e for e in args.peers.split(",") if e]
    server = ControllerServer(registry, port=port, peers=peers,
                              compress=compress).start()
    print(f"replica: listening on {server.port} ({registry.device})",
          flush=True)

    try:
        for item in args.load:
            sign, _, uri = item.partition("=")
            registry.create_model(uri, model_sign=sign or None, block=True,
                                  shard_index=args.shard_index,
                                  shard_count=args.shard_count)
            print(f"replica: loaded {sign or uri}", flush=True)

        if peers:
            n = restore_from_peers(registry, peers, compress=compress)
            print(f"replica: restored {n} model(s) from peers", flush=True)

        if batch_rows > 0:
            # build the bucket pulls before declaring ready: the first
            # storm must meet steady state, not captures
            t0 = time.perf_counter()
            n = registry.warm_batch_programs()
            print(f"replica: warmed {n} batched pull program(s) in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)

        print("replica: ready", flush=True)
        while True:
            time.sleep(3600)
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        # on any exit, a failed boot load too: join the accept loop and
        # quiesce loaders and batchers
        server.stop()
        from ..ops.gather import gather_rows
        from ..ops.probe_gather import probe_gather
        print("replica: kernel launches " + json.dumps(
            {"gather_rows": gather_rows.launches,
             "probe_gather": probe_gather.launches}), flush=True)
        if args.trace_out:
            scope.export_chrome_trace(
                args.trace_out, process_name=f"oe-replica:{server.port}")
            print(f"replica: trace -> {args.trace_out}", flush=True)
    return 0


def restore_from_peers(registry, peers: Sequence[str],
                       wait: float = 30.0, compress: str = "") -> int:
    """Re-create every NORMAL model the living ``peers`` serve (never pass
    the replica's own endpoint). Peers still loading (CREATING) are polled
    for up to ``wait`` seconds. A model whose checkpoint URI cannot be
    read is rebuilt from a living peer's rows
    (:func:`restore_model_from_peer`). Returns the number restored."""
    deadline = time.time() + wait
    catalog: Dict[str, tuple] = {}
    slices: Dict[str, tuple] = {}
    while True:
        catalog.clear()
        creating = False
        for ep in peers:
            h = probe_health(ep, timeout=3.0)
            if not h or not h.get("ok"):
                continue
            for m in h.get("models", []):
                status = m.get("model_status")
                if status == "NORMAL":
                    catalog.setdefault(m["model_sign"],
                                       (m["model_uri"], ep))
                    slices.setdefault(m["model_sign"],
                                      (int(m.get("shard_index", 0)),
                                       int(m.get("shard_count", 1))))
                elif status == "CREATING":
                    creating = True
        if not creating or time.time() >= deadline:
            break
        time.sleep(0.5)
    # the catalog is settled: every restore below re-creates a model a
    # living peer served as NORMAL
    sync_point("ha.restore.catalog")
    n = 0
    for sign, (uri, ep) in catalog.items():
        try:
            sync_point("ha.restore.model")
            k, g = slices[sign]
            # a shard group's peer serves its group's slice: load the same
            registry.create_model(uri, model_sign=sign, block=True,
                                  shard_index=k, shard_count=g)
            n += 1
        except ValueError:
            pass  # already loading/loaded locally
        except (RuntimeError, OSError) as e:
            # the load failed or the dump URI is gone: stream the rows
            # from the living peer instead
            print(f"replica: dump restore of {sign!r} from {uri!r} failed "
                  f"({e}); streaming rows from peer {ep}", flush=True)
            try:
                restore_model_from_peer(registry, ep, sign,
                                        compress=compress)
                n += 1
            except Exception as e2:  # noqa: BLE001 — logged, not fatal
                print(f"replica: peer-row restore of {sign!r} failed: "
                      f"{e2}", flush=True)
    return n


def fetch_rows_page(endpoint: str, sign: str, variable: str, offset: int,
                    limit: int, timeout: float = 60.0,
                    compress: str = ""):
    """One page of a peer's rows: ``(ids, rows, total)``, ids int64 and
    rows a CPU tensor in the table's dtype (a ``bfloat16`` page arrives as
    16-bit words). ``compress`` asks the peer to pack the page."""
    url = (f"http://{endpoint}/models/{sign}/rows?variable={variable}"
           f"&offset={offset}&limit={limit}")
    if compress:
        url += f"&compress={compress}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        raw = r.read()
    nl = raw.index(b"\n")
    head = json.loads(raw[:nl])
    body = raw[nl + 1:]
    if head.get("compress"):
        body = compress_lib.decompress(head["compress"], body)
    n = head["n"]
    ids = np.frombuffer(body[:n * 8], np.int64).copy()
    words = body[n * 8:]
    if head["dtype"] == "bfloat16":
        rows = torch.from_numpy(np.frombuffer(words, np.int16).copy()) \
            .view(torch.bfloat16)
    else:
        rows = torch.from_numpy(
            np.frombuffer(words, np.dtype(head["dtype"])).copy())
    return ids, rows.reshape(n, head["dim"]), head["total"]


def restore_model_from_peer(registry, endpoint: str, sign: str, *,
                            page: int = 1 << 16,
                            timeout: float = 60.0,
                            compress: str = "") -> str:
    """Rebuild ``sign`` from a LIVING replica's memory alone: its meta
    (``GET /models/<sign>/meta``) gives the specs, empty states are made
    on the registry's device, and every variable's rows are paged over
    ``GET /models/<sign>/rows`` into them (hash keys by insertion, array
    rows by id). The model starts at the peer's version. A shard-group
    peer's model is rebuilt as the same group's slice: its pages carry
    global ids, which this replica maps into its slice's rows. Returns
    the sign."""
    from .. import hash_table as hash_lib
    from .. import table as table_lib
    from ..embedding import EmbeddingCollection
    from ..meta import ModelMeta
    from .registry import ServingModel, _specs_from_meta

    with urllib.request.urlopen(
            f"http://{endpoint}/models/{sign}/meta", timeout=timeout) as r:
        info = json.loads(r.read())
    meta = ModelMeta.loads(info["meta"])
    shard_slice = ((int(info["shard_index"]), int(info["shard_count"]))
                   if int(info.get("shard_count", 1)) > 1 else None)
    coll = EmbeddingCollection(
        _specs_from_meta(meta, registry.default_hash_capacity,
                         shard_slice=shard_slice),
        device=registry.device)
    dev = coll.device
    codec = compress

    def fetch(vname, off):
        nonlocal codec
        try:
            return fetch_rows_page(endpoint, sign, vname, off, page,
                                   timeout, compress=codec)
        except urllib.error.HTTPError as e:
            if codec and e.code in (400, 404):
                # the peer does not offer this codec: raw pages will do
                codec = ""
                return fetch_rows_page(endpoint, sign, vname, off, page,
                                       timeout)
            raise

    out = {}
    for name, spec in coll.specs.items():
        offset, total = 0, None
        if spec.use_hash:
            state = coll.init(only=[name])[name]
            while total is None or offset < total:
                ids, rows, total = fetch(name, offset)
                offset += page
                if not ids.size:
                    continue
                keys = hash_lib.split64(ids) if state.wide \
                    else ids.astype(np.int32)
                hash_lib.insert_rows(state, torch.from_numpy(keys).to(dev),
                                     rows.to(dev))
            if int(state.insert_failures) > 0:
                raise RuntimeError(
                    f"peer restore of {name!r}: rows did not fit the "
                    "local hash capacity")
            out[name] = state
        else:
            weights = torch.zeros(
                (spec.input_dim, spec.output_dim),
                dtype=table_lib.resolve_dtype(spec.meta()), device=dev)
            while total is None or offset < total:
                ids, rows, total = fetch(name, offset)
                offset += page
                if not ids.size:
                    continue
                if shard_slice is not None:
                    k, g = shard_slice
                    mine = (ids % g) == k
                    ids, rows = ids[mine] // g, rows[torch.from_numpy(mine)]
                weights.index_copy_(0, torch.from_numpy(ids).to(dev),
                                    rows.to(dev, weights.dtype))
            out[name] = table_lib.TableState(weights=weights, slots={})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model = ServingModel(sign, coll, out, meta,
                         version=int(info.get("version", 0)),
                         shard_slice=shard_slice)
    return registry.register_model(model)


def spawn_replica(port: int, *, load: Sequence[str] = (),
                  peers: Sequence[str] = (),
                  env: Optional[Dict[str, str]] = None,
                  device: str = "cuda",
                  compress: str = "",
                  trace_out: str = "",
                  batch_rows: int = 0,
                  batch_wait_us: Optional[int] = None,
                  batch_queue_rows: Optional[int] = None,
                  adaptive: bool = False,
                  config: str = "",
                  shard_index: int = 0,
                  shard_count: int = 1) -> subprocess.Popen:
    """Start a replica daemon as a child process on ``device`` (cuda
    unless the caller names cpu); its stdout and stderr are piped.
    ``shard_count`` > 1: a member of shard group ``shard_index``, whose
    ``load`` items load that group's slice."""
    cmd = [sys.executable, "-m", "openembedding_tpu_torch.serving.ha",
           "--port", str(port), "--device", str(device)]
    if shard_count > 1:
        cmd += ["--shard_index", str(shard_index),
                "--shard_count", str(shard_count)]
    if config:
        cmd += ["--config", config]
    if compress:
        cmd += ["--compress", compress]
    if trace_out:
        cmd += ["--trace-out", trace_out]
    if batch_rows:
        cmd += ["--batch-rows", str(batch_rows)]
        if batch_wait_us is not None:
            cmd += ["--batch-wait-us", str(batch_wait_us)]
        if batch_queue_rows is not None:
            cmd += ["--batch-queue-rows", str(batch_queue_rows)]
        if adaptive:
            cmd += ["--adaptive"]
    for item in load:
        cmd += ["--load", item]
    if peers:
        cmd += ["--peers", ",".join(peers)]
    child_env = {**os.environ, **(env or {})}
    child_env["PYTHONPATH"] = _PKG_ROOT + os.pathsep + child_env.get(
        "PYTHONPATH", "")
    return subprocess.Popen(cmd, env=child_env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_ready(endpoint: str, timeout: float = 120.0,
               sign: Optional[str] = None) -> bool:
    """Poll /health until the replica answers (and serves ``sign`` if
    given); False at the deadline."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        h = probe_health(endpoint)
        if h and h.get("ok"):
            if sign is None:
                return True
            for m in h.get("models", []):
                if m.get("model_sign") == sign and \
                        m.get("model_status") == "NORMAL":
                    return True
        time.sleep(0.3)
    return False


# --- routing client ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """ONE deadline-budgeted retry policy for every RoutingClient verb.

    Replaces the ad-hoc per-verb behavior (lookups: one rotation then
    raise; delta pushes: one attempt per endpoint, no retry) with a
    shared budget: a logical request may spend ``deadline_s`` of wall
    clock total, across however many fleet rotations fit, with
    exponential backoff + jitter between rounds (decorrelated enough
    that a thundering herd of clients doesn't re-storm a recovering
    replica in lockstep). The deadline is a REQUEST property, not an
    attempt property — the per-connection HTTP timeout stays separate
    (``RoutingClient(timeout=)``) and bounds one socket wait.

    Budget spending is observable: ``oe_serving_retry_rounds_total``
    counts full-fleet rounds that failed and backed off,
    ``oe_serving_retry_budget_exhausted_total`` counts requests that
    died at the deadline, and the existing retry/failover counters keep
    their per-attempt meaning.
    """

    deadline_s: float = 10.0
    base_backoff_s: float = 0.05
    max_backoff_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5       # sleep *= uniform(1 - jitter, 1)

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError("jitter must be in [0, 1]")

    def backoff(self, round_index: int) -> float:
        """Jittered sleep before round ``round_index + 1`` (0-based:
        backoff(0) follows the first failed round)."""
        raw = min(self.max_backoff_s,
                  self.base_backoff_s * self.multiplier ** round_index)
        return raw * (1.0 - self.jitter * random.random())

class _NoDelayHTTPConnection(http.client.HTTPConnection):
    """Persistent client connection with Nagle disabled.

    A kept-alive connection carries each request as (at least) two
    small writes — header block, then body. With Nagle on, the second
    write queues behind the server's delayed ACK of the first: a flat
    ~40 ms added to EVERY request (measured on loopback; the
    interaction the keep-alive satellite exists to remove, reappearing
    one layer down). The server handler disables Nagle on its side for
    the same reason (rest.py ``disable_nagle_algorithm``)."""

    def connect(self):
        super().connect()
        import socket as socket_mod
        try:
            self.sock.setsockopt(socket_mod.IPPROTO_TCP,
                                 socket_mod.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transports (tests with mocks) just skip it


class RoutingClient:
    """Failover lookup client over N replica endpoints.

    The reference's replica selection + retry: start at a random replica
    (load spreading, ``pick_one_replica(PickAlgo)``), rotate on failure,
    raise only when every replica failed. Dead endpoints are remembered as
    suspect and probed again on later calls (a respawned replica rejoins
    automatically — there is no registration step, matching the reference
    where the master only tracks liveness).
    """

    def __init__(self, endpoints: Sequence[str], timeout: float = 10.0,
                 compress: str = "",
                 policy: Optional[RetryPolicy] = None):
        if not endpoints:
            raise ValueError("need at least one replica endpoint")
        self.endpoints = list(endpoints)
        self.timeout = timeout
        # the per-request budget defaults to the per-connection timeout:
        # a caller that accepted waiting `timeout` on one socket accepts
        # the same wall budget for the whole retry dance
        self.policy = policy if policy is not None \
            else RetryPolicy(deadline_s=timeout)
        # last delta version each endpoint ACKed, per sign — feeds the
        # degraded-replica staleness gauge (push_delta)
        self._acked_versions: Dict[tuple, int] = {}
        # advertised to servers on binary lookups; responses from servers
        # configured with the same message_compress codec arrive packed
        self.compress = compress_lib.check(compress)
        # keep-alive connection pool: one persistent HTTP/1.1 connection
        # per (thread, endpoint) — lookups used to open a fresh TCP
        # connection per request, so connect setup inflated every
        # measured serving latency. Per-THREAD pools keep the hot path
        # lock-free (http.client connections are not thread-safe); the
        # flat registry below exists only so close() can drop sockets
        # opened by worker threads that already exited.
        self._tls = threading.local()
        self._conns_lock = threading.Lock()
        self._conns: List[http.client.HTTPConnection] = []

    # -- raw http (keep-alive pool) ----------------------------------------
    def _connection(self, endpoint: str):
        """(conn, reused): this thread's persistent connection to
        ``endpoint``, opening one on first use."""
        pool = getattr(self._tls, "conns", None)
        if pool is None:
            pool = self._tls.conns = {}
        conn = pool.get(endpoint)
        if conn is not None:
            if conn.sock is not None:
                return conn, True
            # a pooled conn whose socket is gone (client close(), idle
            # teardown): http.client's auto_open would silently
            # reconnect with a socket neither close() nor the
            # connection counter ever sees — treat as a pool miss
            self._drop_connection(endpoint)
        host, sep, port = endpoint.rpartition(":")
        if not sep:
            host, port = endpoint, "80"   # bare hostname, like urllib
        conn = _NoDelayHTTPConnection(host, int(port),
                                      timeout=self.timeout)
        pool[endpoint] = conn
        with self._conns_lock:
            self._conns.append(conn)
        scope.HISTOGRAMS.inc("serving_client_connections",
                             endpoint=endpoint)
        return conn, False

    def _drop_connection(self, endpoint: str) -> None:
        pool = getattr(self._tls, "conns", None)
        conn = pool.pop(endpoint, None) if pool else None
        if conn is not None:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — already broken
                pass
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def close(self) -> None:
        """Close every pooled connection (all threads). Call when done
        with the client — otherwise each idle kept-alive socket pins a
        server handler thread until the server-side idle timeout."""
        with self._conns_lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            try:
                conn.close()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def __enter__(self) -> "RoutingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _raw(self, endpoint: str, method: str, path: str,
             body: Optional[bytes], content_type: str) -> bytes:
        """One HTTP round trip on the pooled connection. A failure on a
        REUSED connection retries once on a fresh one (a server-side
        idle close is not a dead replica); HTTP error statuses raise
        ``urllib.error.HTTPError`` so the failover rotation keeps its
        status-code semantics."""
        headers = {"Content-Type": content_type}
        tid = scope.current_trace_id()
        if tid:
            headers[TRACE_HEADER] = tid
        while True:
            conn, reused = self._connection(endpoint)
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()   # drain fully: keeps conn reusable
                status, reason = resp.status, resp.reason
                rheaders = resp.headers
                break
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_connection(endpoint)
                if not reused:
                    raise
                # stale keep-alive connection — one fresh retry (reads
                # and delta pushes are both idempotent)
        if status >= 400:
            raise urllib.error.HTTPError(
                f"http://{endpoint}{path}", status, reason, rheaders,
                io.BytesIO(data))
        return data

    def _request(self, endpoint: str, method: str, path: str,
                 body: Optional[dict] = None) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        payload = self._raw(endpoint, method, path, data,
                            "application/json")
        return json.loads(payload) if payload else None

    def _rotate(self, attempt) -> Any:
        """Shared failover rotation under the ONE retry policy: start at
        a random replica (load spreading), rotate on dead/busy replicas
        — the reference's pick_one_replica + retry — and when a whole
        round fails, back off (exponential + jitter) and rotate again
        until the per-request deadline is spent. Every attempt is
        recorded as a ``serving.rpc`` span labeled with the replica and
        its outcome (ok / ok_failover / busy / failover), carrying the
        active trace id — the router leg of the request-scoped Perfetto
        story — and bumps the ``serving_request_retries`` /
        ``serving_request_failovers`` counters on /metrics; failed
        rounds bump ``serving_retry_rounds`` and a request that dies at
        the deadline bumps ``serving_retry_budget_exhausted``."""
        policy = self.policy
        deadline = time.monotonic() + policy.deadline_s
        order = list(self.endpoints)
        start = random.randrange(len(order))
        order = order[start:] + order[:start]
        last_err: Optional[Exception] = None
        busy429: Optional[Exception] = None
        rnd = 0
        while True:
            for i, ep in enumerate(order):
                t0 = time.perf_counter()
                try:
                    # inside the try: an injected drop (chaos drop_net
                    # at this marker) classifies as a dead replica and
                    # rotates, exactly like a real connection loss
                    sync_point("routing.attempt")
                    out = attempt(ep)
                # NOTE: HTTPError subclasses URLError — it must be caught
                # first, else every 404 would read as a dead replica
                except urllib.error.HTTPError as e:
                    dt = time.perf_counter() - t0
                    # 409/503: CREATING etc; 429: batcher queue full —
                    # THIS replica is oversubscribed, another may have
                    # headroom
                    if e.code in (409, 429, 503):  # busy: try another
                        scope.record_span(
                            "serving.rpc", t0, dt,
                            {"replica": ep, "outcome": "busy"},
                            error=f"HTTP{e.code}")
                        scope.HISTOGRAMS.inc("serving_request_retries")
                        last_err = e
                        if e.code == 429:
                            busy429 = e
                        continue
                    scope.record_span("serving.rpc", t0, dt,
                                      {"replica": ep, "outcome": "error"},
                                      error=f"HTTP{e.code}")
                    raise
                except (urllib.error.URLError, http.client.HTTPException,
                        ConnectionError, OSError, TimeoutError) as e:
                    # dead/unreachable replica — including one killed mid-
                    # response (IncompleteRead/RemoteDisconnected): rotate
                    scope.record_span("serving.rpc", t0,
                                      time.perf_counter() - t0,
                                      {"replica": ep,
                                       "outcome": "failover"},
                                      error=type(e).__name__)
                    scope.HISTOGRAMS.inc("serving_request_failovers")
                    last_err = e
                    continue
                scope.record_span(
                    "serving.rpc", t0, time.perf_counter() - t0,
                    {"replica": ep,
                     "outcome": "ok" if rnd == 0 and i == 0
                     else "ok_failover"})
                return out
            if busy429 is not None:
                # SOME replica rejected with batcher backpressure (even
                # if the others were dead — the chaos + backpressure
                # mix): surface the 429 itself NOW, without spending
                # retry budget — backpressure is an ANSWER, not an
                # outage, and the caller (a load generator) must count a
                # rejection promptly so overload propagates instead of
                # amplifying into deadline-long client stalls. Tracked
                # on its own flag: last_err holds whichever replica
                # failed LAST in rotation order, which under a mixed
                # storm is a coin flip between the dead and busy one.
                raise busy429
            # the whole fleet is DEAD this round: spend retry budget —
            # a respawning replica (the kill-and-respawn chaos lane)
            # rejoins within a backoff or two
            sleep = policy.backoff(rnd)
            rnd += 1
            if time.monotonic() + sleep >= deadline:
                scope.HISTOGRAMS.inc("serving_retry_budget_exhausted")
                break
            scope.HISTOGRAMS.inc("serving_retry_rounds")
            time.sleep(sleep)
        raise ConnectionError(
            f"no live replica among {self.endpoints} within "
            f"{policy.deadline_s:.3g}s ({rnd} round(s)): {last_err}")

    def _failover(self, method: str, path: str, body=None) -> Any:
        return self._rotate(
            lambda ep: self._request(ep, method, path, body))

    def _request_bin(self, endpoint: str, path: str, body: bytes) -> bytes:
        return self._raw(endpoint, "POST", path, body,
                         "application/octet-stream")

    # -- serving API -------------------------------------------------------
    def lookup(self, sign: str, variable: Any, indices) -> np.ndarray:
        """Read-only pull with replica failover (never fails while one
        replica lives — the chaos-test invariant). Rides the BINARY
        protocol — the default data plane (the reference's serving plane is
        zero-copy binary throughout, server/RpcView.h:63-105); see
        :meth:`lookup_json` for the debug-friendly JSON twin."""
        return self.lookup_bin(sign, variable, indices)

    def lookup_json(self, sign: str, variable: Any, indices) -> np.ndarray:
        """JSON-marshalled pull (human-readable wire, for debugging)."""
        with scope.trace_context(), \
                scope.span("client.lookup", proto="json"):
            out = self._failover(
                "POST", f"/models/{sign}/lookup",
                {"variable": variable,
                 "indices": np.asarray(indices).tolist()})
        return np.asarray(out["rows"], dtype=np.float32)

    def lookup_bin(self, sign: str, variable: Any, indices) -> np.ndarray:
        """Binary-protocol pull: packed ids out, packed f32 rows back — no
        JSON list marshalling (the reference's zero-copy RpcView role,
        server/RpcView.h). The request header carries the index SHAPE, so
        wide [n, 2] pair queries and multi-dim batch shapes reconstruct
        exactly server-side. NOTE the wide-spec shape carve-out
        (registry.ServingModel.lookup): on a WIDE spec any trailing dim
        of 2 is a pair axis — send a genuine narrow length-2 sequence as
        ``[B, L, 2]`` pairs or pad it to L != 2. When the client was
        built with a ``compress`` codec it is ADVERTISED here
        (``accept_compress``); a server
        configured with the same ``message_compress`` codec compresses the
        row payload (the reference's compressed pull responses,
        EmbeddingPullOperator.cpp:149-205). Same failover rotation as
        :meth:`lookup`."""
        idx = np.ascontiguousarray(np.asarray(indices))
        req = {"variable": variable, "dtype": idx.dtype.name,
               "shape": list(idx.shape)}
        if self.compress:
            req["accept_compress"] = [self.compress]
        head = json.dumps(req).encode() + b"\n"
        body = head + idx.tobytes()

        def attempt(ep):
            raw = self._request_bin(ep, f"/models/{sign}/lookup_bin", body)
            nl = raw.index(b"\n")
            h = json.loads(raw[:nl])
            payload = raw[nl + 1:]
            if h.get("compress"):
                payload = compress_lib.decompress(h["compress"], payload)
            # one release of tolerance for rolling upgrades: pre-r4
            # replicas answered {"n","dim"} instead of {"shape"}
            shape = h.get("shape") or [int(h["n"]), int(h["dim"])]
            return np.frombuffer(payload, np.float32).reshape(shape)

        # trace_context with no arg: a fresh request id, or the
        # enclosing one (a caller's trace), so its spans join that trace
        with scope.trace_context(), \
                scope.span("client.lookup", proto="bin"):
            return self._rotate(attempt)

    def create_model(self, model_uri: str, *,
                     model_sign: Optional[str] = None,
                     block: bool = True) -> List[str]:
        """Create the model on EVERY replica (replica placement)."""
        signs = []
        for ep in self.endpoints:
            out = self._request(ep, "POST", "/models",
                                {"model_uri": model_uri,
                                 "model_sign": model_sign, "block": block})
            signs.append(out["model_sign"])
        return signs

    def _push_one(self, ep: str, path: str, body: bytes,
                  deadline: float) -> bytes:
        """One endpoint's delta push under the shared retry policy:
        connection-class failures retry with backoff until ``deadline``;
        an HTTP status is a definite server answer and never retries
        (delta applies are idempotent — a stale seq ACKs as a no-op —
        so the retries themselves are safe)."""
        rnd = 0
        while True:
            try:
                return self._request_bin(ep, path, body)
            except urllib.error.HTTPError:
                raise
            except (urllib.error.URLError, http.client.HTTPException,
                    ConnectionError, OSError, TimeoutError):
                sleep = self.policy.backoff(rnd)
                rnd += 1
                if time.monotonic() + sleep >= deadline:
                    scope.HISTOGRAMS.inc("serving_retry_budget_exhausted")
                    raise
                scope.HISTOGRAMS.inc("serving_request_retries")
                time.sleep(sleep)

    def push_delta(self, sign: str, delta) -> List[Dict[str, Any]]:
        """BROADCAST a trainer-published delta to every replica (the
        streaming train->serve hot-swap, ``registry.apply_delta``) —
        unlike lookups this is not a failover pick: every replica must
        converge to the published version. ``delta`` is a
        ``checkpoint_delta.Delta`` or its ``encode_delta`` bytes.

        Runs under the same :class:`RetryPolicy` as lookups (each
        endpoint retries connection failures with backoff inside the
        request deadline). Per-endpoint results carry ``error`` instead
        of raising — GRACEFUL DEGRADATION: a replica that misses the
        push keeps serving its last-good version (it catches up at
        respawn via ``read_deltas_since`` or reload), and the fleet's
        worst version lag is exported as the
        ``oe_serving_staleness_seq`` gauge (0 = every replica ACKed the
        newest published seq) with each endpoint's lag in the returned
        ``staleness`` field.
        """
        from .. import checkpoint_delta as cd
        body = bytes(delta) if isinstance(delta, (bytes, bytearray)) \
            else cd.encode_delta(delta)
        target = None if isinstance(delta, (bytes, bytearray)) \
            else int(delta.seq)
        deadline = time.monotonic() + self.policy.deadline_s
        out: List[Dict[str, Any]] = []
        for ep in self.endpoints:
            try:
                raw = self._push_one(ep, f"/models/{sign}/delta", body,
                                     deadline)
                res = {"endpoint": ep, **json.loads(raw)}
                if "version" in res:
                    self._acked_versions[(sign, ep)] = int(res["version"])
            except Exception as e:  # noqa: BLE001 — per-replica verdict
                res = {"endpoint": ep, "applied": False,
                       "error": f"{type(e).__name__}: {e}"}
            out.append(res)
        # staleness: lag of each replica behind the newest version any
        # replica (or the delta itself) is known to carry
        acked = [int(r["version"]) for r in out if "version" in r]
        if target is None:
            target = max(acked, default=None)
        if target is not None:
            worst = 0
            for r in out:
                last = int(r["version"]) if "version" in r else \
                    self._acked_versions.get((sign, r["endpoint"]), 0)
                r["staleness"] = max(0, target - last)
                worst = max(worst, r["staleness"])
            observability.set_gauge("serving_staleness_seq", float(worst))
        return out

    def nodes(self) -> List[Dict[str, Any]]:
        """Cluster liveness, client-side aggregated."""
        return probe_nodes(self.endpoints)


class ShardedRoutingClient:
    """Shard-group lookup client (JAX's ``ShardedRoutingClient``): shards
    x replicas over processes, the reference's placement over its
    parameter servers (``client/Model.cpp:153-186``). ``groups[k]`` lists
    the replica endpoints of shard ``k`` (ids or keys ≡ k (mod G)); a
    lookup partitions its ids by owner, asks each owner group through
    that group's failover rotation (a :class:`RoutingClient`) and merges
    the rows back by position. It keeps serving while one replica of
    every group lives."""

    def __init__(self, groups: Sequence[Sequence[str]],
                 timeout: float = 10.0, compress: str = "",
                 policy: Optional["RetryPolicy"] = None):
        if not groups or any(not g for g in groups):
            raise ValueError("need >= 1 replica endpoint per shard group")
        self.groups = [RoutingClient(list(g), timeout=timeout,
                                     compress=compress, policy=policy)
                       for g in groups]

    @property
    def shard_count(self) -> int:
        return len(self.groups)

    def close(self) -> None:
        for g in self.groups:
            g.close()

    def __enter__(self) -> "ShardedRoutingClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def lookup(self, sign: str, variable: Any, indices, *,
               wide: bool = False) -> np.ndarray:
        """Rows of ``indices``: each id's owner group ``id % G`` (the
        joined 64-bit value of a pair under ``wide=True``, where indices
        are ``[..., 2]`` int32 (lo, hi) pairs, ``hash_table.split64``) is
        asked for its ids, and the rows merge by position. One trace id
        for the whole fan-out (``client.lookup`` span); the fan-out width
        goes to ``serving_request_fanout`` and ``serving_fanout_width``."""
        idx = np.asarray(indices)
        g = self.shard_count
        if wide:
            from .. import hash_table as hash_lib
            if idx.ndim < 2 or idx.shape[-1] != 2:
                raise ValueError(
                    f"wide lookup takes [..., 2] int32 pairs "
                    f"(hash_table.split64), got shape {idx.shape}")
            if idx.dtype != np.int32:
                # pair words must fit int32: a bigger value is a raw
                # 64-bit id, which belongs in split64
                if (idx > np.iinfo(np.int32).max).any() or \
                        (idx < np.iinfo(np.int32).min).any():
                    raise ValueError(
                        "wide lookup pair words exceed int32; pass "
                        "hash_table.split64(ids), not raw 64-bit ids")
                idx = idx.astype(np.int32)
            flat = np.ascontiguousarray(idx.reshape(-1, 2))
            owner = hash_lib.join64(flat) % g
            out_shape = idx.shape[:-1]
        else:
            flat = idx.ravel()
            owner = flat.astype(np.int64) % g
            out_shape = idx.shape
        with scope.trace_context(), \
                scope.span("client.lookup", proto="sharded") as sp:
            rows = None
            fanout = 0
            for k in range(g):
                sel = np.nonzero(owner == k)[0]
                if not sel.size:
                    continue
                fanout += 1
                part = self.groups[k].lookup(sign, variable, flat[sel])
                if rows is None:
                    rows = np.zeros((flat.shape[0],) + part.shape[1:],
                                    part.dtype)
                rows[sel] = part
            sp.detail = dict(sp.detail or {}, fanout=fanout)
            scope.HISTOGRAMS.inc("serving_request_fanout", float(fanout))
            scope.HISTOGRAMS.observe("serving_fanout_width", float(fanout))
        if rows is None:
            rows = np.zeros((0, 0), np.float32)
        return rows.reshape(out_shape + rows.shape[1:])

    def create_model(self, model_uri: str, *,
                     model_sign: Optional[str] = None,
                     block: bool = True) -> List[str]:
        """Create the model on every replica of every group, each with
        its group's shard slice."""
        signs = []
        for k, group in enumerate(self.groups):
            for ep in group.endpoints:
                out = group._request(
                    ep, "POST", "/models",
                    {"model_uri": model_uri, "model_sign": model_sign,
                     "shard_index": k, "shard_count": self.shard_count,
                     "block": block})
                signs.append(out["model_sign"])
        return signs

    def push_delta(self, sign: str, delta) -> List[Dict[str, Any]]:
        """Send a delta to every replica of every group (each keeps the
        rows its slice owns), encoded once."""
        from .. import checkpoint_delta as cd
        body = bytes(delta) if isinstance(delta, (bytes, bytearray)) \
            else cd.encode_delta(delta)
        return [res for g in self.groups
                for res in g.push_delta(sign, body)]

    def nodes(self) -> List[Dict[str, Any]]:
        return probe_nodes([ep for g in self.groups for ep in g.endpoints])


if __name__ == "__main__":
    sys.exit(replica_main())
