"""Torch port, request-scoped serving traces on the CPU: the cases of
``tests/test_serving_trace.py`` (the sharded fan-out, a later slice,
aside) on an in-process two-replica cluster of port registries and REST
controllers, so every side of a request (client span, router attempt
spans, HTTP handler spans, registry lookup spans) lands in the same span
rings: one trace id per request across client, router and server; the
keep-alive client opening one connection; a replica stopped while the
client is parked mid-rotation, the lookup riding over with no error and
the failover spans under the same trace id; and the lookup-size
histogram on ``/metrics``.
"""

import threading

import numpy as np
import pytest

from openembedding_tpu_torch import checkpoint as ck
from openembedding_tpu_torch.analysis import scope
from openembedding_tpu_torch.analysis.concurrency import (
    PointGate, clear_schedule, install_schedule)
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.serving import ha
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.serving.rest import ControllerServer

DIM = 4
VOCAB = 64
SIGN = "trace-model-1"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "model")
    coll = EmbeddingCollection(
        [EmbeddingSpec(name="emb", input_dim=VOCAB, output_dim=DIM,
                       initializer={"category": "constant", "value": 0.5})],
        device="cpu")
    ck.save_checkpoint(path, coll, coll.init(), model_sign=SIGN)
    return path


def _boot(model_dir):
    reg = ModelRegistry(device="cpu")
    reg.create_model(model_dir, model_sign=SIGN, block=True)
    srv = ControllerServer(reg, port=0).start()
    return reg, srv


@pytest.fixture()
def tracing():
    scope.set_tracing(True)
    scope.reset()
    yield
    scope.set_tracing(None)


@pytest.fixture(autouse=True)
def _no_leftover_schedule():
    yield
    clear_schedule()


def _events_for(trace, tid):
    return [e for e in trace["traceEvents"]
            if e.get("ph") == "X" and e.get("args", {}).get("trace") == tid]


def _wait_events(tid, names, timeout=10.0):
    """Export and poll until every span kind in ``names`` has landed for
    ``tid``: the handler closes its span just after the client has read
    the response."""
    import time as _time
    deadline = _time.time() + timeout
    while True:
        evs = _events_for(scope.export_chrome_trace(), tid)
        if names <= {e["name"] for e in evs} or _time.time() > deadline:
            return evs
        _time.sleep(0.05)


# --- one trace id across client / router / server ---------------------------

def test_trace_stitches_client_router_server(model_dir, tracing):
    """Acceptance criterion: one lookup against a 2-replica cluster ->
    ONE trace containing client, router fan-out, and server-side spans
    sharing one trace id, exported through export_chrome_trace."""
    _regA, srvA = _boot(model_dir)
    _regB, srvB = _boot(model_dir)
    router = ha.RoutingClient([f"127.0.0.1:{srvA.port}",
                               f"127.0.0.1:{srvB.port}"], timeout=15.0)
    try:
        with scope.trace_context() as tid:
            rows = router.lookup(SIGN, "emb", [1, 7, 63])
        np.testing.assert_allclose(rows, 0.5, rtol=1e-6)
        # client leg, router fan-out leg, HTTP server leg, registry leg
        want = {"client.lookup", "serving.rpc", "http", "serving.lookup"}
        evs = _wait_events(tid, want)
        assert want <= {e["name"] for e in evs}, evs
        rpc = [e for e in evs if e["name"] == "serving.rpc"]
        assert rpc[0]["args"]["outcome"] == "ok"
        assert rpc[0]["args"]["replica"].startswith("127.0.0.1:")
        http = [e for e in evs if e["name"] == "http"][0]
        assert http["args"]["route"] == "/models/lookup_bin"
        assert http["args"]["status"] == "200"
        # a SECOND lookup gets a DIFFERENT trace id (per-request scope)
        with scope.trace_context() as tid2:
            router.lookup(SIGN, "emb", [2])
        assert tid2 != tid
        assert _wait_events(tid2, {"client.lookup"})
    finally:
        router.close()
        srvA.stop()
        srvB.stop()


def test_trace_header_reaches_server_verbatim(model_dir, tracing):
    """The wire contract: the client's X-OE-Trace header value IS the
    id the server stamps on its spans (not a re-mint)."""
    _reg, srv = _boot(model_dir)
    router = ha.RoutingClient([f"127.0.0.1:{srv.port}"])
    try:
        with scope.trace_context("cafef00dcafef00d"):
            router.lookup(SIGN, "emb", [3])
        evs = _wait_events("cafef00dcafef00d",
                           {"http", "serving.lookup"})
        assert {"http", "serving.lookup"} <= {e["name"] for e in evs}
    finally:
        router.close()
        srv.stop()


# --- keep-alive satellite ----------------------------------------------------

def test_keepalive_reuses_one_connection(model_dir):
    """The keep-alive pin: N lookups from one thread open exactly ONE
    connection (per endpoint) — per-request TCP setup used to inflate
    every measured latency."""
    _reg, srv = _boot(model_dir)
    ep = f"127.0.0.1:{srv.port}"
    router = ha.RoutingClient([ep])
    before = scope.HISTOGRAMS.counter("serving_client_connections",
                                      endpoint=ep)
    try:
        for _ in range(5):
            rows = router.lookup(SIGN, "emb", [1, 2])
            assert rows.shape == (2, DIM)
        opened = scope.HISTOGRAMS.counter("serving_client_connections",
                                          endpoint=ep) - before
        assert opened == 1, f"expected 1 connection for 5 lookups, " \
                            f"opened {opened}"
    finally:
        router.close()
        srv.stop()


def test_keepalive_survives_server_side_idle_close(model_dir):
    """A stale pooled connection (server closed it) is retried on a
    fresh one instead of reading as a dead replica."""
    _reg, srv = _boot(model_dir)
    ep = f"127.0.0.1:{srv.port}"
    router = ha.RoutingClient([ep])
    try:
        router.lookup(SIGN, "emb", [1])
        # simulate the server-side idle close: kill the pooled socket
        conn = router._tls.conns[ep]
        conn.sock.close()
        rows = router.lookup(SIGN, "emb", [5])     # must NOT raise
        np.testing.assert_allclose(rows, 0.5, rtol=1e-6)
    finally:
        router.close()
        srv.stop()


# --- failover-under-load interleaving schedule -------------------------------

def test_failover_mid_lookup_keeps_trace_id(model_dir, tracing,
                                            monkeypatch):
    """The failover-under-load lane: the client thread is parked at the
    rotation sync point, the replica it is ABOUT to query is stopped,
    then released — the lookup must ride over to the live replica with
    NO error, and the failover + success spans must carry the same
    trace id (the trace shows the reroute)."""
    _regA, srvA = _boot(model_dir)
    _regB, srvB = _boot(model_dir)
    router = ha.RoutingClient([f"127.0.0.1:{srvA.port}",
                               f"127.0.0.1:{srvB.port}"], timeout=15.0)
    # deterministic rotation: always start at replica A
    monkeypatch.setattr(ha.random, "randrange", lambda n: 0)
    out, errs = [], []

    def storm():
        try:
            with scope.trace_context() as tid:
                out.append((tid, router.lookup(SIGN, "emb", [1, 7])))
        except Exception as e:  # noqa: BLE001 — the assertion below
            errs.append(e)

    try:
        # warmup: pooled connection to A established (the kill must
        # also exercise the stale-conn path, like a real mid-storm kill)
        router.lookup(SIGN, "emb", [0])
        router.close()

        gate = PointGate(["storm/routing.attempt"], timeout=30)
        install_schedule(gate)
        t = threading.Thread(target=storm, name="storm")
        t.start()
        assert gate.wait_arrival("storm/routing.attempt")
        # the client is parked about to query replica A: kill A now
        srvA.stop()
        gate.open("storm/routing.attempt")
        t.join(60)
        clear_schedule()
        assert not t.is_alive()
        assert not errs, f"reads must never error while a replica " \
                         f"lives: {errs}"
        tid, rows = out[0]
        np.testing.assert_allclose(rows, 0.5, rtol=1e-6)

        evs = _wait_events(tid, {"serving.rpc", "http",
                                 "serving.lookup"})
        rpc = [e for e in evs if e["name"] == "serving.rpc"]
        outcomes = [e["args"]["outcome"] for e in rpc]
        assert outcomes == ["failover", "ok_failover"], outcomes
        assert rpc[0]["args"]["replica"] == f"127.0.0.1:{srvA.port}"
        assert rpc[1]["args"]["replica"] == f"127.0.0.1:{srvB.port}"
        # the SERVER-side spans of the surviving replica share the id
        assert {"http", "serving.lookup"} <= {e["name"] for e in evs}
        assert scope.HISTOGRAMS.counter("serving_request_failovers") >= 1
    finally:
        clear_schedule()
        router.close()
        srvB.stop()
        srvA.stop()


def test_serving_lookup_size_histogram(model_dir):
    """Satellite: ServingModel.lookup feeds the per-variable
    lookup-size distribution — on /metrics as _bucket series."""
    import urllib.request
    _reg, srv = _boot(model_dir)
    router = ha.RoutingClient([f"127.0.0.1:{srv.port}"])
    before = scope.HISTOGRAMS.count("serving_lookup_rows", table="emb")
    try:
        router.lookup(SIGN, "emb", list(range(8)))
        assert scope.HISTOGRAMS.count("serving_lookup_rows",
                                      table="emb") == before + 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert 'oe_serving_lookup_rows_bucket{table="emb",' in body
        assert "oe_serving_lookup_requests_total" in body
    finally:
        router.close()
        srv.stop()
