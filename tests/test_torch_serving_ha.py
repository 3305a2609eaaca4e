"""Torch port, replicated serving (``serving/ha.py``) on the CPU.

The cases of ``tests/test_serving_ha.py`` with port replica daemons
(``python -m openembedding_tpu_torch.serving.ha --device cpu``): replicas
SIGKILLed mid-service while the routing client keeps answering, respawns
that restore the catalog from a living peer, a respawn that rebuilds a
model from a peer's rows alone when the dump is gone (array and
wide-key hash), the retry policy. Beside them, the REST surface this
slice adds (``/models/<sign>/meta``, ``/rows``, ``/nodes``, ``/cluster``,
``DELETE /nodes/<id>``) against the JAX server on the same dump. Every
wait has its own deadline and every child is killed in a ``finally``.
"""

import http.client
import json
import shutil
import signal
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu.serving.rest import ControllerServer as JaxServer
from openembedding_tpu_torch import checkpoint as ck
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch.analysis import scope
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.serving import ha
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.serving.rest import ControllerServer

DIM = 4
SIGN = "ha-model-1"
BOOT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A small port checkpoint with recognizable values."""
    path = str(tmp_path_factory.mktemp("ha") / "model")
    coll = EmbeddingCollection(
        [EmbeddingSpec(name="emb", input_dim=64, output_dim=DIM,
                       initializer={"category": "constant", "value": 0.5})],
        device="cpu")
    ck.save_checkpoint(path, coll, coll.init(), model_sign=SIGN)
    return path


def _spawn(port, **kw):
    return ha.spawn_replica(port, device="cpu", **kw)


def _cleanup(procs):
    for p in procs.values():
        if p and p.poll() is None:
            p.kill()
        if p:
            p.wait(30)
            p.stdout.close()


def _tail(proc, n=20):
    try:
        out = proc.stdout.read() if proc.poll() is not None else ""
    except Exception:  # noqa: BLE001
        out = ""
    return "\n".join((out or "").splitlines()[-n:])


def _assert_lookup(router, deadline_s: float = 60.0):
    """A lookup with a deadline: a live but starved replica may miss the
    router timeout under a loaded test host; a refused connection from a
    dead replica must still fail at once."""
    deadline = time.time() + deadline_s
    while True:
        try:
            rows = router.lookup(SIGN, "emb", [1, 7, 63])
            break
        except ConnectionError as e:
            if "timed out" not in str(e) or time.time() >= deadline:
                raise
            time.sleep(0.5)
    assert rows.shape == (3, DIM)
    np.testing.assert_allclose(rows, 0.5, rtol=1e-6)


def test_restore_from_peer_and_chaos(model_dir):
    ports = [_free_port() for _ in range(3)]
    eps = [f"127.0.0.1:{p}" for p in ports]
    procs = {}
    try:
        procs[0] = _spawn(ports[0], load=[f"{SIGN}={model_dir}"])
        assert ha.wait_ready(eps[0], BOOT_S, sign=SIGN), _tail(procs[0])
        for i in (1, 2):
            procs[i] = _spawn(ports[i], peers=[eps[0]])
            assert ha.wait_ready(eps[i], BOOT_S, sign=SIGN), _tail(procs[i])
        router = ha.RoutingClient(eps, timeout=15.0)
        nodes = router.nodes()
        assert all(n["alive"] for n in nodes)
        assert all(SIGN in n["models"] for n in nodes)
        _assert_lookup(router)
        with urllib.request.urlopen(
                f"http://{eps[1]}/cluster", timeout=5) as r:
            cluster = json.loads(r.read())
        assert {c["endpoint"] for c in cluster} == {eps[0]}
        assert all(c["alive"] for c in cluster)

        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait(30)
        for _ in range(5):
            _assert_lookup(router)
        assert sum(n["alive"] for n in router.nodes()) == 2
        procs[2].send_signal(signal.SIGKILL)
        procs[2].wait(30)
        for _ in range(5):
            _assert_lookup(router)

        for i in (1, 2):
            procs[i].stdout.close()
            others = [e for j, e in enumerate(eps) if j != i]
            procs[i] = _spawn(ports[i], peers=others)
            assert ha.wait_ready(eps[i], BOOT_S, sign=SIGN), _tail(procs[i])
        assert all(n["alive"] for n in router.nodes())
        _assert_lookup(router)

        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait(30)
        for _ in range(5):
            _assert_lookup(router)
        router.close()
    finally:
        _cleanup(procs)


def test_router_propagates_http_errors(model_dir):
    port = _free_port()
    proc = _spawn(port, load=[f"{SIGN}={model_dir}"])
    try:
        ep = f"127.0.0.1:{port}"
        assert ha.wait_ready(ep, BOOT_S, sign=SIGN), _tail(proc)
        router = ha.RoutingClient([ep], timeout=10.0)
        with pytest.raises(urllib.error.HTTPError):
            router.lookup("no-such-model", "emb", [0])
        router.close()
    finally:
        _cleanup({0: proc})


def test_router_raises_when_all_dead():
    router = ha.RoutingClient([f"127.0.0.1:{_free_port()}"], timeout=2.0)
    with pytest.raises(ConnectionError, match="no live replica"):
        router.lookup(SIGN, "emb", [0])


def test_binary_lookup_parity(model_dir):
    port = _free_port()
    proc = _spawn(port, load=[f"{SIGN}={model_dir}"], batch_rows=256,
                  compress="zlib")
    try:
        ep = f"127.0.0.1:{port}"
        assert ha.wait_ready(ep, BOOT_S, sign=SIGN), _tail(proc)
        router = ha.RoutingClient([ep], timeout=15.0)
        idx = np.asarray([1, 7, 63], np.int32)
        a = router.lookup_json(SIGN, "emb", idx)
        b = router.lookup_bin(SIGN, "emb", idx)
        c = router.lookup(SIGN, "emb", idx)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
        m = router.lookup(SIGN, "emb", idx.reshape(1, 3).repeat(2, 0))
        assert m.shape == (2, 3, a.shape[-1])
        np.testing.assert_array_equal(m[0], a)
        d = router.lookup(SIGN, "emb", np.asarray([1, 7, 63], np.int64))
        np.testing.assert_array_equal(d, a)
        # a client that accepts the replica's codec gets packed rows
        zr = ha.RoutingClient([ep], timeout=15.0, compress="zlib")
        np.testing.assert_array_equal(zr.lookup(SIGN, "emb", idx), a)
        router.close()
        zr.close()
    finally:
        _cleanup({0: proc})


def test_peer_row_restore_without_dump(model_dir, tmp_path):
    """The dump store dies after boot; a respawned replica rebuilds the
    model from a living peer's rows alone and keeps serving after the
    peer dies."""
    mdir = str(tmp_path / "model")
    shutil.copytree(model_dir, mdir)
    ports = [_free_port() for _ in range(2)]
    eps = [f"127.0.0.1:{p}" for p in ports]
    procs = {}
    try:
        procs[0] = _spawn(ports[0], load=[f"{SIGN}={mdir}"])
        assert ha.wait_ready(eps[0], BOOT_S, sign=SIGN), _tail(procs[0])
        shutil.rmtree(mdir)
        procs[1] = _spawn(ports[1], peers=[eps[0]])
        assert ha.wait_ready(eps[1], BOOT_S, sign=SIGN), _tail(procs[1])
        solo = ha.RoutingClient([eps[1]], timeout=15.0)
        np.testing.assert_allclose(solo.lookup(SIGN, "emb", [1, 7, 63]),
                                   0.5, rtol=1e-6)
        procs[0].kill()
        procs[0].wait(30)
        np.testing.assert_allclose(solo.lookup(SIGN, "emb", [0, 2]), 0.5,
                                   rtol=1e-6)
        solo.close()
    finally:
        _cleanup(procs)


def test_peer_row_restore_wide_keys(tmp_path):
    """A wide-key hash model restored from a peer's pages (joined int64
    ids re-split into pairs) answers every stored key's row exactly."""
    sign = "wide-ha-1"
    coll = EmbeddingCollection(
        [EmbeddingSpec(name="w", input_dim=-1, output_dim=DIM,
                       hash_capacity=512, key_dtype="wide",
                       initializer={"category": "constant", "value": 0.0},
                       optimizer={"category": "sgd", "learning_rate": 1.0})],
        device="cpu")
    states = coll.init()
    k64 = np.asarray([3, 3 + (1 << 35), (9 << 40) + 1], np.int64)
    pairs = th.split64(k64)
    rows = coll.pull(states, {"w": pairs})
    g = torch.arange(1, 4, dtype=torch.float32)[:, None] \
        * torch.ones_like(rows["w"])
    coll.apply_gradients(states, {"w": pairs}, {"w": g})
    mdir = str(tmp_path / "model")
    ck.save_checkpoint(mdir, coll, states, model_sign=sign)
    ports = [_free_port() for _ in range(2)]
    eps = [f"127.0.0.1:{p}" for p in ports]
    procs = {}
    try:
        procs[0] = _spawn(ports[0], load=[f"{sign}={mdir}"])
        assert ha.wait_ready(eps[0], BOOT_S, sign=sign), _tail(procs[0])
        shutil.rmtree(mdir)
        procs[1] = _spawn(ports[1], peers=[eps[0]])
        assert ha.wait_ready(eps[1], BOOT_S, sign=sign), _tail(procs[1])
        solo = ha.RoutingClient([eps[1]], timeout=15.0)
        got = solo.lookup(sign, "w", pairs)
        np.testing.assert_allclose(got[:, 0], [-1.0, -2.0, -3.0],
                                   rtol=1e-6)
        solo.close()
    finally:
        _cleanup(procs)


def test_in_process_peer_restore_matches_source(tmp_path):
    """``restore_model_from_peer`` in process, paging a few rows at a
    time (every page boundary), with and without a codec: the restored
    rows equal the source's bit for bit, array and hash variables, and
    the model starts at the source's version."""
    from test_torch_delta import make_coll, train
    coll = make_coll()
    states = coll.init()
    train(coll, states, 0)
    train(coll, states, 1)
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, model_sign="src-1")
    src = ControllerServer(port=0, device="cpu").start()
    src.registry.create_model(path, block=True)
    ep = f"127.0.0.1:{src.port}"
    try:
        for codec in ("", "zlib"):
            reg = ModelRegistry(device="cpu")
            assert ha.restore_model_from_peer(reg, ep, "src-1", page=48,
                                              compress=codec) == "src-1"
            got, want = reg.find_model("src-1"), \
                src.registry.find_model("src-1")
            assert got.version == want.version
            ids = np.arange(-2, 300, dtype=np.int64)
            assert torch.equal(got.lookup("arr", ids),
                               want.lookup("arr", ids))
            keys = np.unique(np.random.RandomState(0).randint(
                0, 2**20, 64).astype(np.int32))
            stored = want.states["hsh"].keys.numpy()
            keys = np.concatenate([keys, stored[stored != -2**31][:40]])
            assert torch.equal(got.lookup("hsh", keys),
                               want.lookup("hsh", keys))
            reg.close()
    finally:
        src.stop()


def _get(port, path, method="GET"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_rest_surface_matches_jax(model_dir):
    """The routes of this slice answer as the JAX server's on the same
    dump: the meta page, row pages (raw and zlib), the node listing and
    its 501, ``/cluster`` with no peers, and 404/400 on bad requests."""
    jreg = JaxRegistry(create_mesh(1, 1, jax.devices()[:1]))
    jreg.create_model(model_dir, block=True)
    jsrv = JaxServer(jreg, port=0).start()
    tsrv = ControllerServer(port=0, device="cpu").start()
    tsrv.registry.create_model(model_dir, block=True)
    try:
        for path in (f"/models/{SIGN}/rows?variable=emb&offset=0&limit=64",
                     f"/models/{SIGN}/rows?variable=emb&offset=60&limit=9",
                     f"/models/{SIGN}/rows?variable=emb&offset=8&limit=8"
                     "&compress=zlib",
                     "/nodes", "/nodes/0", "/nodes/7", "/cluster",
                     f"/models/ghost/meta",
                     f"/models/{SIGN}/rows?variable=emb&offset=0&limit=4"
                     "&compress=nope"):
            ts, tb = _get(tsrv.port, path)
            js, jb = _get(jsrv.port, path)
            assert ts == js, path
            if path.startswith("/nodes") and ts == 200:
                assert json.loads(tb) == json.loads(jb), path
            elif ts == 200:
                assert tb == jb, path
        ts, tb = _get(tsrv.port, f"/models/{SIGN}/meta")
        js, jb = _get(jsrv.port, f"/models/{SIGN}/meta")
        assert ts == js == 200
        t, j = json.loads(tb), json.loads(jb)
        assert {k: t[k] for k in ("shard_index", "shard_count", "version",
                                  "variables")} == \
            {k: j[k] for k in ("shard_index", "shard_count", "version",
                               "variables")}
        assert json.loads(t["meta"]) == json.loads(j["meta"])
        assert _get(tsrv.port, "/nodes/0", "DELETE")[0] == \
            _get(jsrv.port, "/nodes/0", "DELETE")[0] == 501
        ts, tb = _get(tsrv.port, "/metrics")
        assert ts == 200 and b"oe_serving_requests_total" in tb
    finally:
        tsrv.stop()
        jsrv.stop()


def test_replica_without_gpu_or_device_raises(monkeypatch):
    """No GPU and no ``--device``: the daemon refuses to start rather
    than serve on the CPU; ``spawn_replica`` names its device and sets no
    JAX variable."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ha.replica_main(["--port", "0"])
    proc = ha.spawn_replica(_free_port(), env={"OE_TEST_MARK": "1"})
    try:
        assert proc.args[proc.args.index("--device") + 1] == "cuda"
    finally:
        _cleanup({0: proc})


# --- RetryPolicy -------------------------------------------------------------

def test_retry_policy_validates():
    ha.RetryPolicy()
    with pytest.raises(ValueError, match="deadline_s"):
        ha.RetryPolicy(deadline_s=0.0)
    with pytest.raises(ValueError, match="backoff"):
        ha.RetryPolicy(base_backoff_s=-0.1)
    with pytest.raises(ValueError, match="backoff"):
        ha.RetryPolicy(max_backoff_s=-1.0)
    with pytest.raises(ValueError, match="multiplier"):
        ha.RetryPolicy(multiplier=0.5)
    with pytest.raises(ValueError, match="jitter"):
        ha.RetryPolicy(jitter=1.5)


def test_retry_policy_backoff_bounds():
    p = ha.RetryPolicy(base_backoff_s=0.1, max_backoff_s=1.0,
                       multiplier=2.0, jitter=0.5)
    for rnd in range(8):
        raw = min(1.0, 0.1 * 2.0 ** rnd)
        for _ in range(25):
            s = p.backoff(rnd)
            assert raw * (1.0 - 0.5) <= s <= raw, (rnd, s, raw)
    p0 = ha.RetryPolicy(base_backoff_s=0.1, max_backoff_s=1.0,
                        multiplier=2.0, jitter=0.0)
    assert p0.backoff(0) == pytest.approx(0.1)
    assert p0.backoff(1) == pytest.approx(0.2)
    assert p0.backoff(10) == pytest.approx(1.0)


def test_retry_budget_exhausts_at_deadline():
    dead = f"127.0.0.1:{_free_port()}"
    client = ha.RoutingClient(
        [dead], timeout=5.0,
        policy=ha.RetryPolicy(deadline_s=0.3, base_backoff_s=0.02,
                              max_backoff_s=0.05))
    exhausted0 = scope.HISTOGRAMS.counter("serving_retry_budget_exhausted")
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="round"):
        client.lookup(SIGN, "emb", [1])
    dt = time.monotonic() - t0
    client.close()
    assert dt < 4.0, dt
    assert scope.HISTOGRAMS.counter("serving_retry_budget_exhausted") \
        == exhausted0 + 1


def test_push_delta_broadcasts_and_tracks_staleness(tmp_path):
    """``push_delta`` reaches every replica; a dead one reports its error
    and its lag (``serving_staleness_seq``)."""
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.utils import observability as obs
    from test_torch_delta import make_coll, train
    coll = make_coll()
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0,
                       model_sign="d-1")
    srv = ControllerServer(port=0, device="cpu").start()
    dead = f"127.0.0.1:{_free_port()}"
    try:
        router = ha.RoutingClient([f"127.0.0.1:{srv.port}", dead],
                                  policy=ha.RetryPolicy(deadline_s=0.5))
        srv.registry.create_model(path, block=True)
        idx = train(coll, states, 3)
        delta = cd.save_delta(path, coll, states, step=1,
                              return_payload=True, compact_bytes_ratio=1e18,
                              background_compact=False)["delta"]
        out = router.push_delta("d-1", delta)
        assert out[0]["applied"] and out[0]["staleness"] == 0
        assert "error" in out[1] and out[1]["staleness"] == 1
        assert obs.gauges()["serving_staleness_seq"] == 1.0
        got = ha.RoutingClient([f"127.0.0.1:{srv.port}"]).lookup(
            "d-1", "arr", idx["arr"])
        np.testing.assert_array_equal(
            got, coll.pull(states, {"arr": idx["arr"]})["arr"].numpy())
        router.close()
    finally:
        srv.stop()
