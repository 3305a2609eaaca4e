"""Torch port, the serving slice end to end on the CPU: a JAX-written fused
checkpoint is served by the port's ``ModelRegistry`` + ``ControllerServer``
and by the JAX package's, side by side. Lookups are copies, so the port's
``lookup`` / ``lookup_bin`` responses must equal the JAX ones exactly
(``lookup_bin`` byte for byte), and status codes must agree.
"""

import http.client
import json
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu.fused import make_fused_specs
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu.serving.rest import ControllerServer as JaxServer
from openembedding_tpu_torch.data.criteo import SPARSE_NAMES, synthetic_criteo
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.serving.rest import ControllerServer

VOCAB = 16          # per feature: 26 x 16 = 416 fused rows
SIGN = "deepfm-7"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One JAX fused checkpoint (2x4 mesh, adagrad, one step), served by
    the JAX server and by the port's server on the CPU."""
    devices = jax.devices()[:8]
    mesh = create_mesh(2, 4, devices)
    specs, mapper = make_fused_specs(
        SPARSE_NAMES, VOCAB, 9,
        optimizer={"category": "adagrad", "learning_rate": 0.05})
    coll = oe.EmbeddingCollection(specs, mesh)
    states = coll.init(jax.random.PRNGKey(1))
    batch = mapper.fuse(next(synthetic_criteo(32, num_buckets=VOCAB)
                             )["sparse"])
    idx = {k: jnp.asarray(v) for k, v in batch.items()}
    rows = coll.pull(states, idx, batch_sharded=False)
    states = coll.apply_gradients(
        states, idx, {k: jnp.ones_like(v) for k, v in rows.items()},
        batch_sharded=False)
    path = str(tmp_path_factory.mktemp("served") / "ck")
    jax_ckpt.save_checkpoint(path, coll, states, model_sign=SIGN)
    jreg = JaxRegistry(mesh)
    jreg.create_model(path)
    jsrv = JaxServer(jreg, port=0).start()
    tsrv = ControllerServer(port=0, device="cpu").start()
    status, body = _req(tsrv, "POST", "/models",
                        json.dumps({"model_uri": path, "block": True}))
    assert status == 201 and json.loads(body) == {"model_sign": SIGN}
    yield {"path": path, "mapper": mapper, "jreg": jreg, "jsrv": jsrv,
           "tsrv": tsrv}
    tsrv.stop()
    jsrv.stop()


def _req(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request(method, path, body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _bin_body(variable, ids):
    head = {"variable": variable, "dtype": str(ids.dtype),
            "shape": list(ids.shape)}
    return json.dumps(head).encode() + b"\n" + ids.tobytes()


def _requests(mapper):
    batches = [mapper.fuse(b["sparse"])["fields"] for b in synthetic_criteo(
        24, num_buckets=VOCAB, seed=5, num_batches=2)]
    bad = batches[1].copy()
    bad[::3, 0] = -1
    bad[1::3, 5] = VOCAB * 26           # one past the fused vocab
    bad[2::3, 7] = np.iinfo(np.int32).max
    return {"zipf": batches[0], "invalid": bad,
            "flat_i64": batches[0].reshape(-1)[:50].astype(np.int64)}


@pytest.mark.parametrize("variable", ["fields", "fields:linear"])
@pytest.mark.parametrize("case", ["zipf", "invalid", "flat_i64"])
def test_lookup_bin_matches_jax(served, variable, case):
    """Byte-for-byte: the port's lookup_bin response equals the JAX
    server's, and its rows equal JAX ``ModelRegistry.lookup``."""
    ids = _requests(served["mapper"])[case]
    path = f"/models/{SIGN}/lookup_bin"
    ts, tbody = _req(served["tsrv"], "POST", path, _bin_body(variable, ids))
    js, jbody = _req(served["jsrv"], "POST", path, _bin_body(variable, ids))
    assert ts == js == 200
    assert tbody == jbody
    nl = tbody.index(b"\n")
    rows = np.frombuffer(tbody[nl + 1:], np.float32).reshape(
        json.loads(tbody[:nl])["shape"])
    want = np.asarray(served["jreg"].lookup(SIGN, variable, ids))
    assert rows.shape == ids.shape + (9 if variable == "fields" else 1,)
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("int64", [False, True])
def test_json_lookup_matches_jax(served, int64):
    ids = _requests(served["mapper"])["invalid"]
    body = json.dumps({"variable": "fields", "indices": ids.tolist(),
                       "int64": int64})
    path = f"/models/{SIGN}/lookup"
    ts, tbody = _req(served["tsrv"], "POST", path, body)
    js, jbody = _req(served["jsrv"], "POST", path, body)
    assert ts == js == 200
    assert json.loads(tbody) == json.loads(jbody)
    np.testing.assert_array_equal(
        np.asarray(json.loads(tbody)["rows"], np.float32),
        np.asarray(served["jreg"].lookup(SIGN, "fields", ids)))


def test_status_codes_match_jax(served):
    """404 for an unknown sign (GET/DELETE), 400 for a bad body or an
    unknown sign/variable in a POST — the same codes as the JAX server."""
    ids = _requests(served["mapper"])["zipf"]
    cases = [
        ("GET", "/models/ghost", None, 404),
        ("DELETE", "/models/ghost", None, 404),
        ("GET", "/no/such/route", None, 404),
        ("POST", "/models/ghost/lookup",
         json.dumps({"variable": "fields", "indices": [1]}), 400),
        ("POST", "/models/ghost/lookup_bin", _bin_body("fields", ids), 400),
        ("POST", f"/models/{SIGN}/lookup", "{not json", 400),
        ("POST", f"/models/{SIGN}/lookup", json.dumps({"indices": [1]}),
         400),
        ("POST", f"/models/{SIGN}/lookup",
         json.dumps({"variable": "nope", "indices": [1]}), 400),
        ("POST", f"/models/{SIGN}/lookup_bin", b"no header line", 400),
        ("POST", "/models", json.dumps({"block": True}), 400),
    ]
    for method, path, body, code in cases:
        ts, _ = _req(served["tsrv"], method, path, body)
        js, _ = _req(served["jsrv"], method, path, body)
        assert (ts, js) == (code, code), (method, path)


def test_catalog_and_health_match_jax(served):
    for path in ("/models", f"/models/{SIGN}", "/health"):
        ts, tbody = _req(served["tsrv"], "GET", path)
        js, jbody = _req(served["jsrv"], "GET", path)
        assert ts == js == 200
        assert json.loads(tbody) == json.loads(jbody), path


def test_async_create_and_delete(served):
    srv = served["tsrv"]
    status, body = _req(srv, "POST", "/models", json.dumps(
        {"model_uri": served["path"], "model_sign": "async-1"}))
    assert status == 201
    deadline = time.time() + 60
    while True:
        st = json.loads(_req(srv, "GET", "/models/async-1")[1])
        if st["model_status"] != "CREATING" or time.time() > deadline:
            break
        time.sleep(0.05)
    assert st["model_status"] == "NORMAL"
    reg = srv.registry
    assert reg.find_model("async-1").variable_name(0) == "fields"
    assert _req(srv, "DELETE", "/models/async-1")[0] == 200
    with pytest.raises(KeyError):
        reg.find_model("async-1")
    assert _req(srv, "GET", "/models/async-1")[0] == 404


def test_registry_refuses_later_slices(served, tmp_path, devices8):
    reg = ModelRegistry(device="cpu")
    with pytest.raises(NotImplementedError, match="micro-batch"):
        reg.enable_batching(max_batch_rows=64)
    with pytest.raises(NotImplementedError, match="delta"):
        reg.apply_delta(SIGN, b"")
    with pytest.raises(NotImplementedError, match="shard"):
        reg.create_model(served["path"], shard_count=2)
    # a hash-table checkpoint fails its load: ERROR status, clear message
    mesh = create_mesh(2, 4, devices8)
    hcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name="h", input_dim=-1, output_dim=4,
                          hash_capacity=64)], mesh)
    hpath = str(tmp_path / "hash")
    jax_ckpt.save_checkpoint(hpath, hcoll, hcoll.init(jax.random.PRNGKey(0)),
                             model_sign="h-1")
    with pytest.raises(RuntimeError, match="hash-table serving path"):
        reg.create_model(hpath)
    assert reg.show_model("h-1")["model_status"] == "ERROR"
    with pytest.raises(RuntimeError, match="ERROR"):
        reg.find_model("h-1")
    reg.close()
