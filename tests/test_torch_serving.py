"""Torch port, the serving slice end to end on the CPU: JAX-written fused
checkpoints (array tables, and wide-key hash tables) are served by the
port's ``ModelRegistry`` + ``ControllerServer`` and by the JAX package's,
side by side. Lookups are copies, so the port's
``lookup`` / ``lookup_bin`` responses must equal the JAX ones exactly
(``lookup_bin`` byte for byte), and status codes must agree.
"""

import http.client
import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu import hash_table as jh
from openembedding_tpu.fused import make_fused_specs
from openembedding_tpu.parallel import sharded_hash as jsh
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
    # micro-batching is ported: armed here, checked on the hash model below
    reg.enable_batching(max_batch_rows=64)
    assert reg.batching_enabled
    # delta hot-swap is ported: garbage bytes refuse typed, as in JAX
    from openembedding_tpu_torch.checkpoint_delta import DeltaDecodeError
    with pytest.raises(DeltaDecodeError, match="no header line"):
        reg.apply_delta(SIGN, b"")
    # shard slices are served since slice 15; a slice outside its group
    # is refused
    with pytest.raises(ValueError, match="shard 2 of 2"):
        reg.create_model(served["path"], shard_index=2, shard_count=2)
    # a hash-table checkpoint loads and serves
    mesh = create_mesh(2, 4, devices8)
    hcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name="h", input_dim=-1, output_dim=4,
                          hash_capacity=64)], mesh)
    hpath = str(tmp_path / "hash")
    jax_ckpt.save_checkpoint(hpath, hcoll, hcoll.init(jax.random.PRNGKey(0)),
                             model_sign="h-1")
    assert reg.create_model(hpath) == "h-1"
    assert reg.show_model("h-1")["model_status"] == "NORMAL"
    assert reg.lookup("h-1", "h", np.arange(3)).shape == (3, 4)
    # a flat lookup rode the batcher: host rows equal the direct lookup's
    batched = reg.lookup("h-1", "h", np.arange(5, dtype=np.int32))
    assert isinstance(batched, np.ndarray)
    np.testing.assert_array_equal(
        batched, reg.find_model("h-1").lookup(
            "h", np.arange(5, dtype=np.int32)).numpy())
    assert reg._batcher_for("h-1", reg.find_model("h-1")).stats()[
        "flushes"] >= 1
    # one whose hash variable has int64 keys loads (the wide dump's keys
    # joined) and serves the same rows
    meta_path = os.path.join(hpath, "model_meta")
    meta = json.load(open(meta_path))
    meta["model_sign"] = "h-2"
    meta["extra"]["hash_variables"]["h"]["key_dtype"] = "int64"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    assert reg.create_model(hpath) == "h-2"
    assert reg.show_model("h-2")["model_status"] == "NORMAL"
    m2 = reg.find_model("h-2")
    assert m2.states["h"].keys.dtype == torch.int64
    ids = np.array([0, 2**40, -7], np.int64)
    np.testing.assert_array_equal(
        m2.lookup("h", ids).numpy(),
        reg.find_model("h-1").lookup("h", ids).numpy())
    # an unknown key dtype fails its load: ERROR status, clear message
    meta["model_sign"] = "h-3"
    meta["extra"]["hash_variables"]["h"]["key_dtype"] = "int16"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(RuntimeError, match="unknown key_dtype"):
        reg.create_model(hpath)
    assert reg.show_model("h-3")["model_status"] == "ERROR"
    with pytest.raises(RuntimeError, match="ERROR"):
        reg.find_model("h-3")
    reg.close()


# --- a hash-table model ------------------------------------------------------

HASH_SIGN = "deepfm-hash-3"


@pytest.fixture(scope="module")
def hash_served(tmp_path_factory):
    """A JAX fused wide-key hash checkpoint (2x4 mesh, 26 features, rows
    inserted for most of the stream's keys), served by the JAX server and
    by the port's server on the CPU."""
    devices = jax.devices()[:8]
    mesh = create_mesh(2, 4, devices)
    specs, mapper = make_fused_specs(SPARSE_NAMES, -1, 9,
                                     hash_capacity=4096)
    coll = oe.EmbeddingCollection(specs, mesh)
    states = coll.init(jax.random.PRNGKey(2))
    stream = [mapper.fuse(b["sparse"])["fields"] for b in synthetic_criteo(
        24, num_buckets=VOCAB, seed=5, num_batches=3)]
    keys = np.unique(np.concatenate([s.reshape(-1, 2) for s in stream]),
                     axis=0)
    keys = keys[np.random.RandomState(0).permutation(len(keys))]
    held = keys[: len(keys) * 4 // 5]       # the rest are misses
    rng = np.random.RandomState(1)
    for name, st in states.items():
        dim = st.weights.shape[1]
        states[name] = jsh.insert_rows_sharded(
            st, jnp.asarray(held),
            jnp.asarray(rng.randn(len(held), dim).astype(np.float32)),
            mesh=mesh, spec=coll.sharding_spec(name))
    path = str(tmp_path_factory.mktemp("hash_served") / "ck")
    jax_ckpt.save_checkpoint(path, coll, states, model_sign=HASH_SIGN)
    jreg = JaxRegistry(mesh)
    jreg.create_model(path)
    jsrv = JaxServer(jreg, port=0).start()
    tsrv = ControllerServer(port=0, device="cpu").start()
    status, body = _req(tsrv, "POST", "/models",
                        json.dumps({"model_uri": path, "block": True}))
    assert status == 201 and json.loads(body) == {"model_sign": HASH_SIGN}
    pairs = stream[1].copy()
    pairs[::4, 3] = np.iinfo(np.int32).min          # EMPTY pairs
    narrow = jh.join64(stream[2])
    assert narrow.max() < 2**31
    yield {"jreg": jreg, "jsrv": jsrv, "tsrv": tsrv, "queries": {
        "pairs": pairs, "narrow_i32": narrow.astype(np.int32),
        "narrow_i64": narrow, "flat_pairs": stream[0][:5].reshape(-1, 2)}}
    tsrv.stop()
    jsrv.stop()


@pytest.mark.parametrize("variable", ["fields", "fields:linear"])
@pytest.mark.parametrize("case", ["pairs", "narrow_i32", "narrow_i64",
                                  "flat_pairs"])
def test_hash_lookup_bin_matches_jax(hash_served, variable, case):
    """Byte-for-byte on a wide hash model: ``[..., 2]`` pair bodies (with
    EMPTY pairs and misses) and narrow int32 / int64 ids, which both
    servers widen."""
    ids = hash_served["queries"][case]
    path = f"/models/{HASH_SIGN}/lookup_bin"
    ts, tbody = _req(hash_served["tsrv"], "POST", path,
                     _bin_body(variable, ids))
    js, jbody = _req(hash_served["jsrv"], "POST", path,
                     _bin_body(variable, ids))
    assert ts == js == 200
    assert tbody == jbody
    nl = tbody.index(b"\n")
    rows = np.frombuffer(tbody[nl + 1:], np.float32).reshape(
        json.loads(tbody[:nl])["shape"])
    lead = ids.shape[:-1] if case.endswith("pairs") else ids.shape
    assert rows.shape == lead + (9 if variable == "fields" else 1,)
    hit = np.abs(rows).sum(-1) > 0
    assert hit.any() and not hit.all()


@pytest.mark.parametrize("case,int64", [("narrow_i64", True),
                                        ("narrow_i32", False),
                                        ("pairs", False)])
def test_hash_json_lookup_matches_jax(hash_served, case, int64):
    ids = hash_served["queries"][case]
    body = json.dumps({"variable": "fields", "indices": ids.tolist(),
                       "int64": int64})
    path = f"/models/{HASH_SIGN}/lookup"
    ts, tbody = _req(hash_served["tsrv"], "POST", path, body)
    js, jbody = _req(hash_served["jsrv"], "POST", path, body)
    assert ts == js == 200
    assert json.loads(tbody) == json.loads(jbody)
    np.testing.assert_array_equal(
        np.asarray(json.loads(tbody)["rows"], np.float32),
        np.asarray(hash_served["jreg"].lookup(HASH_SIGN, "fields", ids)))
