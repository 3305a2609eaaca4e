"""Torch port, the compressed exchange (``parallel/precision.py``) against
the JAX package's on a 2 x 2 mesh of CPU devices (``tests/
test_compressed.py``'s cases).

Both collections start from their own init on the same key (the port
draws JAX's shards exactly) and take the same numpy-seeded ids and
gradients. Tolerances: the ``f32`` rung is the base plane bit for bit;
the bf16 pull is JAX's bf16 pull exactly (and the bf16 rounding of the
f32 rows); SGD tables equal JAX's exactly; every sender's int8 residual
and key equals JAX's exactly on the CPU (the pre-reduce sums are
bit-equal, so every int8 unit is too), the Adagrad tables they update at
rtol 1e-5 (the one-device Adagrad update already differs from XLA's in
the last bit, ``test_torch_sharded.py``); the bounds of JAX's tests (one
round-to-nearest cast, one quantization step) are checked beside them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu.parallel import alltoall as jax_a2a
from openembedding_tpu.parallel import precision as jax_precision
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu.utils.envconfig import EnvConfig as JaxEnvConfig
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel import alltoall, hot_cache, precision
from openembedding_tpu_torch.parallel.mesh import create_mesh
from openembedding_tpu_torch.utils import observability
from openembedding_tpu_torch.utils.envconfig import EnvConfig

ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}
SGD = {"category": "sgd", "learning_rate": 0.5}
VOCAB, DIM, BATCH = 1024, 8, 128
BF16_RTOL, BF16_ATOL = 2.0 ** -8, 1e-7


def _pair(devices8, plane, *, hash_=False, key_dtype="wide", dim=DIM,
          vocab=VOCAB, optimizer=ADAGRAD, **kw):
    """JAX's and the port's one-variable collections on 2 x 2, each
    initialized from key 0."""
    spec = dict(name="t", input_dim=-1 if hash_ else vocab, output_dim=dim,
                plane=plane, optimizer=optimizer, **kw)
    if hash_:
        spec.update(hash_capacity=1 << 12, key_dtype=key_dtype)
    jc = oe.EmbeddingCollection([oe.EmbeddingSpec(**spec)],
                                jax_mesh(2, 2, devices8[:4]))
    tc = EmbeddingCollection([EmbeddingSpec(**spec)],
                             create_mesh(2, 2, device="cpu"))
    return jc, jc.init(jax.random.PRNGKey(0)), tc, tc.init(ti.prng_key(0))


def _ids(rng, hash_=False, n=BATCH):
    if hash_:
        return (rng.integers(0, 300, n) * 7919 + 2**33).astype(np.int64)
    return rng.integers(0, VOCAB, n).astype(np.int32)


def _table(state):
    return hot_cache.unwrap(state)


def _np(x):
    return np.asarray(jax.device_get(x))


# --- the grammar and the specs ------------------------------------------------

@pytest.mark.parametrize("token", ["a2a", "a2a+bf16", "a2a+int8",
                                   "a2a+grouped+bf16", "a2a+pipelined+bf16",
                                   "a2a+pipelined+int8", "psum"])
def test_plane_token_parsing(token):
    assert precision.parse_plane(token) == jax_precision.parse_plane(token)
    base, ep, pp = precision.parse_plane(token)
    assert precision.plane_label(base, ep, pp) \
        == jax_precision.plane_label(base, ep, pp)
    for rung in ("f32", "bf16", "int8_ef"):
        assert precision.wire_itemsize(rung) \
            == jax_precision.wire_itemsize(rung)
    assert precision.wire_dtype("bf16") == torch.bfloat16
    assert precision.wire_dtype("f32") is None
    assert precision.ef_global_len(1000, 2, 2, True) \
        == jax_precision.ef_global_len(1000, 2, 2, True)
    assert precision.ef_global_len(1001, 2, 4, False) \
        == jax_precision.ef_global_len(1001, 2, 4, False)


def test_spec_normalizes_plane_suffix():
    for plane in ("a2a+pipelined+bf16", "a2a+int8", "a2a+grouped+bf16",
                  "a2a+cache+bf16"):
        kw = dict(name="x", input_dim=8, output_dim=2, plane=plane)
        t, j = EmbeddingSpec(**kw), oe.EmbeddingSpec(**kw)
        assert (t.plane, t.exchange_precision, t.push_precision) \
            == (j.plane, j.exchange_precision, j.push_precision)


@pytest.mark.parametrize("kw,match", [
    ({"plane": "psum", "exchange_precision": "bf16"}, "psum"),
    ({"plane": "psum+int8"}, "psum"),
    ({"plane": "a2a+grouped", "push_precision": "int8_ef"}, "int8_ef"),
    ({"plane": "a2a+cache", "push_precision": "int8_ef"}, "int8_ef"),
    ({"plane": "a2a+int8", "push_precision": "bf16"}, "explicitly"),
    ({"exchange_precision": "fp8"}, "unknown exchange_precision")])
def test_illegal_precision_combos_raise(kw, match):
    kw = dict(name="x", input_dim=8, output_dim=2, **kw)
    with pytest.raises(ValueError, match=match):
        oe.EmbeddingSpec(**kw)
    with pytest.raises(ValueError, match=match):
        EmbeddingSpec(**kw)


# --- the wires ---------------------------------------------------------------------

@pytest.mark.parametrize("hash_", [False, True], ids=["array", "hash"])
def test_precision_f32_is_the_same_plane(devices8, hash_):
    """The f32 rung is the base plane: the same spec, and rows and tables
    bit for bit, equal to JAX's."""
    _, _, c0, s0 = _pair(devices8, "a2a", hash_=hash_, optimizer=SGD)
    jc, js, c1, s1 = _pair(devices8, "a2a", hash_=hash_, optimizer=SGD,
                           exchange_precision="f32", push_precision="f32")
    assert c0.sharding_spec("t") == c1.sharding_spec("t")
    assert c1.sharding_spec("t").plane_label == "a2a"
    rng = np.random.default_rng(0)
    for _ in range(2):
        idx = _ids(rng, hash_)
        g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
        r0 = c0.pull(s0, {"t": idx}, batch_sharded=False)["t"]
        r1 = c1.pull(s1, {"t": idx}, batch_sharded=False)["t"]
        assert torch.equal(r0, r1)
        np.testing.assert_array_equal(
            r1.numpy(), _np(jc.pull(js, {"t": idx}, batch_sharded=False)["t"]))
        c0.apply_gradients(s0, {"t": idx}, {"t": torch.from_numpy(g)},
                           batch_sharded=False)
        c1.apply_gradients(s1, {"t": idx}, {"t": torch.from_numpy(g)},
                           batch_sharded=False)
        js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                                batch_sharded=False)
        assert torch.equal(s0["t"].weights, s1["t"].weights)
        np.testing.assert_array_equal(s1["t"].weights.numpy(),
                                      _np(js["t"].weights))


@pytest.mark.parametrize("hash_", [False, True], ids=["array", "wide-hash"])
def test_bf16_pull_equals_jax_exactly(devices8, hash_):
    """One round-to-nearest cast a pulled row: the port's bf16 rows are
    JAX's bit for bit, the bf16 rounding of the f32 rows, within 2^-9
    of them, and not the f32 rows (the wire really narrowed)."""
    _, _, c0, s0 = _pair(devices8, "a2a", hash_=hash_, optimizer=SGD)
    jc, js, c1, s1 = _pair(devices8, "a2a+bf16", hash_=hash_, optimizer=SGD)
    rng = np.random.default_rng(1)
    idx = _ids(rng, hash_)
    g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    # a push first, so hash keys exist and rows are not all init rows
    for c, s in ((c0, s0), (c1, s1)):
        c.apply_gradients(s, {"t": idx}, {"t": torch.from_numpy(g)},
                          batch_sharded=False)
    js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                            batch_sharded=False)
    r0 = c0.pull(s0, {"t": idx}, batch_sharded=False)["t"]
    r1 = c1.pull(s1, {"t": idx}, batch_sharded=False)["t"]
    assert alltoall.WIRE["pull"]["payload_dtype"] == "bfloat16"
    np.testing.assert_array_equal(
        r1.numpy(), _np(jc.pull(js, {"t": idx}, batch_sharded=False)["t"]))
    # against the f32 rows of the same f32 table state
    f32_rows = c0.pull({"t": _table(s1["t"])}, {"t": idx},
                       batch_sharded=False)["t"]
    assert torch.equal(r1, f32_rows.to(torch.bfloat16).float())
    assert ((r1 - f32_rows).abs()
            <= f32_rows.abs() * BF16_RTOL + BF16_ATOL).all()
    assert not torch.equal(r1, f32_rows)


@pytest.mark.parametrize("hash_", [False, True], ids=["array", "wide-hash"])
def test_bf16_push_one_step_parity(devices8, hash_):
    """The bf16 push equals JAX's (Adagrad, rtol 1e-5) and stays within
    JAX's bound of the f32 push (``lr * 2^-8 * 4 max|g| / sqrt(0.1)``)."""
    _, _, c0, s0 = _pair(devices8, "a2a", hash_=hash_)
    jc, js, c1, s1 = _pair(devices8, "a2a+bf16", hash_=hash_)
    rng = np.random.default_rng(2)
    idx = _ids(rng, hash_)
    g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    c0.apply_gradients(s0, {"t": idx}, {"t": torch.from_numpy(g)},
                       batch_sharded=False)
    c1.apply_gradients(s1, {"t": idx}, {"t": torch.from_numpy(g)},
                       batch_sharded=False)
    js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                            batch_sharded=False)
    w1 = s1["t"].weights.numpy()
    np.testing.assert_allclose(w1, _np(js["t"].weights), rtol=1e-5,
                               atol=1e-7)
    bound = 0.1 * BF16_RTOL * np.abs(g).max() * 4 / np.sqrt(0.1)
    assert np.abs(w1 - s0["t"].weights.numpy()).max() <= bound
    assert alltoall.WIRE["push"]["payload_dtype"] == "bfloat16"


def test_wire_bytes_narrow_with_the_rung(devices8):
    """The semantic twin of JAX's byte contracts, read from the buffers
    that cross: the row payload of a bf16 pull and push is half the f32
    one, an int8 push's a quarter; keys and counts cross as integers
    (the int8 scale one more channel)."""
    got = {}
    rng = np.random.default_rng(3)
    idx = _ids(rng)
    g = torch.from_numpy(rng.standard_normal((BATCH, DIM)).astype(
        np.float32))
    for plane in ("a2a", "a2a+bf16", "a2a+int8"):
        _, _, c, s = _pair(devices8, plane)
        c.pull(s, {"t": idx}, batch_sharded=False)
        c.apply_gradients(s, {"t": idx}, {"t": g}, batch_sharded=False)
        got[plane] = {v: dict(alltoall.WIRE[v]) for v in ("pull", "push")}
    f32, bf, i8 = got["a2a"], got["a2a+bf16"], got["a2a+int8"]
    assert bf["pull"]["payload"] * 2 == f32["pull"]["payload"]
    assert bf["push"]["payload"] * 2 == f32["push"]["payload"]
    assert i8["push"]["payload"] * 4 == f32["push"]["payload"]
    assert (f32["push"]["payload_dtype"], bf["push"]["payload_dtype"],
            i8["push"]["payload_dtype"]) == ("float32", "bfloat16", "int8")
    assert i8["push"]["keys"] * 2 == f32["push"]["keys"] * 3
    assert f32["pull"]["keys"] == bf["pull"]["keys"]


def test_bf16_parity_grouped(devices8):
    """The bf16 wire on the grouped plane: one bf16 round a group, each
    table's rows JAX's exactly and within one cast of the f32 group's."""
    def pair(plane):
        specs = [dict(name=f"t{i}", input_dim=512 + 64 * i, output_dim=8,
                      plane=plane, optimizer=SGD) for i in range(3)]
        jc = oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in specs],
                                    jax_mesh(2, 2, devices8[:4]))
        tc = EmbeddingCollection([EmbeddingSpec(**k) for k in specs],
                                 create_mesh(2, 2, device="cpu"))
        return jc, jc.init(jax.random.PRNGKey(0)), tc, tc.init(
            ti.prng_key(0))

    rng = np.random.default_rng(4)
    idx = {f"t{i}": rng.integers(0, 500, BATCH).astype(np.int32)
           for i in range(3)}
    g = {k: rng.standard_normal((BATCH, 8)).astype(np.float32) for k in idx}
    _, _, c0, s0 = pair("a2a+grouped")
    jc, js, c1, s1 = pair("a2a+grouped+bf16")
    r0 = c0.pull(s0, idx, batch_sharded=False)
    r1 = c1.pull(s1, idx, batch_sharded=False)
    for k in idx:
        a = r0[k]
        assert ((r1[k] - a).abs() <= a.abs() * BF16_RTOL + BF16_ATOL).all()
    for c, s in ((c0, s0), (c1, s1)):
        c.apply_gradients(s, idx, {k: torch.from_numpy(v)
                                   for k, v in g.items()},
                          batch_sharded=False)
    js = jc.apply_gradients(js, idx, {k: jnp.asarray(v)
                                      for k, v in g.items()},
                            batch_sharded=False)
    r1 = c1.pull(s1, idx, batch_sharded=False)
    jr = jc.pull(js, idx, batch_sharded=False)
    for k in idx:
        np.testing.assert_array_equal(r1[k].numpy(), _np(jr[k]))
        np.testing.assert_array_equal(s1[k].weights.numpy(),
                                      _np(js[k].weights))


# --- int8 error feedback --------------------------------------------------------

@pytest.mark.parametrize("hash_", [False, True], ids=["array", "wide-hash"])
def test_int8_ef_trajectory_matches_jax(devices8, hash_):
    """5 pushes of one repeated batch (each sender's residual recirculated
    every step): after each, every sender's keys and residuals equal
    JAX's exactly and the table JAX's at rtol 1e-5; the drift from f32 is within JAX's bound and
    no worse than the feedback-free run's."""
    _, _, c0, s0 = _pair(devices8, "a2a", hash_=hash_)
    jc, js, c1, s1 = _pair(devices8, "a2a+int8", hash_=hash_)
    _, _, c2, s2 = _pair(devices8, "a2a+int8", hash_=hash_)
    assert isinstance(s1["t"], precision.EFState)
    assert s1["t"].keys.shape[0] == 0 == js["t"].keys.shape[0]
    rng = np.random.default_rng(5)
    idx = _ids(rng, hash_)
    g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    tg = {"t": torch.from_numpy(g)}
    for step in range(5):
        c0.apply_gradients(s0, {"t": idx}, tg, batch_sharded=False)
        c1.apply_gradients(s1, {"t": idx}, tg, batch_sharded=False)
        s2["t"] = hot_cache.unwrap(s2["t"])      # no feedback
        c2.apply_gradients(s2, {"t": idx}, tg, batch_sharded=False)
        js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                                batch_sharded=False)
        ef, jef = s1["t"], js["t"]
        keys, resid = interop.ef_state_to_numpy(ef)
        np.testing.assert_array_equal(keys, _np(jef.keys))
        np.testing.assert_array_equal(resid, _np(jef.resid))
        np.testing.assert_allclose(ef.table.weights.numpy(),
                                   _np(jef.table.weights), rtol=1e-5,
                                   atol=1e-7)
        assert float(ef.resid.abs().max()) > 0, step
    w0 = s0["t"].weights.numpy()
    d_ef = np.abs(_table(s1["t"]).weights.numpy() - w0).max()
    d_no = np.abs(_table(s2["t"]).weights.numpy() - w0).max()
    q = 0.1 * (4 * np.abs(g).max() / 254) / np.sqrt(0.1)
    assert d_ef <= 8 * q, (d_ef, q)
    assert d_ef <= d_no + 0.25 * q, (d_ef, d_no)


def test_int8_ef_int64_keys_match_int32_twin():
    """int64-key tables keep int64 residual keys (``ef_key_space``): a
    trajectory over keys that fit int32 pulls the rows of the same
    trajectory on an int32-key table, and its residuals are the same."""
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 5000, BATCH)
    g = torch.from_numpy(rng.standard_normal((BATCH, DIM)).astype(
        np.float32))
    out = {}
    for kd in ("int32", "int64"):
        c = EmbeddingCollection(
            [EmbeddingSpec("t", -1, DIM, plane="a2a+int8", key_dtype=kd,
                           hash_capacity=1 << 12, optimizer=ADAGRAD)],
            create_mesh(2, 2, device="cpu"))
        s = c.init(ti.prng_key(0))
        ids = idx.astype(np.int64 if kd == "int64" else np.int32)
        for _ in range(3):
            c.apply_gradients(s, {"t": ids}, {"t": g}, batch_sharded=False)
        assert s["t"].keys.dtype == (torch.int64 if kd == "int64"
                                     else torch.int32)
        keys = s["t"].keys
        # each dtype's EMPTY sentinel as -1, the keys as int64
        keys = torch.where(keys == torch.iinfo(keys.dtype).min, -1,
                           keys.to(torch.int64))
        out[kd] = (c.pull(s, {"t": ids}, batch_sharded=False)["t"], keys,
                   s["t"].resid)
    for a, b in zip(out["int32"], out["int64"]):
        assert torch.equal(a, b)


def test_match_prev_keys_forced_mix_collision():
    """Two previous wide keys whose 32-bit mix collides: the matcher
    returns JAX's candidate and flags; the second key's residual is
    forfeited (not found), never another key's taken."""
    mix = lambda lo, hi: ((lo * 0x85EBCA6B) ^ (hi * 0xC2B2AE35)) \
        & 0xFFFFFFFF                                      # noqa: E731
    a = (5, 1)
    target = mix(*a)
    # solve lo for hi = 2: lo * C1 = target ^ (2 * C2) mod 2^32
    inv = pow(0x85EBCA6B, -1, 2**32)
    lo_b = ((target ^ (2 * 0xC2B2AE35 & 0xFFFFFFFF)) * inv) & 0xFFFFFFFF
    b = (lo_b - 2**32 if lo_b >= 2**31 else lo_b, 2)
    assert mix(b[0] & 0xFFFFFFFF, b[1]) == target
    sentinel = -2**31
    prev = np.array([[a[0], a[1]], [b[0], b[1]], [9, 9],
                     [sentinel, sentinel]], np.int32)
    cur = np.array([[b[0], b[1]], [a[0], a[1]], [9, 9], [7, 7]], np.int32)
    jc, jeq = jax_a2a._match_prev_keys(jnp.asarray(cur), jnp.asarray(prev))
    tc, teq = alltoall._match_prev_keys(torch.from_numpy(cur)[None],
                                        torch.from_numpy(prev)[None])
    np.testing.assert_array_equal(tc[0].numpy(), _np(jc))
    np.testing.assert_array_equal(teq[0].numpy(), _np(jeq))
    # one of the colliding pair matches, the other is forfeited
    assert teq[0].tolist()[:2].count(True) == 1 and teq[0][2]
    assert not teq[0][3]
    # what a sender carries: a matched key's own residual, else 0
    pr = torch.arange(4, dtype=torch.float32).reshape(1, 4, 1) + 1
    valid = torch.ones((1, 4), dtype=torch.bool)
    carried = alltoall._carried_residual(
        torch.from_numpy(cur)[None], valid,
        (torch.from_numpy(prev)[None], pr))[0, :, 0].tolist()
    for i, key in enumerate(map(tuple, cur.tolist())):
        own = [j for j, p in enumerate(map(tuple, prev.tolist()))
               if p == key]
        assert carried[i] in ((pr[0, own[0], 0].item(),) if own else ()) \
            + (0.0,)
    assert carried[2] == 3.0 and carried[3] == 0.0


def test_int8_ef_state_threading(devices8):
    """The residual wraps the table from init (empty), is sized by the
    first push, keeps its buffers across same-shape steps (in place),
    re-sizes on a batch change; pulls read through it."""
    _, _, coll, states = _pair(devices8, "a2a+int8")
    ef = states["t"]
    assert isinstance(ef, precision.EFState) and ef.keys.shape[0] == 0
    rng = np.random.default_rng(7)
    idx = _ids(rng)
    g = {"t": torch.from_numpy(rng.standard_normal((BATCH, DIM)).astype(
        np.float32))}
    coll.apply_gradients(states, {"t": idx}, g, batch_sharded=False)
    assert states["t"] is ef
    n = ef.keys.shape[0]
    assert n == precision.ef_global_len(BATCH, 2, 2, False)
    assert ef.resid.shape == (n, DIM)
    ptr = ef.resid.data_ptr()
    coll.apply_gradients(states, {"t": idx}, g, batch_sharded=False)
    assert ef.resid.data_ptr() == ptr and float(ef.resid.abs().max()) > 0
    idx2 = idx[:64]
    coll.apply_gradients(states, {"t": idx2}, {"t": g["t"][:64]},
                         batch_sharded=False)
    assert ef.keys.shape[0] != n
    rows = coll.pull(states, {"t": idx}, batch_sharded=False)["t"]
    assert rows.shape == (BATCH, DIM)
    # the Trainer's pre-sizing: the buffers a step program will bind
    coll.size_ef(states, {"t": idx}, batch_sharded=True)
    assert ef.keys.shape[0] == precision.ef_global_len(BATCH, 2, 2, True)


def test_quant_observability_counters(devices8):
    """``quant_error_max`` and ``quant_residual_norm`` sum one value a
    sender and push, as JAX's per-device callbacks do, equal to JAX's;
    /metrics carries them."""
    rng = np.random.default_rng(8)
    idx = _ids(rng)
    g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    import openembedding_tpu.utils.observability as jobs
    import time
    jc, js, tc, ts = _pair(devices8, "a2a+int8")
    snaps = []
    for obs, run in (
            (jobs, lambda: jc.apply_gradients(
                js, {"t": idx}, {"t": jnp.asarray(g)},
                batch_sharded=False)),
            (observability, lambda: tc.apply_gradients(
                ts, {"t": idx}, {"t": torch.from_numpy(g)},
                batch_sharded=False))):
        obs.GLOBAL.reset()
        obs.set_evaluate_performance(True)
        try:
            out = run()
            jax.block_until_ready(jax.tree.leaves(out))
            time.sleep(0.2)   # JAX's callbacks drain asynchronously
            snaps.append(obs.GLOBAL.snapshot())
            text = obs.prometheus_text()
            assert "oe_quant_residual_norm_total" in text
            assert "oe_quant_error_max_total" in text
        finally:
            obs.set_evaluate_performance(False)
            obs.GLOBAL.reset()
    for name in ("quant_error_max", "quant_residual_norm"):
        np.testing.assert_allclose(snaps[1][name]["count"],
                                   snaps[0][name]["count"], rtol=1e-6)


def test_int8_ef_state_never_checkpointed(devices8, tmp_path):
    """The dump holds only the table (JAX's files read back); a restore
    attaches an empty residual and pulls the same rows."""
    jc, js, coll, states = _pair(devices8, "a2a+int8", vocab=512)
    rng = np.random.default_rng(10)
    idx = rng.integers(0, 512, 64).astype(np.int32)
    g = rng.standard_normal((64, DIM)).astype(np.float32)
    coll.apply_gradients(states, {"t": idx}, {"t": torch.from_numpy(g)},
                         batch_sharded=False)
    assert float(states["t"].resid.abs().max()) > 0
    before = coll.pull(states, {"t": idx}, batch_sharded=False)["t"]
    tck.save_checkpoint(str(tmp_path / "m"), coll, states)
    loaded = tck.load_checkpoint(str(tmp_path / "m"), coll)
    assert isinstance(loaded["t"], precision.EFState)
    assert loaded["t"].keys.shape[0] == 0
    assert torch.equal(before, coll.pull(loaded, {"t": idx},
                                         batch_sharded=False)["t"])
    jl = jax_ckpt.load_checkpoint(str(tmp_path / "m"), jc)
    assert isinstance(jl["t"], jax_precision.EFState)
    np.testing.assert_array_equal(
        before.numpy(), _np(jc.pull(jl, {"t": idx}, batch_sharded=False)["t"]))


def test_int8_ef_single_shard_structure_stable():
    """One shard has no wire: no residual is attached, and a push leaves
    the state's type as it was (JAX's structure rule)."""
    coll = EmbeddingCollection(
        [EmbeddingSpec("t", 64, 4, plane="a2a+int8", optimizer=ADAGRAD)],
        create_mesh(1, 1, device="cpu"))
    states = coll.init(ti.prng_key(0))
    assert not isinstance(states["t"], precision.EFState)
    rng = np.random.default_rng(11)
    coll.apply_gradients(states, {"t": rng.integers(0, 64, 16)},
                         {"t": torch.ones(16, 4)})
    assert not isinstance(states["t"], precision.EFState)


def test_bf16_tables_round_trip_on_compressed_planes(devices8, tmp_path):
    """bf16 storage on a compressed plane (JAX's checkpoint cases): a
    2 x 2 save of a bf16 table loads back bit for bit, JAX's loader reads
    it; an f32 dump loads into a bf16 collection (downcast), a bf16 dump
    into an f32 one (exact upcast)."""
    def coll(dtype):
        return EmbeddingCollection(
            [EmbeddingSpec("arr", 256, 8, dtype=dtype, plane="a2a+bf16",
                           optimizer=ADAGRAD),
             EmbeddingSpec("h", -1, 8, dtype=dtype, plane="a2a+bf16",
                           hash_capacity=1024, optimizer=ADAGRAD)],
            create_mesh(2, 2, device="cpu"))
    rng = np.random.default_rng(12)
    idx = {"arr": rng.integers(0, 256, 64), "h": rng.integers(0, 9999, 64)}
    g = {k: torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32)) for k in idx}
    cb, cf = coll("bfloat16"), coll("float32")
    sb = cb.init(ti.prng_key(0))
    cb.apply_gradients(sb, idx, g, batch_sharded=False)
    before = cb.pull(sb, idx, batch_sharded=False)
    tck.save_checkpoint(str(tmp_path / "b"), cb, sb)
    back = tck.load_checkpoint(str(tmp_path / "b"), cb)
    assert back["arr"].weights.dtype == torch.bfloat16
    after = cb.pull(back, idx, batch_sharded=False)
    up = tck.load_checkpoint(str(tmp_path / "b"), cf)
    assert up["arr"].weights.dtype == torch.float32
    for k in idx:
        assert torch.equal(before[k], after[k])
        assert torch.equal(before[k].float(),
                           cf.pull(up, idx, batch_sharded=False)[k])
    jcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec("arr", 256, 8, dtype="bfloat16",
                          plane="a2a+bf16", optimizer=ADAGRAD),
         oe.EmbeddingSpec("h", -1, 8, dtype="bfloat16", plane="a2a+bf16",
                          hash_capacity=1024, optimizer=ADAGRAD)],
        jax_mesh(2, 2, devices8[:4]))
    jl = jax_ckpt.load_checkpoint(str(tmp_path / "b"), jcoll)
    jr = jcoll.pull(jl, {k: jnp.asarray(v.astype(np.int32))
                         for k, v in idx.items()}, batch_sharded=False)
    for k in idx:
        np.testing.assert_array_equal(before[k].float().numpy(),
                                      _np(jr[k]).astype(np.float32))
    sf = cf.init(ti.prng_key(1))
    tck.save_checkpoint(str(tmp_path / "f"), cf, sf)
    down = tck.load_checkpoint(str(tmp_path / "f"), cb)
    assert down["arr"].weights.dtype == torch.bfloat16


def test_envconfig_exchange_section():
    cfg = EnvConfig.load(config={"exchange": {"precision": "bf16",
                                              "push_precision": "int8_ef"}})
    jcfg = JaxEnvConfig.load(config={"exchange": {
        "precision": "bf16", "push_precision": "int8_ef"}})
    assert cfg.exchange.spec_kwargs() == jcfg.exchange.spec_kwargs() == {
        "exchange_precision": "bf16", "push_precision": "int8_ef"}
    spec = EmbeddingSpec(name="x", input_dim=8, output_dim=2,
                         **cfg.exchange.spec_kwargs())
    assert spec.push_precision == "int8_ef"
    with pytest.raises(ValueError, match="bf16"):
        EnvConfig.load(config={"exchange": {"precision": "fp8"}})
    assert EnvConfig.load(env={"OE_EXCHANGE_PRECISION": "bf16"}
                          ).exchange.precision == "bf16"


def test_ef_state_crosses_interop(devices8):
    """JAX's table and residual after two pushes, carried into the port
    (``interop.ef_state_from_numpy``): one more push on each side gives
    the same residual, bit for bit, and the same rows at rtol 1e-5."""
    jc, js, tc, _ = _pair(devices8, "a2a+int8")
    rng = np.random.default_rng(13)
    idx = _ids(rng)
    g = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    for _ in range(2):
        js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                                batch_sharded=False)
    jt = js["t"].table
    table = interop.sharded_table_state_from_numpy(
        _np(jt.weights), {k: _np(v) for k, v in jt.slots.items()}, 4, "cpu")
    states = {"t": interop.ef_state_from_numpy(
        table, _np(js["t"].keys), _np(js["t"].resid), "cpu")}
    keys, resid = interop.ef_state_to_numpy(states["t"])
    np.testing.assert_array_equal(resid, _np(js["t"].resid))
    tc.apply_gradients(states, {"t": idx}, {"t": torch.from_numpy(g)},
                       batch_sharded=False)
    js = jc.apply_gradients(js, {"t": idx}, {"t": jnp.asarray(g)},
                            batch_sharded=False)
    np.testing.assert_array_equal(states["t"].resid.numpy(),
                                  _np(js["t"].resid))
    np.testing.assert_allclose(states["t"].table.weights.numpy(),
                               _np(js["t"].table.weights), rtol=1e-5,
                               atol=1e-7)
