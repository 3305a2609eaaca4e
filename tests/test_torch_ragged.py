"""Torch port, sequence features against the JAX package: ``ragged.py``'s
padding and pooling, pooled variables in the ``EmbeddingCollection``
(pull, push) on array, int32-key hash and wide-key hash variables, the
pair-axis rule of pooled wide variables, ``model_meta``, a checkpoint of
pooled variables, and the serving contract for pooled sequences over
REST.

Exact where the work is integer, a copy or the pooling itself: padding,
masks and lengths, pooled rows (the port adds a sequence in XLA's order,
bit for bit up to L = 32), the expanded gradients, hash keys arrays and
``lookup_bin`` bodies byte for byte. Pushed rows and slots at rtol 1e-6
(the same float32 optimizer maths in another operation order). JAX's
pulls and pushes run compiled (``jax.jit``), as its trainer runs them.
"""

import http.client
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jckpt
from openembedding_tpu import ragged as jr
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu.serving.rest import ControllerServer as JaxServer
from openembedding_tpu_torch import checkpoint as tckpt
from openembedding_tpu_torch import ragged as tr
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                               EmbeddingSpec)
from openembedding_tpu_torch.serving.rest import ControllerServer

EMPTY = -2**31
VOCAB, DIM, B, L = 48, 4, 12, 5
OPT = {"category": "adagrad", "learning_rate": 0.05}


def _sequences(rng, n, lo, hi, max_len=L):
    return [rng.randint(lo, hi, rng.randint(0, max_len + 1))
            for _ in range(n)]


# --- padding, masks, lengths -------------------------------------------------

@pytest.mark.parametrize("max_len", [None, 3, L])
@pytest.mark.parametrize("dtype,pad", [(np.int32, -1), (np.int32, EMPTY),
                                       (np.int64, -2**63)])
def test_pad_ragged_matches_jax(max_len, dtype, pad):
    seqs = _sequences(np.random.RandomState(0), B, 0, VOCAB)
    got = tr.pad_ragged(seqs, max_len=max_len, pad_id=pad, dtype=dtype)
    want = jr.pad_ragged(seqs, max_len=max_len, pad_id=pad, dtype=dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pad_ragged_guards_match_jax():
    with pytest.raises(ValueError, match="does not fit"):
        tr.pad_ragged([[1]], pad_id=-2**63, dtype=np.int32)
    with pytest.raises(ValueError, match="does not fit"):
        jr.pad_ragged([[1]], pad_id=-2**63, dtype=np.int32)
    np.testing.assert_array_equal(tr.pad_ragged([]), jr.pad_ragged([]))
    np.testing.assert_array_equal(tr.pad_ragged([[], []]),
                                  jr.pad_ragged([[], []]))


@pytest.mark.parametrize("max_len", [None, 2])
def test_pad_ragged_wide_matches_jax(max_len):
    rng = np.random.RandomState(1)
    seqs = [rng.randint(-2**62, 2**62, rng.randint(0, L + 1),
                        dtype=np.int64) for _ in range(B)]
    np.testing.assert_array_equal(tr.pad_ragged_wide(seqs, max_len),
                                  jr.pad_ragged_wide(seqs, max_len))
    band = [[5, -2**63 + 7]]
    for mod in (tr, jr):
        with pytest.raises(ValueError, match="EMPTY band"):
            mod.pad_ragged_wide(band)


@pytest.mark.parametrize("case", ["array", "narrow_hash", "wide"])
def test_valid_mask_and_lengths_match_jax(case):
    rng = np.random.RandomState(2)
    if case == "wide":
        ids = tr.pad_ragged_wide([rng.randint(-2**40, 2**40, n)
                                  for n in rng.randint(0, L + 1, B)], L)
        args = (EMPTY, None, True)
    elif case == "narrow_hash":
        ids = tr.pad_ragged(_sequences(rng, B, -2**31 + 1, 2**31 - 1),
                            L, pad_id=EMPTY)
        args = (EMPTY, None, False)
    else:
        ids = tr.pad_ragged(_sequences(rng, B, -3, VOCAB + 3), L)
        args = (-1, VOCAB, False)
    t = torch.from_numpy(ids)
    np.testing.assert_array_equal(tr.valid_mask(t, *args).numpy(),
                                  np.asarray(jr.valid_mask(ids, *args)))
    got = tr.seq_lengths(t, *args).numpy()
    want = np.asarray(jr.seq_lengths(ids, *args))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1


# --- pooling -----------------------------------------------------------------

@pytest.mark.parametrize("pooling", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("length,dim", [(1, 4), (L, 4), (L, 1), (32, 9),
                                        (32, 1)])
def test_pool_rows_and_vjp_bit_equal_jax(pooling, length, dim):
    """Bit for bit, but for ``sqrtn`` on dim-1 rows: XLA multiplies by
    its ``rsqrt`` approximation there (``ragged.py``), within 2 ulps."""
    rng = np.random.RandomState(3)
    ids = tr.pad_ragged(_sequences(rng, B, 0, VOCAB, length), length)
    rows = (rng.randn(B, length, dim)
            * rng.choice([1e-4, 1.0, 1e3], (B, length, dim))).astype(
                np.float32)
    rows[ids < 0] = 0.0                 # padding rows are zero by contract
    g = rng.randn(B, dim).astype(np.float32)
    def check(got, want):
        if pooling == "sqrtn" and dim == 1:
            np.testing.assert_allclose(got, want, rtol=2.0**-22, atol=0)
        else:
            np.testing.assert_array_equal(got, want)
    check(tr.pool_rows(torch.from_numpy(rows), torch.from_numpy(ids),
                       pooling, -1, VOCAB).numpy(),
          np.asarray(jax.jit(lambda r, i: jr.pool_rows(
              r, i, pooling, -1, VOCAB))(rows, ids)))
    check(tr.expand_pooled_grads(torch.from_numpy(g), torch.from_numpy(ids),
                                 pooling, -1, VOCAB).numpy(),
          np.asarray(jax.jit(lambda x, i: jr.expand_pooled_grads(
              x, i, pooling, -1, VOCAB))(g, ids)))


def test_pooling_guards():
    with pytest.raises(ValueError, match="unknown pooling"):
        tr.pool_rows(torch.zeros(2, 3, 4), torch.zeros(2, 3), "max", -1)
    with pytest.raises(ValueError, match=r"\[B, L, dim\]"):
        tr.pool_rows(torch.zeros(2, 4), torch.zeros(2), "sum", -1)


# --- pooled variables in the collection --------------------------------------

def _spec_kwargs(kind):
    if kind == "array":
        return {"input_dim": VOCAB}
    return {"input_dim": -1, "hash_capacity": 1024,
            "key_dtype": "int32" if kind == "int32_hash" else "wide"}


def _seq_ids(kind, seed, length=L):
    """A padded ``[B, length]`` id matrix for a variable of ``kind``, with
    repeated ids (rows pushed twice) and empty sequences."""
    rng = np.random.RandomState(seed)
    if kind == "array":
        seqs = _sequences(rng, B, -2, VOCAB + 2, length)
        return tr.pad_ragged(seqs, length)
    seqs = _sequences(rng, B, 0, 2 * VOCAB, length)
    if kind == "wide":
        return tr.pad_ragged_wide([np.asarray(s, np.int64) * 2**33 + s
                                   for s in seqs], length)
    return tr.pad_ragged(seqs, length, pad_id=EMPTY)


def _collections(devices8, specs):
    mesh = create_mesh(1, 1, devices8[:1])
    jcoll = oe.EmbeddingCollection([oe.EmbeddingSpec(**s) for s in specs],
                                   mesh)
    tcoll = EmbeddingCollection([EmbeddingSpec(**s) for s in specs],
                                device="cpu", seed=0)
    return jcoll, tcoll


def _table_arrays(state):
    out = {"weights": np.asarray(state.weights)}
    out.update({k: np.asarray(v) for k, v in state.slots.items()})
    if hasattr(state, "keys"):
        out["keys"] = np.asarray(state.keys)
    return out


@pytest.mark.parametrize("pooling", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("kind", ["array", "int32_hash", "wide"])
def test_pooled_pull_and_push_match_jax(devices8, kind, pooling):
    """Pooled rows bit-equal to JAX's from the same initial state (array
    tables and hash init rows as JAX draws them); after a push of the
    same pooled gradients, keys arrays exact and rows and slots at rtol
    1e-6; no padding key stored."""
    spec = {"name": "seq", "output_dim": DIM, "pooling": pooling,
            "optimizer": OPT, **_spec_kwargs(kind)}
    jcoll, tcoll = _collections(devices8, [spec])
    jstates = jcoll.init(jax.random.PRNGKey(0))
    tstates = tcoll.init()
    ids = _seq_ids(kind, seed=4)
    jpull = jax.jit(lambda st, x: jcoll.pull(st, {"seq": x}))
    got = tcoll.pull(tstates, {"seq": ids})["seq"]
    want = np.asarray(jpull(jstates, jnp.asarray(ids))["seq"])
    assert got.shape == (B, DIM)
    np.testing.assert_array_equal(got.numpy(), want)
    g = np.random.RandomState(5).randn(B, DIM).astype(np.float32)
    jstates = jax.jit(lambda st, x, gr: jcoll.apply_gradients(
        st, {"seq": x}, {"seq": gr}))(jstates, jnp.asarray(ids),
                                      jnp.asarray(g))
    tcoll.apply_gradients(tstates, {"seq": ids}, {"seq": torch.from_numpy(g)})
    want, got = _table_arrays(jstates["seq"]), _table_arrays(tstates["seq"])
    if "keys" in want:
        np.testing.assert_array_equal(got.pop("keys"), want.pop("keys"))
        valid = ids[..., 1] != EMPTY if kind == "wide" else ids != EMPTY
        flat = ids[valid]
        distinct = len(np.unique(flat, axis=0) if kind == "wide"
                       else np.unique(flat))
        assert tstates["seq"].num_used() == distinct
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)


def test_pooled_wide_two_long_sequence_is_not_pairs(devices8):
    """On a pooled wide-hash variable a narrow ``[B, 2]`` id matrix is B
    sequences of two ids (JAX: ``pair_ndim = 3`` for pooled specs), not B
    (lo, hi) pairs: its pooled rows equal JAX's ``collection.pull``, on
    host ids and on tensors, narrow int32 and int64 alike."""
    spec = {"name": "seq", "output_dim": DIM, "pooling": "mean",
            "optimizer": OPT, **_spec_kwargs("wide")}
    jcoll, tcoll = _collections(devices8, [spec])
    jstates = jcoll.init(jax.random.PRNGKey(0))
    tstates = tcoll.init()
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 1000, (B, 2)).astype(np.int32)
    ids[::3, 1] = EMPTY                     # length-1 sequences
    ids64 = np.where(ids == EMPTY, -2**63, ids)     # int64's sentinel
    for x, jx in ((ids, jnp.asarray(ids)), (torch.from_numpy(ids), ids),
                  (ids64, ids64)):
        want = np.asarray(jcoll.pull(jstates, {"seq": jx})["seq"])
        assert want.shape == (B, DIM)
        got = tcoll.pull(tstates, {"seq": x})["seq"]
        np.testing.assert_array_equal(got.numpy(), want)
    # the same matrix as a flat pair list on the serving plane: B rows
    rows = tcoll.pull(tstates, {"seq": ids}, read_only=True,
                      serving_rows=True)["seq"]
    assert rows.shape == (B, DIM)


def test_model_meta_with_pooling_matches_jax(devices8):
    specs = [{"name": "a", "input_dim": 30, "output_dim": 9},
             {"name": "h", "input_dim": 30, "output_dim": 9,
              "pooling": "mean"},
             {"name": "h:linear", "input_dim": 30, "output_dim": 1,
              "pooling": "sum"},
             {"name": "w", "input_dim": -1, "output_dim": 3,
              "pooling": "sqrtn"}]
    jcoll, tcoll = _collections(devices8, specs)
    got = tcoll.model_meta("s", "u").dumps()
    assert got == jcoll.model_meta("s", "u").dumps()
    assert json.loads(got)["extra"]["variable_pooling"] == {
        "h": "mean", "h:linear": "sum", "w": "sqrtn"}


def test_pooled_checkpoint_round_trip(devices8, tmp_path):
    """A collection with pooled variables saves and loads in the local
    full layout: the meta keeps ``variable_pooling``, the JAX package
    loads the dump to the same rows, and the port loads it back."""
    specs = [{"name": "seq", "output_dim": DIM, "pooling": "mean",
              "optimizer": OPT, **_spec_kwargs("array")},
             {"name": "wseq", "output_dim": DIM, "pooling": "sum",
              "optimizer": OPT, **_spec_kwargs("wide")}]
    jcoll, tcoll = _collections(devices8, specs)
    tstates = tcoll.init()
    ids = {"seq": _seq_ids("array", 7), "wseq": _seq_ids("wide", 8)}
    g = {k: torch.ones(B, DIM) for k in ids}
    tcoll.apply_gradients(tstates, ids, g)
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, tcoll, tstates)
    meta = json.loads(open(f"{path}/model_meta").read())
    assert meta["extra"]["variable_pooling"] == {"seq": "mean",
                                                 "wseq": "sum"}
    back = tckpt.load_checkpoint(path, tcoll)
    jstates = jckpt.load_checkpoint(path, jcoll)
    for name, x in ids.items():
        got = tcoll.pull(back, {name: x}, read_only=True)[name].numpy()
        np.testing.assert_array_equal(
            got, tcoll.pull(tstates, {name: x}, read_only=True)[name].numpy())
        want = np.asarray(jax.jit(lambda st, v: jcoll.pull(
            st, {name: v}, read_only=True))(jstates, jnp.asarray(x))[name])
        np.testing.assert_array_equal(got, want)


# --- serving -----------------------------------------------------------------

SIGN = "pooled-3"


def _req(server, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.request("POST", path, body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _bin_body(variable, ids):
    head = {"variable": variable, "dtype": str(ids.dtype),
            "shape": list(ids.shape)}
    return json.dumps(head).encode() + b"\n" + ids.tobytes()


@pytest.fixture(scope="module")
def pooled_served(tmp_path_factory):
    """A JAX checkpoint of pooled variables (array mean, array sum, wide
    hash sqrtn; one push), served by the JAX server and the port's."""
    mesh = create_mesh(1, 1, jax.devices()[:1])
    specs = [oe.EmbeddingSpec(name="hist", input_dim=VOCAB, output_dim=DIM,
                              pooling="mean", optimizer=OPT),
             oe.EmbeddingSpec(name="hist:linear", input_dim=VOCAB,
                              output_dim=1, pooling="sum", optimizer=OPT),
             oe.EmbeddingSpec(name="whist", input_dim=-1, output_dim=DIM,
                              pooling="sqrtn", hash_capacity=1024,
                              optimizer=OPT)]
    coll = oe.EmbeddingCollection(specs, mesh)
    states = coll.init(jax.random.PRNGKey(2))
    ids = {"hist": _seq_ids("array", 9), "hist:linear": _seq_ids("array", 9),
           "whist": _seq_ids("wide", 10)}
    grads = {k: jnp.ones((B, s.output_dim)) for k, s in
             zip(ids, specs)}
    states = coll.apply_gradients(states, {k: jnp.asarray(v)
                                           for k, v in ids.items()}, grads)
    path = str(tmp_path_factory.mktemp("pooled") / "ck")
    jckpt.save_checkpoint(path, coll, states, model_sign=SIGN)
    jreg = JaxRegistry(mesh)
    jreg.create_model(path)
    jsrv = JaxServer(jreg, port=0).start()
    tsrv = ControllerServer(port=0, device="cpu").start()
    status, body = _req(tsrv, "/models",
                        json.dumps({"model_uri": path, "block": True}))
    assert status == 201
    yield {"ids": ids, "jreg": jreg, "jsrv": jsrv, "tsrv": tsrv}
    tsrv.stop()
    jsrv.stop()


@pytest.mark.parametrize("variable,case", [
    ("hist", "sequence"), ("hist:linear", "sequence"), ("hist", "flat"),
    ("hist", "flat_i64"), ("whist", "sequence"), ("whist", "pairs_flat"),
    ("whist", "narrow_sequence"), ("whist", "narrow_two")])
def test_pooled_lookup_bin_matches_jax(pooled_served, variable, case):
    """``lookup_bin`` bodies byte for byte against the JAX server's: a
    sequence query on a pooled variable returns pooled ``[B, dim]`` rows,
    a flat one a row per id, and on a wide variable a trailing 2 is a pair
    axis (``[B, 2]`` reads as B pairs)."""
    ids = pooled_served["ids"][variable]
    rng = np.random.RandomState(11)
    query = {"sequence": ids,
             "flat": ids.reshape(-1),
             "flat_i64": ids.reshape(-1).astype(np.int64),
             "pairs_flat": ids.reshape(-1, 2),
             "narrow_sequence": rng.randint(0, 2 * VOCAB, (B, 3)).astype(
                 np.int32),
             "narrow_two": rng.randint(0, 2 * VOCAB, (B, 2)).astype(
                 np.int32)}[case]
    path = f"/models/{SIGN}/lookup_bin"
    ts, tbody = _req(pooled_served["tsrv"], path, _bin_body(variable, query))
    js, jbody = _req(pooled_served["jsrv"], path, _bin_body(variable, query))
    assert ts == js == 200
    assert tbody == jbody
    head = json.loads(tbody[:tbody.index(b"\n")])
    lead = {"sequence": (B,), "narrow_sequence": (B,), "flat": (B * L,),
            "flat_i64": (B * L,), "pairs_flat": (B * L,),
            "narrow_two": (B,)}[case]
    assert tuple(head["shape"][:-1]) == lead


@pytest.mark.parametrize("kind", ["int32_hash", "wide"])
def test_padding_is_inert_in_the_hash_pull_and_push(monkeypatch, kind):
    """Padding keys (EMPTY) get zero rows in the pull, the init-rows
    kernel draws no row for them (they are among its skipped keys, in the
    pull and in the push), and the push stores none of them."""
    from openembedding_tpu_torch import hash_table as th
    spec = EmbeddingSpec(name="seq", output_dim=DIM, pooling="sum",
                         optimizer=OPT, **_spec_kwargs(kind))
    coll = EmbeddingCollection([spec], device="cpu")
    states = coll.init()
    ids = _seq_ids(kind, seed=12)
    drawn = []
    kernel = th._init_rows_kernel

    def recording(out, keys, skip, *args):
        drawn.append(keys[~skip].clone())
        return kernel(out, keys, skip, *args)
    monkeypatch.setattr(th, "_init_rows_kernel", recording)
    x = coll.to_device("seq", ids)
    raw = th.pull(states["seq"], x, coll.initializer("seq"))
    pad = (x[..., 1] if kind == "wide" else x) == EMPTY
    assert pad.any() and not raw[pad].any() and raw[~pad].abs().sum() > 0
    coll.apply_gradients(states, {"seq": ids},
                         {"seq": torch.ones(B, DIM)})
    assert len(drawn) == 2             # the pull's draw and the push's
    for keys in drawn:
        words = keys[:, 1] if kind == "wide" else keys
        assert not (words == EMPTY).any()
    stored = states["seq"].keys
    live = (stored[:, 1] if kind == "wide" else stored) != EMPTY
    assert int(live.sum()) == len(np.unique(x[~pad].numpy(), axis=0))
