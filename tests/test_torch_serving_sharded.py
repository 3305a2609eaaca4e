"""Torch port, shard-group serving (``serving/ha.py``
``ShardedRoutingClient``, ``registry.create_model(shard_index=,
shard_count=)``) with port daemons on the CPU, against the JAX package's
registry on the same checkpoints (``tests/test_serving_sharded.py``'s
cases).

Each of G serving processes loads the slice ids or keys ≡ k (mod G) of a
JAX dump (``checkpoint.load_checkpoint(shard_slice=)``); the router
partitions a lookup by owner (the joined 64-bit value of a wide pair)
and merges the rows by position. Every row equals JAX's registry row
exactly: the wide-key model on 3 groups, the 2 x 2 grid of groups and
replicas through a replica kill, and a pooled wide spec's slices in
process; in process too, slices of a delta chain's base taking the next
delta, and a registry over a one-process mesh of two shards.
"""

import shutil
import signal
import socket
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openembedding_tpu import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu import checkpoint as ckpt
from openembedding_tpu import hash_table as jhl
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu_torch import hash_table as thl
from openembedding_tpu_torch.serving import ha
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.serving.rest import probe_health

DIM, VOCAB = 4, 64
SIGN, WSIGN = "sharded-model-1", "sharded-wide-1"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_rows(path, sign, name, ids, shard=None):
    """JAX's registry rows of ``ids`` on the dump at ``path`` (a shard
    slice ``(k, G)`` when given)."""
    reg = JaxRegistry(create_mesh(1, 1, jax.devices()[:1]),
                      default_hash_capacity=512)
    k, g = shard or (0, 1)
    reg.create_model(path, model_sign=sign, shard_index=k, shard_count=g)
    return np.asarray(reg.find_model(sign).lookup(name, ids))


@pytest.fixture(scope="module")
def sharded_model(tmp_path_factory):
    """A JAX dump of an array variable and an int32 hash variable with
    rows distinguishable by id; JAX's registry rows of every id."""
    path = str(tmp_path_factory.mktemp("sharded") / "model")
    mesh = create_mesh(1, 1, jax.devices()[:1])
    specs = (
        EmbeddingSpec(name="emb", input_dim=VOCAB, output_dim=DIM,
                      initializer={"category": "normal", "stddev": 1.0}),
        EmbeddingSpec(name="hsh", input_dim=-1, output_dim=DIM,
                      hash_capacity=512,
                      initializer={"category": "constant", "value": 0.0},
                      optimizer={"category": "sgd", "learning_rate": 1.0}))
    coll = EmbeddingCollection(specs, mesh)
    states = coll.init(jax.random.PRNGKey(3))
    hkeys = jnp.asarray(np.arange(1, 41, dtype=np.int32))
    rows = coll.pull(states, {"hsh": hkeys}, batch_sharded=False)
    g = jnp.broadcast_to((np.arange(1, 41, dtype=np.float32) / 100.0)
                         [:, None], rows["hsh"].shape)
    states = coll.apply_gradients(states, {"hsh": hkeys}, {"hsh": g},
                                  batch_sharded=False)
    ckpt.save_checkpoint(path, coll, states, model_sign=SIGN)
    want_emb = _jax_rows(path, SIGN, "emb", np.arange(VOCAB))
    want_hsh = _jax_rows(path, SIGN, "hsh", np.arange(1, 41))
    return path, want_emb, want_hsh


@pytest.fixture(scope="module")
def wide_sharded_model(tmp_path_factory):
    """A JAX dump of a wide-key hash variable, keys near 2^62 of which
    some differ only in the hi word (with G = 3 the owner depends on both
    words, 2^32 % 3 == 1); the keys and JAX's registry rows."""
    path = str(tmp_path_factory.mktemp("wsharded") / "model")
    mesh = create_mesh(1, 1, jax.devices()[:1])
    spec = EmbeddingSpec(name="wh", input_dim=-1, output_dim=DIM,
                         hash_capacity=512, key_dtype="wide",
                         initializer={"category": "constant", "value": 0.0},
                         optimizer={"category": "sgd", "learning_rate": 1.0})
    coll = EmbeddingCollection((spec,), mesh)
    states = coll.init(jax.random.PRNGKey(7))
    keys64 = np.concatenate([
        (3 << 60) + np.arange(1, 21, dtype=np.int64),
        (3 << 60) + (np.arange(1, 21, dtype=np.int64) << 32)])
    pairs = jnp.asarray(jhl.split64(keys64))
    rows = coll.pull(states, {"wh": pairs}, batch_sharded=False)
    g = jnp.broadcast_to((np.arange(1, 41, dtype=np.float32) / 100.0)
                         [:, None], rows["wh"].shape)
    states = coll.apply_gradients(states, {"wh": pairs}, {"wh": g},
                                  batch_sharded=False)
    ckpt.save_checkpoint(path, coll, states, model_sign=WSIGN)
    want = _jax_rows(path, WSIGN, "wh", jhl.split64(keys64))
    return path, keys64, want


def _cleanup(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.wait()


def _tail(proc, n=20):
    out = proc.stdout.read() if proc.poll() is not None else ""
    return "\n".join((out or "").splitlines()[-n:])


def _lookup_retry(fn, deadline_s=60.0):
    deadline = time.time() + deadline_s
    while True:
        try:
            return fn()
        except ConnectionError as e:
            if "timed out" not in str(e) or time.time() >= deadline:
                raise
            time.sleep(0.5)


def _policy():
    return ha.RetryPolicy(deadline_s=5.0)


def test_wide_key_shard_groups(wide_sharded_model):
    """G = 3 port daemons each load the slice ``join64(pair) % 3 == k``
    of a wide-key dump; the router partitions pair queries by the same
    rule and merges: JAX's rows exactly, batch shapes kept. A group
    answers zero rows for pairs it does not own; a dead group's keys
    fail (an outage, not silent zeros) while the others serve."""
    path, keys64, want = wide_sharded_model
    g = 3
    eps = [f"127.0.0.1:{_free_port()}" for _ in range(g)]
    procs = {}
    try:
        for k in range(g):
            procs[k] = ha.spawn_replica(
                int(eps[k].rsplit(":", 1)[1]), load=[f"{WSIGN}={path}"],
                device="cpu", shard_index=k, shard_count=g)
        for k in range(g):
            assert ha.wait_ready(eps[k], sign=WSIGN, timeout=120.0), \
                _tail(procs[k])
        router = ha.ShardedRoutingClient([[e] for e in eps], timeout=15.0,
                                         policy=_policy())
        pairs = thl.split64(keys64)
        got = _lookup_retry(
            lambda: router.lookup(WSIGN, "wh", pairs, wide=True))
        np.testing.assert_array_equal(got, want)
        got2 = _lookup_retry(lambda: router.lookup(
            WSIGN, "wh", pairs.reshape(8, 5, 2), wide=True))
        np.testing.assert_array_equal(got2, want.reshape(8, 5, DIM))
        owners = keys64 % g
        assert set(owners.tolist()) == set(range(g))
        for k in range(g):
            solo = ha.RoutingClient([eps[k]], timeout=15.0)
            other = np.nonzero(owners != k)[0][0]
            np.testing.assert_array_equal(
                _lookup_retry(lambda: solo.lookup(WSIGN, "wh",
                                                  pairs[[other]])), 0.0)
            mine = np.nonzero(owners == k)[0][0]
            np.testing.assert_array_equal(
                _lookup_retry(lambda: solo.lookup(WSIGN, "wh",
                                                  pairs[[mine]])),
                want[[mine]])
            solo.close()
        procs[0].send_signal(signal.SIGKILL)
        procs[0].wait()
        dead = np.nonzero(owners == 0)[0]
        live = np.nonzero(owners != 0)[0]
        with pytest.raises(ConnectionError):
            router.lookup(WSIGN, "wh", pairs[dead[:1]], wide=True)
        np.testing.assert_array_equal(
            _lookup_retry(lambda: router.lookup(WSIGN, "wh", pairs[live],
                                                wide=True)), want[live])
        router.close()
    finally:
        _cleanup(procs)


def test_shard_groups_with_replicas(sharded_model):
    """A 2 x 2 grid (2 groups of 2 replicas): the router's rows of every
    array id and hash key equal JAX's exactly; a process holds only its
    slice; /health reports the geometry; one replica of group 0 killed,
    lookups go on without one failure; its last replica killed, group
    0's ids fail while group 1's serve. A replica restored from a peer of
    its group rebuilds the same slice."""
    path, want_emb, want_hsh = sharded_model
    g, r = 2, 2
    eps = [[f"127.0.0.1:{_free_port()}" for _ in range(r)] for _ in range(g)]
    procs = {}
    try:
        for k in range(g):
            for i in range(r):
                procs[(k, i)] = ha.spawn_replica(
                    int(eps[k][i].rsplit(":", 1)[1]),
                    load=[f"{SIGN}={path}"], device="cpu", shard_index=k,
                    shard_count=g)
        for k in range(g):
            for i in range(r):
                assert ha.wait_ready(eps[k][i], sign=SIGN, timeout=120.0), \
                    _tail(procs[(k, i)])
        router = ha.ShardedRoutingClient(eps, timeout=15.0,
                                         policy=_policy())
        np.testing.assert_array_equal(
            _lookup_retry(lambda: router.lookup(SIGN, "emb",
                                                np.arange(VOCAB))),
            want_emb)
        np.testing.assert_array_equal(
            _lookup_retry(lambda: router.lookup(
                SIGN, "hsh", np.arange(1, 41, dtype=np.int32))), want_hsh)
        solo = ha.RoutingClient([eps[1][0]], timeout=15.0)
        np.testing.assert_array_equal(
            _lookup_retry(lambda: solo.lookup(SIGN, "emb", [2])), 0.0)
        solo.close()
        h = probe_health(eps[1][0], timeout=10.0)
        m = [x for x in h["models"] if x["model_sign"] == SIGN][0]
        assert (m["shard_index"], m["shard_count"]) == (1, g)
        # a dump-less peer restore inside group 1 keeps the slice
        reg = ModelRegistry(device="cpu")
        ha.restore_model_from_peer(reg, eps[1][1], SIGN)
        model = reg.find_model(SIGN)
        assert model.shard_slice == (1, g)
        ids = np.arange(VOCAB)
        got = model.lookup("emb", ids).numpy()
        np.testing.assert_array_equal(got[ids % 2 == 1],
                                      want_emb[ids % 2 == 1])
        np.testing.assert_array_equal(got[ids % 2 == 0], 0.0)
        procs[(0, 0)].send_signal(signal.SIGKILL)
        procs[(0, 0)].wait()
        for _ in range(3):
            np.testing.assert_array_equal(
                router.lookup(SIGN, "emb", np.arange(VOCAB)), want_emb)
        procs[(0, 1)].send_signal(signal.SIGKILL)
        procs[(0, 1)].wait()
        with pytest.raises(ConnectionError):
            router.lookup(SIGN, "emb", np.asarray([0]))
        np.testing.assert_array_equal(
            router.lookup(SIGN, "emb", np.asarray([1, 3])),
            want_emb[[1, 3]])
        router.close()
    finally:
        _cleanup(procs)


def test_pooled_wide_spec_serves_rows(tmp_path_factory):
    """A pooled wide spec serves with row semantics: flat ``[n, 2]`` pair
    queries give one row a pair, unpooled, and a shard slice (G = 3) its
    own pairs' rows and zeros elsewhere, the slices adding up to the
    whole; sequence-shaped ``[B, L, 2]`` queries pool. Every row equals
    JAX's registry's exactly."""
    path = str(tmp_path_factory.mktemp("pooledwide") / "model")
    mesh = create_mesh(1, 1, jax.devices()[:1])
    psign = "pooled-wide-1"
    spec = EmbeddingSpec(
        name="seq", input_dim=-1, output_dim=DIM, hash_capacity=512,
        key_dtype="wide", pooling="mean",
        initializer={"category": "normal", "stddev": 1.0},
        optimizer={"category": "sgd", "learning_rate": 1.0})
    coll = EmbeddingCollection((spec,), mesh)
    states = coll.init(jax.random.PRNGKey(11))
    keys64 = np.concatenate([
        (3 << 60) + np.arange(1, 13, dtype=np.int64),
        (3 << 60) + (np.arange(1, 13, dtype=np.int64) << 32)])
    seq = jnp.asarray(jhl.split64(keys64).reshape(4, 6, 2))
    g = jnp.asarray(np.arange(1, 4 * DIM + 1, dtype=np.float32)
                    .reshape(4, DIM))
    states = coll.apply_gradients(states, {"seq": seq}, {"seq": g},
                                  batch_sharded=False)
    ckpt.save_checkpoint(path, coll, states, model_sign=psign)
    pairs = thl.split64(keys64)
    want = _jax_rows(path, psign, "seq", pairs)
    assert float(np.abs(want).max()) > 0
    reg = ModelRegistry(device="cpu", default_hash_capacity=512)
    reg.create_model(path, model_sign=psign)
    got = reg.find_model(psign).lookup("seq", pairs).numpy()
    assert got.shape == (len(keys64), DIM)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        reg.find_model(psign).lookup("seq", pairs.reshape(4, 6, 2)).numpy(),
        _jax_rows(path, psign, "seq", pairs.reshape(4, 6, 2)))
    shards = 3
    owners = keys64 % shards
    total = np.zeros_like(want)
    for k in range(shards):
        regk = ModelRegistry(device="cpu", default_hash_capacity=512)
        regk.create_model(path, model_sign=psign, shard_index=k,
                          shard_count=shards)
        gotk = regk.find_model(psign).lookup("seq", pairs).numpy()
        np.testing.assert_array_equal(
            gotk, _jax_rows(path, psign, "seq", pairs, (k, shards)))
        np.testing.assert_array_equal(gotk[owners == k], want[owners == k])
        np.testing.assert_array_equal(gotk[owners != k], 0.0)
        total += gotk
    np.testing.assert_array_equal(total, want)


def test_slices_take_their_deltas_and_num_shards(tmp_path):
    """A delta chain's base and its next delta served by shard slices
    (G = 2): each slice's rows equal JAX's registry slice on the same
    chain, before and after ``apply_delta`` (the slice keeps the rows it
    owns, array ids at ``id // G``); the two slices add up to the whole
    model; ``export_rows`` pages global ids; a registry over a 1 x 2 mesh
    (``num_shards=2``) serves the same rows as one shard."""
    import torch
    from openembedding_tpu import checkpoint_delta as jcd
    from openembedding_tpu_torch import checkpoint as tck
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.embedding import (EmbeddingCollection as TC,
                                                   EmbeddingSpec as TS)
    adagrad = {"category": "adagrad", "learning_rate": 0.1}
    coll = TC((TS(name="arr", input_dim=VOCAB, output_dim=DIM),
               TS(name="hsh", input_dim=-1, output_dim=DIM,
                  hash_capacity=1024)), device="cpu",
              default_optimizer=adagrad)
    coll.enable_dirty_tracking(target_chunks=8)
    states = coll.init()
    rng = np.random.RandomState(5)

    def train():
        idx = {"arr": rng.randint(0, VOCAB, 16).astype(np.int32),
               "hsh": rng.randint(0, 2**20, 16).astype(np.int32)}
        rows = coll.pull(states, idx)
        coll.apply_gradients(states, idx, {k: torch.ones_like(v) * 0.2
                                           for k, v in rows.items()})
        return idx
    seen = [train()]
    path = str(tmp_path / "m")
    tck.save_checkpoint(path, coll, states, mode="delta", step=1)
    v0 = str(tmp_path / "v0")      # the base alone, before the delta
    shutil.copytree(path, v0)
    seen.append(train())
    delta = cd.save_delta(path, coll, states, step=2,
                          compact_bytes_ratio=1e9, background_compact=False,
                          return_payload=True)["delta"]
    base = str(tmp_path / "base")
    tck.save_checkpoint(base, coll, states)   # the model after the delta
    probe = {"arr": np.arange(VOCAB),
             "hsh": np.concatenate([s["hsh"] for s in seen])}
    full = ModelRegistry(device="cpu")
    full.create_model(base, model_sign="full")
    want = {n: full.find_model("full").lookup(n, ids).numpy()
            for n, ids in probe.items()}
    g = 2
    total = {n: np.zeros_like(w) for n, w in want.items()}
    jmesh = create_mesh(1, 1, jax.devices()[:1])
    for k in range(g):
        reg = ModelRegistry(device="cpu")
        reg.create_model(v0, model_sign="s", shard_index=k, shard_count=g)
        jreg = JaxRegistry(jmesh)
        jreg.create_model(v0, model_sign="s", shard_index=k, shard_count=g)
        for n, ids in probe.items():
            np.testing.assert_array_equal(
                reg.find_model("s").lookup(n, ids).numpy(),
                np.asarray(jreg.find_model("s").lookup(n, ids)))
        wire = cd.encode_delta(delta)
        assert reg.apply_delta("s", wire)["applied"]
        assert jreg.apply_delta("s", jcd.decode_delta(wire))["applied"]
        model = reg.find_model("s")
        for n, ids in probe.items():
            got = model.lookup(n, ids).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jreg.find_model("s").lookup(n, ids)))
            owned = (ids.astype(np.int64) % g) == k
            np.testing.assert_array_equal(got[owned], want[n][owned])
            np.testing.assert_array_equal(got[~owned], 0.0)
            total[n] += got
        ids, rows, n_rows = model.export_rows("arr", 0, 1 << 20)
        assert n_rows == -(-(VOCAB - k) // g)
        np.testing.assert_array_equal(ids, np.arange(k, VOCAB, g))
        np.testing.assert_array_equal(rows.numpy(), want["arr"][ids])
    for n in want:
        np.testing.assert_array_equal(total[n], want[n])
    two = ModelRegistry(device="cpu")
    two.create_model(base, model_sign="two", num_shards=2)
    assert two.find_model("two").collection.mesh.dims == (1, 2)
    for n, ids in probe.items():
        np.testing.assert_array_equal(
            two.find_model("two").lookup(n, ids).numpy(), want[n])
