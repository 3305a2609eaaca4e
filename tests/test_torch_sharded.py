"""Torch port, tables sharded over a one-process mesh against the JAX
package's sharded tables on the 8-device CPU mesh.

The same numpy-seeded ids and gradients go through JAX's collection on a
``(data, model)`` mesh of CPU devices and the port's collection on a mesh
of the same shape whose positions all name the CPU
(``parallel/mesh.py``). Both layouts (``mod``, ``div``), both planes
(``a2a``, ``psum``), 1x4, 2x2 and 2x4 meshes; array tables and hash
tables with wide pair keys and int32 keys (int64 keys:
``test_torch_x64.py``).

Tolerances: the initial state (nothing copied: each shard draws from
``fold_in(key, shard)``), pulled rows, SGD-updated tables and hash keys
slot for slot are EXACT; Adagrad tables agree at rtol 1e-5 (the
one-device Adagrad update already differs from XLA's in the last bit).
Trainer trajectories, checkpoints across topologies and ``fit`` on a
mesh: ``test_torch_sharded_training.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel import sharded_hash, sharded_table
from openembedding_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                   Mesh, create_mesh,
                                                   single_device_mesh)

SGD = {"category": "sgd", "learning_rate": 0.5}
ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}
MESHES = [(1, 4), (2, 2), (2, 4)]
VOCAB, DIM, BATCH = 1000, 4, 16


def _pair(kw, devices, d, m, seed=0):
    """JAX's and the port's collections of one spec on a d x m mesh."""
    jcoll = oe.EmbeddingCollection([oe.EmbeddingSpec(**kw)],
                                   jax_mesh(d, m, devices[:d * m]))
    tcoll = EmbeddingCollection([EmbeddingSpec(**kw)],
                                create_mesh(d, m, device="cpu"), seed=seed)
    return jcoll, tcoll


def _steps(jcoll, tcoll, jstates, tstates, ids_fn, steps=3, exact=True,
           batch_sharded=True):
    """``steps`` pulls and pushes of the same ids and gradients through
    both collections; rows and tables compared after each."""
    rng = np.random.default_rng(7)
    name = next(iter(tcoll.specs))
    for _ in range(steps):
        ids = ids_fn(rng)
        g = rng.standard_normal(ids.shape[:2] + (DIM,)).astype(np.float32)
        want = np.asarray(jcoll.pull(jstates, {name: ids},
                                     batch_sharded=batch_sharded)[name])
        got = tcoll.pull(tstates, {name: ids},
                         batch_sharded=batch_sharded)[name].numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        jstates = jcoll.apply_gradients(jstates, {name: ids},
                                        {name: jnp.asarray(g)},
                                        batch_sharded=batch_sharded)
        tcoll.apply_gradients(tstates, {name: ids},
                              {name: torch.from_numpy(g)},
                              batch_sharded=batch_sharded)
        jw = np.asarray(jstates[name].weights)
        tw = tstates[name].weights.numpy()
        if exact:
            np.testing.assert_array_equal(tw, jw)
        else:
            np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-7)
        for k, v in jstates[name].slots.items():
            np.testing.assert_allclose(tstates[name].slots[k].numpy(),
                                       np.asarray(v), rtol=1e-5)
        if hasattr(jstates[name], "keys"):
            np.testing.assert_array_equal(tstates[name].keys.numpy(),
                                          np.asarray(jstates[name].keys))
    return jstates


def _array_ids(rng):
    # a few out-of-range and negative ids: zero rows, dropped pushes
    ids = rng.integers(-3, VOCAB + 5, size=(BATCH, 3)).astype(np.int32)
    return ids


def _hash_ids(kind):
    def ids(rng):
        keys = rng.integers(0, 400, size=(BATCH, 3)).astype(np.int64) * 7919
        if kind == "wide":
            keys = keys + (np.int64(1) << 40)
            return keys      # host int64 ids: split into pairs
        return keys.astype(np.int32)
    return ids


def test_mesh_is_row_major_over_one_device():
    mesh = create_mesh(2, 4, device="cpu")
    assert mesh.shape == {DATA_AXIS: 2, MODEL_AXIS: 4}
    assert mesh.size == 8 and mesh.device == torch.device("cpu")
    assert mesh.dims == (2, 4)
    assert single_device_mesh("cpu").shape == {DATA_AXIS: 1, MODEL_AXIS: 1}
    assert create_mesh(2, devices=["cpu"] * 6).dims == (2, 3)
    with pytest.raises(ValueError, match="not divisible"):
        create_mesh(4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="!="):
        Mesh(["cpu"] * 3, 2, 2)
    # several cards take one process each (distributed.py)
    with pytest.raises(ValueError, match="distributed.create_global_mesh"):
        Mesh(["cpu", "meta"], 1, 2)
    # a device means its 1 x 1 mesh; a mesh and a device conflict
    coll = EmbeddingCollection([EmbeddingSpec("a", 8, 2)], device="cpu")
    assert coll.mesh.dims == (1, 1) and not coll.sharded("a")
    with pytest.raises(ValueError, match="not both"):
        EmbeddingCollection([EmbeddingSpec("a", 8, 2)], mesh, device="cpu")


@pytest.mark.parametrize("plane", ["a2a", "psum"])
@pytest.mark.parametrize("layout", ["mod", "div"])
@pytest.mark.parametrize("dm", MESHES, ids=lambda x: f"{x[0]}x{x[1]}")
def test_array_tables_match_jax(devices8, plane, layout, dm):
    """Init with nothing copied, then pulls and SGD pushes bit for bit."""
    kw = dict(name="t", input_dim=VOCAB, output_dim=DIM, plane=plane,
              layout=layout, optimizer=SGD)
    jcoll, tcoll = _pair(kw, devices8, *dm, seed=3)
    jstates = jcoll.init(jax.random.PRNGKey(3))
    tstates = tcoll.init()
    sspec = tcoll.sharding_spec("t")
    want = dm[0] * dm[1] if plane == "a2a" else dm[1]
    assert sspec.num_shards == jcoll.sharding_spec("t").num_shards == want
    assert sspec.rows_per_shard == jcoll.sharding_spec("t").rows_per_shard
    assert isinstance(tstates["t"], sharded_table.ShardedTableState)
    np.testing.assert_array_equal(tstates["t"].weights.numpy(),
                                  np.asarray(jstates["t"].weights))
    _steps(jcoll, tcoll, jstates, tstates, _array_ids)


@pytest.mark.parametrize("plane", ["a2a", "psum"])
@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("dm", MESHES[:2], ids=lambda x: f"{x[0]}x{x[1]}")
def test_hash_tables_match_jax(devices8, plane, key_dtype, dm):
    """Hash shards: keys slot for slot, init rows of missed keys, pulls
    and SGD pushes bit for bit."""
    kw = dict(name="h", input_dim=-1, output_dim=DIM, plane=plane,
              key_dtype=key_dtype, hash_capacity=4096, optimizer=SGD)
    jcoll, tcoll = _pair(kw, devices8, *dm, seed=5)
    jstates = jcoll.init(jax.random.PRNGKey(5))
    tstates = tcoll.init()
    sspec = tcoll.sharding_spec("h")
    assert sspec.capacity_per_shard \
        == jcoll.sharding_spec("h").capacity_per_shard
    assert tstates["h"].init_rng == tuple(
        np.asarray(jstates["h"].init_rng).tolist())
    jstates = _steps(jcoll, tcoll, jstates, tstates, _hash_ids(key_dtype))
    assert tstates["h"].num_used() == int(jstates["h"].num_used())


@pytest.mark.parametrize("kind", ["array", "hash"])
def test_adagrad_and_replicated_batch(devices8, kind):
    """Adagrad pushes at rtol 1e-5, and a replicated batch
    (``batch_sharded=False``: every sender takes a slice of the whole
    batch) gives JAX's rows."""
    kw = dict(name="t", input_dim=VOCAB if kind == "array" else -1,
              output_dim=DIM, optimizer=ADAGRAD, hash_capacity=4096)
    jcoll, tcoll = _pair(kw, devices8, 2, 2)
    _steps(jcoll, tcoll, jcoll.init(jax.random.PRNGKey(0)), tcoll.init(),
           _array_ids if kind == "array" else _hash_ids("int32"),
           exact=False, batch_sharded=False)


def test_insert_failures_per_shard(devices8):
    """A hash shard that fills up drops inserts where JAX's does; the
    port keeps a count a shard, JAX their total."""
    kw = dict(name="h", input_dim=-1, output_dim=DIM, key_dtype="int32",
              hash_capacity=256, optimizer=SGD)
    jcoll, tcoll = _pair(kw, devices8, 2, 2)
    jstates = jcoll.init(jax.random.PRNGKey(1))
    tstates = tcoll.init(ti.prng_key(1))
    # 64-slot shards; owner 0 gets 160 distinct keys, the others few
    keys = np.concatenate([np.arange(160) * 4,
                           np.arange(8) * 4 + 1]).astype(np.int32)
    keys = keys.reshape(-1, 1)
    g = np.ones(keys.shape + (DIM,), np.float32)
    jstates = jcoll.apply_gradients(jstates, {"h": keys},
                                    {"h": jnp.asarray(g)})
    tcoll.apply_gradients(tstates, {"h": keys}, {"h": torch.from_numpy(g)})
    fails = tstates["h"].shard_failures.tolist()
    assert fails[0] == 160 - 64 and sum(fails[1:]) == 0
    assert int(tstates["h"].insert_failures) \
        == int(jstates["h"].insert_failures) == 96
    np.testing.assert_array_equal(tstates["h"].keys.numpy(),
                                  np.asarray(jstates["h"].keys))
    np.testing.assert_array_equal(tstates["h"].weights.numpy(),
                                  np.asarray(jstates["h"].weights))


def test_interop_and_refusals(devices8):
    """JAX's global physical arrays become the port's stacked shards and
    back; dirty tracking arms on a sharded variable and marks its
    logical rows, as JAX's does; the later planes build, their specs
    JAX's."""
    kw = dict(name="t", input_dim=VOCAB, output_dim=DIM, optimizer=ADAGRAD)
    jcoll, tcoll = _pair(kw, devices8, 2, 2)
    js = jcoll.init(jax.random.PRNGKey(4))["t"]
    st = interop.sharded_table_state_from_numpy(
        np.asarray(js.weights), {k: np.asarray(v)
                                 for k, v in js.slots.items()}, 4, "cpu")
    w, slots = interop.table_state_to_numpy(st)
    np.testing.assert_array_equal(w, np.asarray(js.weights))
    ids = np.arange(40, dtype=np.int32).reshape(10, 4)
    np.testing.assert_array_equal(
        tcoll.pull({"t": st}, {"t": ids})["t"].numpy(),
        np.asarray(jcoll.pull({"t": js}, {"t": ids})["t"]))
    hk = dict(name="h", input_dim=-1, output_dim=DIM, hash_capacity=1024)
    jh, th_ = _pair(hk, devices8, 1, 4)
    jhs = jh.init(jax.random.PRNGKey(0))["h"]
    hs = interop.sharded_hash_state_from_numpy(
        np.asarray(jhs.keys), np.asarray(jhs.weights), {}, 4, "cpu",
        init_rng=np.asarray(jhs.init_rng), insert_failures=3)
    assert hs.shard_failures.tolist() == [3, 0, 0, 0]
    assert isinstance(hs, sharded_hash.ShardedHashState)
    tcoll.enable_dirty_tracking(target_chunks=8)
    jcoll.enable_dirty_tracking(target_chunks=8)
    tcoll.mark_dirty({"t": ids})
    jcoll.mark_dirty({"t": ids})
    assert list(tcoll.dirty_trackers["t"].dirty_chunks()) == \
        list(jcoll.dirty_trackers["t"].dirty_chunks()) != []
    for plane in ("a2a+grouped", "a2a+pipelined", "a2a+bf16"):
        t, j = EmbeddingSpec("x", 8, 2, plane=plane), \
            oe.EmbeddingSpec("x", 8, 2, plane=plane)
        assert (t.plane, t.exchange_precision, t.push_precision) \
            == (j.plane, j.exchange_precision, j.push_precision)
    with pytest.raises(ValueError, match="unknown plane"):
        EmbeddingSpec("x", 8, 2, plane="ring")
    with pytest.raises(ValueError, match="num_shards=3"):
        EmbeddingCollection([EmbeddingSpec("x", 8, 2, num_shards=3)],
                            create_mesh(2, 2, device="cpu"))
    assert tcoll.state_shardings()["t"]["weights"] == (DATA_AXIS,
                                                        MODEL_AXIS)


def test_deliver_filled_and_packed_insert_match_jax(devices8):
    """The loader's row delivery at physical positions onto a filled
    canvas, and the offload tier's packed insert, equal JAX's."""
    from openembedding_tpu.parallel import sharded_hash as jsh
    from openembedding_tpu.parallel import sharded_table as jst
    jm = jax_mesh(2, 2, devices8[:4])
    tm_ = create_mesh(2, 2, device="cpu")
    meta = oe.EmbeddingVariableMeta(embedding_dim=3, vocabulary_size=50)
    jspec = jst.make_sharding_spec(meta, jm)
    from openembedding_tpu_torch.meta import EmbeddingVariableMeta
    tspec = sharded_table.make_sharding_spec(
        EmbeddingVariableMeta(embedding_dim=3, vocabulary_size=50), tm_)
    assert (tspec.num_shards, tspec.rows_per_shard) \
        == (jspec.num_shards, jspec.rows_per_shard)
    jarr = jst.filled_sharded(jm, jspec, (3,), 0.25, np.float32)
    tarr = sharded_table.filled_sharded(tm_, tspec, (3,), 0.25,
                                        torch.float32)
    phys = np.array([0, 13, 49, -1, 51, 7], np.int32)
    rows = np.arange(18, dtype=np.float32).reshape(6, 3)
    jarr = jst.deliver_rows_sharded(jarr, jnp.asarray(phys),
                                    jnp.asarray(rows), mesh=jm, spec=jspec)
    sharded_table.deliver_rows_sharded(tarr, torch.from_numpy(phys),
                                       torch.from_numpy(rows), mesh=tm_,
                                       spec=tspec)
    np.testing.assert_array_equal(tarr.numpy(), np.asarray(jarr))
    # packed insert: int32 keys' bits in column 0, the row, a slot's row
    hmeta = oe.EmbeddingVariableMeta(embedding_dim=2, vocabulary_size=2**63)
    jhs = jsh.make_hash_sharding_spec(jm, 512)
    ths = sharded_hash.make_hash_sharding_spec(tm_, 512)
    opt = {"category": "adagrad", "learning_rate": 0.1}
    jstate = jsh.create_sharded_hash_table(hmeta, opt, mesh=jm, spec=jhs,
                                           wrap_cache=False)
    tstate = sharded_hash.create_sharded_hash_table(
        EmbeddingVariableMeta(embedding_dim=2, vocabulary_size=2**63), opt,
        mesh=tm_, spec=ths)
    keys = np.array([5, 6, 1000, -7, 2**30], np.int32)
    packed = np.zeros((5, 4), np.float32)
    packed[:, 0] = keys.view(np.float32)
    packed[:, 1:3] = np.arange(10, dtype=np.float32).reshape(5, 2)
    packed[:, 3] = 0.5
    layout = (("accum", 3, 1, (1,)),)
    jstate = jsh.insert_rows_sharded_packed(jstate, jnp.asarray(packed),
                                            layout, mesh=jm, spec=jhs)
    sharded_hash.insert_rows_sharded_packed(
        tstate, torch.from_numpy(packed), layout, mesh=tm_, spec=ths)
    np.testing.assert_array_equal(tstate.keys.numpy(),
                                  np.asarray(jstate.keys))
    np.testing.assert_array_equal(tstate.weights.numpy(),
                                  np.asarray(jstate.weights))
    np.testing.assert_array_equal(tstate.slots["accum"].numpy(),
                                  np.asarray(jstate.slots["accum"]))
