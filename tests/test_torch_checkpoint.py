"""Torch port, checkpoints in both directions against the JAX package.

A JAX ``save_checkpoint`` (the 8-device CPU mesh, adagrad, optimizer
state included) loads bit-equal into the port; a port save loads
bit-equal through JAX ``load_checkpoint`` with the same model_meta keys.
Hash variables compare per key -> row (a load inserts, so the slots a key
lands in depend on the table's layout), and a port dump of a state copied
from a one-device JAX table is byte-identical to JAX's own dump.
Checkpoints are copies: every comparison is exact, bf16 included.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu import hash_table as jh
from openembedding_tpu.parallel import hot_cache
from openembedding_tpu.parallel import sharded_hash as jsh
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec

ADAGRAD = {"category": "adagrad", "learning_rate": 0.05}
# (name, vocab, dim, dtype): dim 9 + dim 1 like the fused headline, and bf16
VARS = [("fields", 37, 9, "float32"), ("fields:linear", 37, 1, "float32"),
        ("emb_bf16", 21, 8, "bfloat16")]


def _jax_coll(mesh, optimizer=ADAGRAD):
    return oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                          initializer={"category": "normal"})
         for n, v, d, t in VARS], mesh, default_optimizer=optimizer)


def _port_coll(optimizer=ADAGRAD, device="cpu"):
    return EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                       initializer={"category": "normal"})
         for n, v, d, t in VARS], device=device, default_optimizer=optimizer)


def _jax_numpy(coll, states, name, vocab):
    """A JAX variable's weights and slots in LOGICAL row order (the
    sharded state holds them in the mesh's physical mod layout)."""
    state = hot_cache.unwrap(states[name])
    perm = jax_ckpt._logical_perm(coll.sharding_spec(name))[:vocab]
    return (np.asarray(state.weights)[perm],
            {k: np.asarray(v)[perm] for k, v in state.slots.items()})


def _bits(a):
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.fixture()
def jax_trained(devices8):
    """A JAX collection on the 2x4 mesh, one adagrad step taken so the
    accum slots differ from their init."""
    mesh = create_mesh(2, 4, devices8)
    coll = _jax_coll(mesh)
    states = coll.init(jax.random.PRNGKey(0))
    idx = {n: jnp.asarray(np.arange(0, v, 3, dtype=np.int32))
           for n, v, _, _ in VARS}
    rows = coll.pull(states, idx, batch_sharded=False)
    states = coll.apply_gradients(
        states, idx, {k: jnp.ones_like(v) for k, v in rows.items()},
        batch_sharded=False)
    return mesh, coll, states


def test_jax_save_loads_bit_equal_in_port(jax_trained, tmp_path):
    _, jcoll, jstates = jax_trained
    path = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(path, jcoll, jstates, include_optimizer=True,
                             model_sign="m-1")
    info = {}
    states = tck.load_checkpoint(path, _port_coll(), info=info)
    # what JAX's load reports for a chainless dump
    assert info == {"applied_seq": 0, "resume_extra": {}}
    for name, vocab, dim, dtype in VARS:
        w, slots = _jax_numpy(jcoll, jstates, name, vocab)
        tw, tslots = interop.table_state_to_numpy(states[name])
        assert tw.shape == (vocab, dim)
        np.testing.assert_array_equal(tw, _bits(w))
        assert set(tslots) == set(slots) == {"accum"}
        np.testing.assert_array_equal(tslots["accum"], slots["accum"])
        assert not np.all(slots["accum"] == np.float32(0.1))


def test_port_save_loads_bit_equal_in_jax(devices8, tmp_path):
    coll = _port_coll()
    states = coll.init()
    for st in states.values():      # non-init slot values
        st.slots["accum"].uniform_(0.0, 3.0)
    path = str(tmp_path / "ck")
    info = tck.save_checkpoint(path, coll, states, include_optimizer=True,
                               model_sign="m-2")
    assert info["mode"] == "full" and info["seq"] == 0
    mesh = create_mesh(2, 4, devices8)
    jcoll = _jax_coll(mesh)
    jstates = jax_ckpt.load_checkpoint(path, jcoll)
    for name, vocab, _, _ in VARS:
        w, slots = _jax_numpy(jcoll, jstates, name, vocab)
        tw, tslots = interop.table_state_to_numpy(states[name])
        np.testing.assert_array_equal(_bits(w), tw)
        np.testing.assert_array_equal(slots["accum"], tslots["accum"])
    # the model_meta carries the same keys as a JAX save of the same model
    jpath = str(tmp_path / "jck")
    jax_ckpt.save_checkpoint(jpath, jcoll, jstates, include_optimizer=True,
                             model_sign="m-2")
    mine = json.load(open(os.path.join(path, "model_meta")))
    theirs = json.load(open(os.path.join(jpath, "model_meta")))
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["extra"]) == sorted(theirs["extra"])
    assert mine["variables"] == theirs["variables"]
    assert mine["extra"]["storage_dtypes"] == \
        theirs["extra"]["storage_dtypes"]
    # and the array files are byte-identical to JAX's own dump
    for name, vocab, _, _ in VARS:
        vdir = tck._var_dir(jcoll.variable_id(name), name)
        for f in ("weights.npy", "slot_accum.npy"):
            a = open(os.path.join(path, vdir, f), "rb").read()
            b = open(os.path.join(jpath, vdir, f), "rb").read()
            assert a == b, (name, f)


def test_port_roundtrip_and_serving_load_skips_slots(tmp_path):
    coll = _port_coll()
    states = coll.init()
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, coll, states, include_optimizer=True)
    back = tck.load_checkpoint(path, _port_coll())
    for name in states:
        assert torch.equal(back[name].weights, states[name].weights)
        assert torch.equal(back[name].slots["accum"],
                           states[name].slots["accum"])
    served = tck.load_checkpoint(path, _port_coll({"category": "default"}))
    for name in states:
        assert served[name].slots == {}
        assert torch.equal(served[name].weights, states[name].weights)


def test_without_optimizer_state_slots_start_fresh(tmp_path):
    coll = _port_coll()
    states = coll.init()
    for st in states.values():
        st.slots["accum"].fill_(7.0)
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, coll, states, include_optimizer=False)
    assert not os.path.exists(os.path.join(
        path, tck._var_dir(0, "fields"), "slot_accum.npy"))
    back = tck.load_checkpoint(path, _port_coll())
    assert torch.all(back["fields"].slots["accum"] == 0.1)
    assert json.load(open(os.path.join(path, "model_meta")))[
        "extra"]["include_optimizer"] is False


def test_precision_migration_matches_jax(devices8, tmp_path):
    """An f32 dump loads into a bf16 collection (and back) with the same
    rounding as the JAX loader."""
    coll = _port_coll()
    states = coll.init()
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, coll, states)
    flipped = [(n, v, d, "bfloat16" if t == "float32" else "float32")
               for n, v, d, t in VARS]
    tcoll = EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t)
         for n, v, d, t in flipped], device="cpu",
        default_optimizer=ADAGRAD)
    jcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t)
         for n, v, d, t in flipped], create_mesh(2, 4, devices8),
        default_optimizer=ADAGRAD)
    mine = tck.load_checkpoint(path, tcoll)
    theirs = jax_ckpt.load_checkpoint(path, jcoll)
    for name, vocab, _, _ in flipped:
        w, _ = _jax_numpy(jcoll, theirs, name, vocab)
        np.testing.assert_array_equal(
            interop.tensor_to_numpy(mine[name].weights), _bits(w))


def test_refusals(tmp_path, devices8):
    """What a load or save still refuses: a meta mismatch, a missing
    variable, delta saves without tracking, damaged part and compressed
    files, an unknown codec, a garbage manifest, and a hash->array
    conversion whose keys fall outside the vocabulary. The layouts that
    were refused before this slice (part files, compressed streams,
    fsspec URIs, hash<->array conversion) load."""
    coll = _port_coll()
    states = coll.init()
    path = str(tmp_path / "ck")
    tck.save_checkpoint(path, coll, states)
    bad = EmbeddingCollection([EmbeddingSpec("fields", 37, 4)],
                              device="cpu")
    with pytest.raises(ValueError, match="meta mismatch"):
        tck.load_checkpoint(path, bad)
    with pytest.raises(ValueError, match="no variable"):
        tck.load_checkpoint(path, EmbeddingCollection(
            [EmbeddingSpec("other", 3, 2)], device="cpu"))
    # delta saves are ported: without dirty tracking they refuse as
    # JAX's do
    with pytest.raises(ValueError, match="dirty tracking"):
        tck.save_checkpoint(path, coll, states, mode="delta")
    with pytest.raises(ValueError, match="codec"):
        tck.save_checkpoint(str(tmp_path / "lz4"), coll, states,
                            compress="lz4")
    # an fsspec URI (the in-process memory filesystem) round-trips
    mem = f"memory://refusals-{os.getpid()}/ck"
    tck.save_checkpoint(mem, coll, states)
    back = tck.load_checkpoint(mem, coll)
    for n, _, _, _ in VARS:
        assert torch.equal(back[n].weights, states[n].weights)
    vdir = os.path.join(path, tck._var_dir(0, "fields"))
    open(os.path.join(vdir, "part0_weights.npy"), "wb").close()
    with pytest.raises((ValueError, EOFError, OSError)):
        tck.load_checkpoint(path, coll)
    os.remove(os.path.join(vdir, "part0_weights.npy"))
    open(os.path.join(vdir, "weights.npyz"), "wb").close()
    with pytest.raises(ValueError, match="npyz"):
        tck.load_checkpoint(path, coll)
    os.remove(os.path.join(vdir, "weights.npyz"))
    # a delta chain loads now; a garbage manifest raises what JAX raises
    open(os.path.join(path, "delta_manifest"), "w").close()
    jmesh = create_mesh(2, 4, devices8)
    with pytest.raises(ValueError) as want:
        jax_ckpt.load_checkpoint(path, _jax_coll(jmesh))
    with pytest.raises(ValueError) as got:
        tck.load_checkpoint(path, coll)
    assert type(got.value) is type(want.value)
    os.remove(os.path.join(path, "delta_manifest"))
    # hash<->array conversion: a JAX hash dump loads into an array
    # variable and the port's array dump into a hash variable; a stored
    # key outside the array's vocabulary fails the load, in both
    # packages
    mesh = create_mesh(2, 4, devices8)
    hcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name="fields", input_dim=-1, output_dim=9,
                          hash_capacity=64)], mesh)
    hstates = hcoll.init(jax.random.PRNGKey(0))
    keys = jnp.asarray(np.array([3, 36, 40], np.int32))
    hrows = hcoll.pull(hstates, {"fields": keys}, batch_sharded=False)
    hstates = hcoll.apply_gradients(
        hstates, {"fields": keys},
        {"fields": jnp.ones_like(hrows["fields"])}, batch_sharded=False)
    hpath = str(tmp_path / "hash")
    jax_ckpt.save_checkpoint(hpath, hcoll, hstates)
    loaded = tck.load_checkpoint(hpath, EmbeddingCollection(
        [EmbeddingSpec("fields", -1, 9, hash_capacity=64)], device="cpu"))
    assert loaded["fields"].num_used() == 3
    with pytest.raises(ValueError, match="outside the bounded vocab"):
        jax_ckpt.load_checkpoint(hpath, oe.EmbeddingCollection(
            [oe.EmbeddingSpec(name="fields", input_dim=37, output_dim=9)],
            mesh))
    with pytest.raises(ValueError, match="outside the bounded vocab"):
        tck.load_checkpoint(hpath, EmbeddingCollection(
            [EmbeddingSpec("fields", 37, 9)], device="cpu"))
    wide = tck.load_checkpoint(path, EmbeddingCollection(
        [EmbeddingSpec("fields", -1, 9)], device="cpu"))
    assert wide["fields"].num_used() == 37


# --- hash variables -----------------------------------------------------------

# (name, dim, dtype): dim 9 + dim 1 like the fused hash headline, and bf16
HVARS = [("fields", 9, "float32"), ("fields:linear", 1, "float32"),
         ("emb_bf16", 8, "bfloat16")]
HCAP = 512


def _hash_specs(pkg, key_dtype, capacity=HCAP):
    make = oe.EmbeddingSpec if pkg == "jax" else EmbeddingSpec
    return [make(name=n, input_dim=-1, output_dim=d, dtype=t,
                 hash_capacity=capacity, key_dtype=key_dtype)
            for n, d, t in HVARS]


def _hash_keys(rng, n, key_dtype):
    """Unique keys in a variable's encoding; pairs carry hi != 0."""
    if key_dtype == "wide":
        ids = rng.randint(-2**62, 2**62, n, dtype=np.int64)
        ids[:3] = [0, -1, 2**33 + 5]
        return np.unique(jh.split64(ids), axis=0)
    return np.unique(rng.randint(-2**31 + 1, 2**31, n, dtype=np.int64)
                     .astype(np.int32))


def _jax_hash_dump(path, mesh, key_dtype, n=300, seed=0):
    """A JAX hash collection on ``mesh`` with ``n`` rows inserted per
    variable (adagrad slots set), saved with optimizer state; returns the
    collection and its states."""
    rng = np.random.RandomState(seed)
    coll = oe.EmbeddingCollection(_hash_specs("jax", key_dtype), mesh,
                                  default_optimizer=ADAGRAD)
    states = coll.init(jax.random.PRNGKey(0))
    for name, dim, _ in HVARS:
        keys = _hash_keys(rng, n, key_dtype)
        st = jsh.insert_rows_sharded(
            hot_cache.unwrap(states[name]), jnp.asarray(keys),
            jnp.asarray(rng.randn(len(keys), dim).astype(np.float32)),
            {"accum": jnp.asarray(rng.rand(len(keys), dim)
                                  .astype(np.float32))},
            mesh=mesh, spec=coll.sharding_spec(name))
        assert int(st.insert_failures) == 0
        states[name] = st
    jax_ckpt.save_checkpoint(path, coll, states, include_optimizer=True,
                             model_sign="h-1")
    return coll, states


def _dump_by_key(path, coll, name):
    """A hash dump as ``{int64 key: (weights bits, accum)}``, read from
    its files: the per-key view in which two placements compare."""
    vdir = os.path.join(path, tck._var_dir(coll.variable_id(name), name))
    keys = np.load(os.path.join(vdir, "keys.npy"))
    keys = jh.join64(keys) if keys.ndim == 2 else keys.astype(np.int64)
    w = np.load(os.path.join(vdir, "weights.npy"))
    acc = np.load(os.path.join(vdir, "slot_accum.npy"))
    w = w.view(np.uint16) if w.dtype.itemsize == 2 else w
    assert len(np.unique(keys)) == len(keys) == len(w) == len(acc)
    return {int(k): (w[i].tobytes(), acc[i].tobytes())
            for i, k in enumerate(keys)}


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4)])
def test_jax_hash_dump_loads_in_port_per_key(devices8, tmp_path, key_dtype,
                                             mesh_shape):
    """A JAX hash dump (one device or the 2x4 mesh, where the slots
    differ) loads into the port's table by insertion; re-dumped by the
    port, every key carries the same weights and adagrad row."""
    mesh = create_mesh(*mesh_shape, devices8[:mesh_shape[0] * mesh_shape[1]])
    path, back = str(tmp_path / "jax"), str(tmp_path / "port")
    jcoll, _ = _jax_hash_dump(path, mesh, key_dtype)
    tcoll = EmbeddingCollection(_hash_specs("port", key_dtype), device="cpu",
                                default_optimizer=ADAGRAD)
    states = tck.load_checkpoint(path, tcoll)
    for name, dim, _ in HVARS:
        st = states[name]
        assert st.capacity == HCAP and st.num_used() == 300
        assert int(st.insert_failures) == 0
    tck.save_checkpoint(back, tcoll, states, include_optimizer=True)
    for name, _, _ in HVARS:
        assert _dump_by_key(back, tcoll, name) == \
            _dump_by_key(path, jcoll, name)


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
def test_port_hash_dump_loads_in_jax(devices8, tmp_path, key_dtype):
    """A port hash dump loads through JAX ``load_checkpoint`` on the 2x4
    mesh: JAX's re-dump holds the same rows per key, and JAX's read-only
    pull answers what the port's does."""
    rng = np.random.RandomState(4)
    tcoll = EmbeddingCollection(_hash_specs("port", key_dtype), device="cpu",
                                default_optimizer=ADAGRAD)
    states = tcoll.init()
    offered = {}
    for name, dim, _ in HVARS:
        keys = _hash_keys(rng, 250, key_dtype)
        th.insert_rows(states[name], torch.from_numpy(keys),
                       torch.randn(len(keys), dim),
                       {"accum": torch.rand(len(keys), dim)})
        offered[name] = keys
    path, back = str(tmp_path / "port"), str(tmp_path / "jax")
    tck.save_checkpoint(path, tcoll, states, include_optimizer=True,
                        model_sign="h-2")
    mesh = create_mesh(2, 4, devices8)
    jcoll = oe.EmbeddingCollection(_hash_specs("jax", key_dtype), mesh,
                                   default_optimizer=ADAGRAD)
    jstates = jax_ckpt.load_checkpoint(path, jcoll)
    jax_ckpt.save_checkpoint(back, jcoll, jstates, include_optimizer=True)
    for name, _, _ in HVARS:
        assert _dump_by_key(back, jcoll, name) == \
            _dump_by_key(path, tcoll, name)
        q = np.concatenate([offered[name][:40],
                            _hash_keys(rng, 9, key_dtype)])
        want = np.asarray(jcoll.pull(jstates, {name: jnp.asarray(q)},
                                     batch_sharded=False,
                                     read_only=True)[name])
        got = tcoll.pull(states, {name: q}, read_only=True)[name]
        np.testing.assert_array_equal(interop.tensor_to_numpy(got),
                                      _bits(want))


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
def test_port_hash_dump_byte_identical_to_jax(devices8, tmp_path, key_dtype):
    """The state of a one-device JAX hash table, copied into the port and
    saved, gives byte-identical files and the same model_meta as JAX's
    own dump."""
    mesh = create_mesh(1, 1, devices8[:1])
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jcoll, jstates = _jax_hash_dump(jpath, mesh, key_dtype)
    tcoll = EmbeddingCollection(_hash_specs("port", key_dtype), device="cpu",
                                default_optimizer=ADAGRAD)
    states = {}
    for name, _, _ in HVARS:
        st = hot_cache.unwrap(jstates[name])
        states[name] = interop.hash_state_from_numpy(
            np.asarray(st.keys), np.asarray(st.weights),
            {k: np.asarray(v) for k, v in st.slots.items()}, "cpu")
    tck.save_checkpoint(tpath, tcoll, states, include_optimizer=True,
                        model_sign="h-1")
    mine = json.load(open(os.path.join(tpath, "model_meta")))
    theirs = json.load(open(os.path.join(jpath, "model_meta")))
    assert mine["variables"] == theirs["variables"]
    for key in ("hash_variables", "storage_dtypes", "include_optimizer"):
        assert mine["extra"][key] == theirs["extra"][key], key
    for name, _, _ in HVARS:
        vdir = tck._var_dir(jcoll.variable_id(name), name)
        files = sorted(os.listdir(os.path.join(jpath, vdir)))
        assert files == sorted(os.listdir(os.path.join(tpath, vdir))) == [
            "keys.npy", "slot_accum.npy", "weights.npy"]
        for f in files:
            a = open(os.path.join(tpath, vdir, f), "rb").read()
            b = open(os.path.join(jpath, vdir, f), "rb").read()
            assert a == b, (name, f)


def test_hash_dump_key_migrations(tmp_path):
    """An int32-key dump loads into a wide table as the pairs of the same
    keys (and a wide dump into an int32 table when every key fits); keys
    the target cannot hold are refused, never truncated."""
    rng = np.random.RandomState(5)
    src = EmbeddingCollection(_hash_specs("port", "int32"), device="cpu",
                              default_optimizer=ADAGRAD)
    states = src.init()
    for name, dim, _ in HVARS:
        keys = _hash_keys(rng, 200, "int32")
        th.insert_rows(states[name], torch.from_numpy(keys),
                       torch.randn(len(keys), dim))
    narrow = str(tmp_path / "narrow")
    tck.save_checkpoint(narrow, src, states, include_optimizer=True)
    wide = EmbeddingCollection(_hash_specs("port", "wide"), device="cpu",
                               default_optimizer=ADAGRAD)
    wstates = tck.load_checkpoint(narrow, wide)
    wpath = str(tmp_path / "wide")
    tck.save_checkpoint(wpath, wide, wstates, include_optimizer=True)
    back = EmbeddingCollection(_hash_specs("port", "int32"), device="cpu",
                               default_optimizer=ADAGRAD)
    bstates = tck.load_checkpoint(wpath, back)
    for name, _, _ in HVARS:
        assert wstates[name].wide and not bstates[name].wide
        assert _dump_by_key(wpath, wide, name) == \
            _dump_by_key(narrow, src, name)
        q = np.load(os.path.join(narrow, tck._var_dir(
            src.variable_id(name), name), "keys.npy"))
        assert torch.equal(
            wide.pull(wstates, {name: q.astype(np.int64)},
                      read_only=True)[name],
            src.pull(states, {name: q}, read_only=True)[name])
        assert torch.equal(back.pull(bstates, {name: q}, read_only=True)[name],
                           src.pull(states, {name: q}, read_only=True)[name])
    # a wide key beyond int32 cannot enter an int32 table
    vdir = os.path.join(wpath, tck._var_dir(0, "fields"))
    keys = np.load(os.path.join(vdir, "keys.npy"))
    keys[0] = [5, 1]
    np.save(os.path.join(vdir, "keys.npy"), keys)
    with pytest.raises(ValueError, match="outside the table's int32"):
        tck.load_checkpoint(wpath, back)
    # an int64 key in the wide EMPTY band cannot enter a wide table
    vdir = os.path.join(narrow, tck._var_dir(0, "fields"))
    keys = np.load(os.path.join(vdir, "keys.npy")).astype(np.int64)
    keys[0] = -2**63 + 5
    np.save(os.path.join(vdir, "keys.npy"), keys)
    with pytest.raises(ValueError, match="EMPTY band"):
        tck.load_checkpoint(narrow, wide)


def test_hash_load_refuses_rows_that_do_not_fit(tmp_path):
    """A dump holding more rows than the loading table's windows can place
    fails its load, naming the variable and the count."""
    rng = np.random.RandomState(6)
    big = EmbeddingCollection(_hash_specs("port", "wide", capacity=1024),
                              device="cpu", default_optimizer=ADAGRAD)
    states = big.init()
    for name, dim, _ in HVARS:
        keys = _hash_keys(rng, 600, "wide")
        th.insert_rows(states[name], torch.from_numpy(keys),
                       torch.randn(len(keys), dim))
    path = str(tmp_path / "big")
    tck.save_checkpoint(path, big, states)
    small = EmbeddingCollection(_hash_specs("port", "wide", capacity=256),
                                device="cpu", default_optimizer=ADAGRAD)
    with pytest.raises(RuntimeError,
                       match="'fields': [0-9]+ of 600 checkpoint rows did "
                             "not fit"):
        tck.load_checkpoint(path, small)


def test_trained_port_tables_load_in_jax(devices8, tmp_path):
    """Train, save, load in JAX: a port trainer takes 3 steps of a tiny
    fused DeepFM, saves with the port's ``save_checkpoint``, and JAX
    ``load_checkpoint`` reads tables and slots equal to the port's, byte
    for byte, and the dense state (``dense_state=(params, opt_state)``)
    into flax params and optax Adagrad state equal to the port's."""
    from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.optim.initializers import prng_key
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, 64, 4,
                                     optimizer=ADAGRAD)
    coll = EmbeddingCollection(specs, device="cpu")
    trainer = tr.Trainer(
        tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=4,
                       dnn_units=(16, 8)), coll, dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        32, num_buckets=64, seed=4, num_batches=3)]
    state = trainer.init(prng_key(0), batches[0])
    state, _ = trainer.fit(state, batches)
    path = str(tmp_path / "trained")
    tck.save_checkpoint(path, coll, state.emb, model_sign="t-3")
    import optax
    dpath = str(tmp_path / "d")
    with pytest.raises(TypeError, match="pair"):
        tck.save_checkpoint(dpath, coll, state.emb,
                            dense_state=state.params)
    tck.save_checkpoint(dpath, coll, state.emb,
                        dense_state=(state.params, state.opt_state))
    tree = interop.dense_params_to_flax(state.params)
    template = (tree, interop.dense_state_to_optax(
        state.opt_state, optax.adagrad(0.01).init(tree)))
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, 64, 4,
                                optimizer=ADAGRAD)
    jcoll = oe.EmbeddingCollection(jspecs, create_mesh(1, 1, devices8[:1]))
    _, (jparams, jopt) = jax_ckpt.load_checkpoint(
        dpath, jcoll, dense_state_template=jax.tree.map(
            np.zeros_like, template))
    for a, b in zip(jax.tree.leaves((jparams, jopt)),
                    jax.tree.leaves(template)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    jstates = jax_ckpt.load_checkpoint(path, jcoll)
    for name in ("fields", "fields:linear"):
        w, slots = _jax_numpy(jcoll, jstates, name, 26 * 64)
        tw, tslots = interop.table_state_to_numpy(state.emb[name])
        assert w.tobytes() == tw.tobytes()
        assert slots["accum"].tobytes() == tslots["accum"].tobytes()
        assert not np.all(tslots["accum"] == np.float32(0.1))
