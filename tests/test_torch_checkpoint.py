"""Torch port, checkpoints in both directions against the JAX package.

A JAX ``save_checkpoint`` (the 8-device CPU mesh, adagrad, optimizer
state included) loads bit-equal into the port; a port save loads
bit-equal through JAX ``load_checkpoint`` with the same model_meta keys.
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
from openembedding_tpu.parallel import hot_cache
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint as tck
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
    assert info == {"applied_seq": 0}
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
    with pytest.raises(NotImplementedError, match="delta"):
        tck.save_checkpoint(path, coll, states, mode="delta")
    with pytest.raises(NotImplementedError, match="local"):
        tck.load_checkpoint("gs://bucket/ck", coll)
    vdir = os.path.join(path, tck._var_dir(0, "fields"))
    open(os.path.join(vdir, "part0_weights.npy"), "wb").close()
    with pytest.raises(NotImplementedError, match="part file"):
        tck.load_checkpoint(path, coll)
    os.remove(os.path.join(vdir, "part0_weights.npy"))
    open(os.path.join(vdir, "weights.npyz"), "wb").close()
    with pytest.raises(NotImplementedError, match="compressed"):
        tck.load_checkpoint(path, coll)
    os.remove(os.path.join(vdir, "weights.npyz"))
    open(os.path.join(path, "delta_manifest"), "w").close()
    with pytest.raises(NotImplementedError, match="delta chain"):
        tck.load_checkpoint(path, coll)
    # a JAX hash-table dump: refused before any table is touched
    mesh = create_mesh(2, 4, devices8)
    hcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name="fields", input_dim=-1, output_dim=9,
                          hash_capacity=64)], mesh)
    hpath = str(tmp_path / "hash")
    jax_ckpt.save_checkpoint(hpath, hcoll, hcoll.init(jax.random.PRNGKey(0)))
    with pytest.raises(NotImplementedError, match="hash variable"):
        tck.load_checkpoint(hpath, EmbeddingCollection(
            [EmbeddingSpec("fields", 37, 9)], device="cpu"))
