"""Torch port, the push: ``table.apply_gradients`` against the JAX
package's on copied state, for every optimizer category, on float32 and
bfloat16 tables (bf16 weights, f32 slots), with duplicate, negative and
out-of-range ids. Updated rows agree at rtol 1e-6; rows the batch does
not touch stay bit-identical, and ids outside the table write nothing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import table as jax_table
from openembedding_tpu.optim import optimizers as jax_opt
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import table as tt

CATEGORIES = ("default", "adadelta", "adagrad", "adam", "adamax", "ftrl",
              "rmsprop", "sgd", "test")
VOCAB, DIM = 64, 5


def _config(category):
    cfg = {"category": category}
    if category != "test":
        cfg["learning_rate"] = 0.05
    return cfg


def _as_float(arr, bf16):
    """Numpy values of a field (bf16 stored as uint16 words)."""
    if bf16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("category", CATEGORIES)
def test_apply_gradients_matches_jax(category, dtype):
    cfg = _config(category)
    meta = oe.meta.EmbeddingVariableMeta(datatype=dtype, embedding_dim=DIM,
                                         vocabulary_size=VOCAB)
    jstate = jax_table.create_table(meta, cfg, {"category": "normal"},
                                    rng=jax.random.PRNGKey(2))
    pstate = interop.table_state_from_numpy(
        np.asarray(jstate.weights),
        {k: np.asarray(v) for k, v in jstate.slots.items()}, "cpu")
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 40, (16, 6)).astype(np.int32)
    ids[0, :3] = [-1, VOCAB, VOCAB + 7]          # dropped by both
    ids[1, :2] = [VOCAB - 1, VOCAB - 1]
    grads = rng.randn(16, 6, DIM).astype(np.float32)
    # copies: on the CPU the numpy views share the tensors' memory
    before_w, before_s = interop.table_state_to_numpy(pstate)
    before_w = before_w.copy()
    before_s = {k: v.copy() for k, v in before_s.items()}
    jopt = jax_opt.make_optimizer(cfg)
    for _ in range(2):                            # twice: slots evolve
        jstate = jax_table.apply_gradients(jstate, jopt, jnp.asarray(ids),
                                           jnp.asarray(grads))
        out = tt.apply_gradients(pstate, cfg, torch.from_numpy(ids),
                                 torch.from_numpy(grads))
        assert out is pstate
    w, slots = interop.table_state_to_numpy(pstate)
    bf16 = dtype == "bfloat16"
    jw = np.asarray(jstate.weights)
    np.testing.assert_allclose(_as_float(w, bf16),
                               jw.astype(np.float32), rtol=1e-6, atol=1e-7)
    for k, v in jstate.slots.items():
        assert slots[k].dtype == np.float32
        np.testing.assert_allclose(slots[k], np.asarray(v), rtol=1e-6,
                                   atol=1e-7)
    touched = np.zeros(VOCAB, bool)
    touched[ids[(ids >= 0) & (ids < VOCAB)]] = True
    np.testing.assert_array_equal(w[~touched], before_w[~touched])
    for k in slots:
        np.testing.assert_array_equal(slots[k][~touched],
                                      before_s[k][~touched])
    if category != "default":
        assert not np.array_equal(w[touched], before_w[touched])


def test_apply_gradients_edge_batches():
    """No valid id at all (row 0 stays as it was), an empty batch, and a
    batch that touches row 0 beside dropped ids."""
    meta = oe.meta.EmbeddingVariableMeta("float32", DIM, VOCAB)
    st = tt.create_table(meta, {"category": "sgd", "learning_rate": 1.0},
                         {"category": "normal"}, device="cpu")
    w0 = st.weights.clone()
    g = torch.ones(4, DIM)
    tt.apply_gradients(st, {"category": "sgd", "learning_rate": 1.0},
                       torch.tensor([-3, VOCAB, VOCAB + 1, -3]), g)
    assert torch.equal(st.weights, w0)
    tt.apply_gradients(st, {"category": "sgd", "learning_rate": 1.0},
                       torch.zeros(0, dtype=torch.int64),
                       torch.zeros(0, DIM))
    assert torch.equal(st.weights, w0)
    tt.apply_gradients(st, {"category": "sgd", "learning_rate": 1.0},
                       torch.tensor([-1, 0, VOCAB, 0]), g)
    want = w0.clone()
    want[0] -= 2.0
    assert torch.equal(st.weights, want)
    assert torch.equal(st.slots["moment"][0], torch.full((DIM,), 2.0))
    assert torch.equal(st.slots["moment"][1:], torch.zeros(VOCAB - 1, DIM))


def test_collection_apply_gradients_array_and_hash():
    """The collection pushes array variables in place and leaves the
    others' states alone; a hash variable's push inserts its keys with
    their init rows (what a pull gave them) and updates them."""
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    coll = EmbeddingCollection(
        [EmbeddingSpec("a", VOCAB, DIM), EmbeddingSpec("b", VOCAB, DIM),
         EmbeddingSpec("h", -1, DIM, hash_capacity=256)], device="cpu")
    states = coll.init()
    b0 = states["b"].weights.clone()
    ids = np.asarray([[1, 2], [2, 70]], np.int64)
    a0 = states["a"].weights.clone()
    out = coll.apply_gradients(states, {"a": ids},
                               {"a": torch.ones(2, 2, DIM)})
    assert out is states and torch.equal(states["b"].weights, b0)
    want = a0.clone()
    want[1] -= 0.01                      # the default: sgd, lr 0.01
    want[2] -= 0.02
    assert torch.equal(states["a"].weights, want)
    keys = np.asarray([[1, 2, 2], [70, 2, -5]], np.int64)  # a trailing 2: pairs
    fresh = coll.pull(states, {"h": keys})["h"]
    assert not torch.equal(fresh, torch.zeros_like(fresh))
    a1 = states["a"].weights.clone()
    coll.apply_gradients(states, {"h": keys}, {"h": torch.ones(2, 3, DIM)})
    assert torch.equal(states["a"].weights, a1)
    assert states["h"].num_used() == 4
    got = coll.pull(states, {"h": keys}, read_only=True)["h"]
    counts = torch.tensor([[1.0, 3.0, 3.0], [1.0, 3.0, 1.0]])[..., None]
    assert torch.equal(got, fresh - 0.01 * counts)
