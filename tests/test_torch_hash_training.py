"""Torch port, the hash training step against the JAX package: the hash
``pull`` with an initializer (missing keys get their init rows),
``hash_table.apply_gradients`` (dedup, insert, update, scatter) on copied
state, a 5-step ``Trainer`` trajectory over a fused hash collection, and a
hash checkpoint that trains on after loading.

Exact where the work is integer or a copy: keys arrays slot for slot (keys
overflowed into a window's second bucket and keys that find no free slot
included), insert-failure counts, and pulled rows under the default
``uniform`` initializer. Pushed rows and slots at rtol 1e-6 (the same
float32 optimizer maths in another operation order); the trajectory at
PR 4's tolerances (losses rtol 1e-5, state atol 1e-5 + rtol 1e-4).

JAX's pulls are held under ``jax.jit``, as the JAX collection and trainer
run them: compiled, XLA's CPU code takes the uniform draw's
``u * (max - min) + min`` as one fused multiply-add, which the port
reproduces; run op by op (eagerly) JAX rounds the product and the sum
apart and its init rows differ in the last bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu import checkpoint as jckpt
from openembedding_tpu import hash_table as jh
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.meta import EmbeddingVariableMeta as JaxMeta
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint as tckpt
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti

EMPTY = -2**31
DEFAULT_INIT = {"category": "uniform", "minval": -1e-3, "maxval": 1e-3}
CAPACITY = 1024           # 8 buckets of 128, windows of 2 buckets
DIM, BATCH, STEPS, VOCAB = 4, 32, 5, 64
UNITS = (16, 8)
OPT = {"category": "adagrad", "learning_rate": 0.01}


def _keys(rng, wide, n):
    if wide:
        return rng.randint(-2**31, 2**31, (n, 2),
                           dtype=np.int64).astype(np.int32)
    return rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _unique(keys):
    return np.unique(keys, axis=0) if keys.ndim == 2 else np.unique(keys)


def _jax_pull(js, keys, init=DEFAULT_INIT):
    """JAX's ``hash_table.pull``, compiled."""
    return np.asarray(jax.jit(lambda st, k: jh.pull(st, k, init))(
        js, jnp.asarray(keys)))


def _assert_init_rows(got, want, init):
    """Pulled rows against JAX's: exact, but for ``normal`` draws within
    ``test_torch_init_rows.py``'s bound, ``2^-21 * (|want| + stddev)``."""
    got = np.asarray(got)
    if init["category"] != "normal":
        np.testing.assert_array_equal(got, want)
        return
    bound = 2.0**-21 * (np.abs(want) + init.get("stddev", 1.0))
    assert np.all(np.abs(got - want) <= bound)


def _copy(js):
    """The port's copy of a JAX hash table, init key and failures too."""
    return interop.hash_state_from_numpy(
        np.asarray(js.keys), np.asarray(js.weights),
        {k: np.asarray(v) for k, v in js.slots.items()}, "cpu",
        init_rng=np.asarray(js.init_rng),
        insert_failures=int(js.insert_failures))


def _filled_pair(wide, opt, dtype="float32", stored=600):
    """A JAX table of CAPACITY slots holding ``stored`` keys (seeded rows
    and slots) and the port's copy of it."""
    rng = np.random.RandomState(1 if wide else 2)
    js = jh.create_hash_table(JaxMeta(dtype, DIM, 2**63), opt,
                              capacity=CAPACITY,
                              rng=jax.random.PRNGKey(9),
                              key_width=64 if wide else 32)
    keys = _unique(_keys(rng, wide, stored))
    w = rng.randn(len(keys), DIM).astype(np.float32)
    slot_rows = {k: np.abs(rng.randn(len(keys), *v.shape[1:])).astype(
        np.float32) for k, v in js.slots.items()}
    js = jh.insert_rows(js, jnp.asarray(keys), jnp.asarray(w).astype(
        js.weights.dtype), {k: jnp.asarray(v) for k, v in slot_rows.items()})
    return js, _copy(js), keys


def _assert_same_table(ts, js, rtol):
    keys, weights, slots, init_rng = interop.hash_state_to_numpy(ts)
    np.testing.assert_array_equal(keys, np.asarray(js.keys))
    np.testing.assert_array_equal(init_rng, np.asarray(js.init_rng))
    assert int(ts.insert_failures) == int(js.insert_failures)
    as_f32 = (lambda t: t.float().numpy())
    np.testing.assert_allclose(as_f32(ts.weights),
                               np.asarray(js.weights.astype(jnp.float32)),
                               rtol=rtol, atol=0)
    for k, v in js.slots.items():
        np.testing.assert_allclose(as_f32(ts.slots[k]),
                                   np.asarray(v.astype(jnp.float32)),
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("wide", [True, False], ids=["pairs", "int32"])
def test_pull_with_initializer_equals_jax(wide):
    """Stored keys give their rows, missing keys their init rows, EMPTY
    keys zero rows: bit for bit JAX's ``hash_table.pull``."""
    js, ts, stored = _filled_pair(wide, "adagrad")
    rng = np.random.RandomState(3)
    missing = _keys(rng, wide, 200)
    query = np.concatenate([stored[:150], missing, stored[:10]])
    query[5] = [7, EMPTY] if wide else EMPTY
    query = query.reshape((4, 90) + query.shape[1:])
    want = _jax_pull(js, query)
    got = th.pull(ts, torch.from_numpy(query), DEFAULT_INIT)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.any(want[0, 5])
    zeros = th.pull(ts, torch.from_numpy(query), None).numpy()
    hit = np.any(zeros != 0, axis=-1)
    np.testing.assert_array_equal(zeros[hit], want[hit])
    miss = ~hit
    miss[0, 5] = False                  # the EMPTY key
    assert miss.sum() >= 200 and np.all(np.any(want[miss] != 0, axis=-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("wide", [True, False], ids=["pairs", "int32"])
def test_apply_gradients_equals_jax(wide, opt, dtype):
    """Two pushes into a table at high load: keys inserted into start
    buckets and into the window's second bucket, keys that fail, EMPTY
    keys, duplicates; the keys array, failures, rows and slots as JAX's."""
    js, ts, stored = _filled_pair(wide, opt, dtype)
    rng = np.random.RandomState(4)
    for _ in range(2):
        fresh = _keys(rng, wide, 300)
        batch = np.concatenate([fresh, fresh[:60], stored[:100]])
        batch[7] = [3, EMPTY] if wide else EMPTY
        batch = batch[rng.permutation(len(batch))]
        grads = rng.randn(len(batch), DIM).astype(np.float32)
        js = jh.apply_gradients(js, opt, DEFAULT_INIT, jnp.asarray(batch),
                                jnp.asarray(grads))
        out = th.apply_gradients(ts, opt, DEFAULT_INIT,
                                 torch.from_numpy(batch),
                                 torch.from_numpy(grads))
        assert out is ts
        _assert_same_table(ts, js, rtol=1e-6)
    keys = ts.keys
    live = ts.live()
    start = th.probe_starts(keys[live], CAPACITY, th.DEFAULT_MAX_PROBES)
    offset = torch.nonzero(live).reshape(-1) - start
    assert int((offset >= th.BUCKET).sum()) > 0     # second buckets used
    assert int(ts.insert_failures) > 0              # windows overflowed


def test_apply_gradients_edge_batches():
    """An empty batch, a batch of EMPTY keys only, one key."""
    js, ts, _ = _filled_pair(True, "adagrad", stored=10)
    before = ts.keys.clone(), ts.weights.clone()
    th.apply_gradients(ts, "adagrad", DEFAULT_INIT,
                       torch.zeros((0, 2), dtype=torch.int32),
                       torch.zeros(0, DIM))
    empty = torch.full((5, 2), EMPTY, dtype=torch.int32)
    th.apply_gradients(ts, "adagrad", DEFAULT_INIT, empty, torch.ones(5, DIM))
    assert torch.equal(ts.keys, before[0])
    assert torch.equal(ts.weights, before[1])
    one = np.asarray([[12, -4]], np.int32)
    g = np.ones((1, DIM), np.float32)
    js = jh.apply_gradients(js, "adagrad", DEFAULT_INIT, jnp.asarray(one),
                            jnp.asarray(g))
    th.apply_gradients(ts, "adagrad", DEFAULT_INIT, torch.from_numpy(one),
                       torch.from_numpy(g))
    _assert_same_table(ts, js, rtol=1e-6)


def _hash_pair(devices8):
    """The JAX trainer over a fused hash collection and its state, and the
    port's trainer with that state copied over."""
    mesh = create_mesh(1, 1, devices8[:1])
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                hash_capacity=CAPACITY * 4, optimizer=OPT)
    tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                      hash_capacity=CAPACITY * 4,
                                      optimizer=OPT)
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=0, num_batches=STEPS + 1)]
    jtrainer = JaxTrainer(
        jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                               dnn_units=UNITS),
        JaxCollection(jspecs, mesh), optax.adagrad(0.01))
    jstate = jtrainer.init(jax.random.PRNGKey(0),
                           jtrainer.shard_batch(batches[0]))
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES,
                            embedding_dim=DIM, num_dense=criteo.NUM_DENSE,
                            dnn_units=UNITS)
    trainer = tr.Trainer(module, EmbeddingCollection(tspecs, device="cpu"),
                         dense.adagrad(0.01))
    state = tr.TrainState(
        step=torch.zeros((), dtype=torch.int64),
        params=interop.dense_params_from_flax(module, jstate.params, "cpu"),
        opt_state=interop.dense_state_from_optax(module, jstate.opt_state,
                                                 "cpu"),
        emb={n: _copy(s) for n, s in jstate.emb.items()})
    return jtrainer, jstate, trainer, state, batches


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_trajectory_matches_jax_trainer(devices8):
    """5 steps of the port's ``Trainer`` against the JAX ``Trainer`` from
    copied state (empty hash tables, dense parameters, optax state): every
    step inserts keys, and the keys arrays stay slot for slot JAX's."""
    jtrainer, jstate, trainer, state, batches = _first_pulls_match_jax(
        _hash_pair(devices8))
    jlosses, losses = [], []
    for b in batches[:STEPS]:
        jstate, jm = jtrainer.train_step(jstate, b)
        state, m = trainer.train_step(state, b)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for name, js in jstate.emb.items():
        ts = state.emb[name]
        keys, weights, slots, init_rng = interop.hash_state_to_numpy(ts)
        np.testing.assert_array_equal(keys, np.asarray(js.keys))
        np.testing.assert_array_equal(init_rng, np.asarray(js.init_rng))
        assert int(ts.insert_failures) == int(js.insert_failures)
        assert ts.num_used() == int(js.num_used()) > BATCH
        _close(weights, js.weights)
        _close(slots["accum"], js.slots["accum"])
    flat = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        interop.dense_params_to_flax(state.params))[0])
    for path, v in flat.items():
        _close(got[path], v)


def _first_pulls_match_jax(pair):
    """The copied state starts empty, so the first step's pull is all
    init rows: JAX's (``normal`` rows within the stated bound) before any
    training."""
    jtrainer, jstate, trainer, state, batches = pair
    ids = batches[0]["sparse"]
    for name, js in jstate.emb.items():
        init = trainer.collection.initializer(name).to_config()
        want = _jax_pull(js, ids[name], init)
        got = trainer.collection.pull(state.emb, {name: ids[name]})[name]
        _assert_init_rows(got, want, init)
    return pair


def test_copy_state_copies_hash_tables():
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES[:3], -1, DIM,
                                     hash_capacity=512, optimizer=OPT)
    coll = EmbeddingCollection(specs, device="cpu", seed=4)
    emb = coll.init()
    state = tr.TrainState(step=torch.zeros((), dtype=torch.int64),
                          params={}, opt_state={}, emb=emb)
    copy = tr.copy_state(state, "cpu")
    batch = mapper.fuse(next(criteo.synthetic_criteo(
        8, num_buckets=VOCAB, seed=0))["sparse"])
    grads = {n: torch.ones(tuple(batch[n].shape[:-1])
                           + (coll.specs[n].output_dim,)) for n in batch}
    coll.apply_gradients(emb, batch, grads)
    for name in emb:
        assert emb[name].num_used() > 0 and copy.emb[name].num_used() == 0
        assert int(copy.emb[name].insert_failures) == 0
        assert copy.emb[name].init_rng == emb[name].init_rng \
            == coll.hash_init_rng(name)


def test_collection_init_key_is_jax_rule(devices8):
    """A port collection with seed s gives hash variable v the init key
    ``fold_in(PRNGKey(s), variable_id)``, as ``collection.init(
    PRNGKey(s))`` does in JAX."""
    mesh = create_mesh(1, 1, devices8[:1])
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES[:2], -1, DIM,
                                hash_capacity=256)
    tspecs, _ = make_fused_specs(criteo.SPARSE_NAMES[:2], -1, DIM,
                                 hash_capacity=256)
    jstates = JaxCollection(jspecs, mesh).init(jax.random.PRNGKey(17))
    tcoll = EmbeddingCollection(tspecs, device="cpu", seed=17)
    for name, st in tcoll.init().items():
        assert st.init_rng == tuple(np.asarray(
            jstates[name].init_rng).tolist())


def test_checkpoint_round_trip_trains_on(devices8, tmp_path):
    """Train, save, load into a fresh collection under the trainer's
    table key, train on: the loaded state steps exactly as the saved one
    does, and the loaded tables hold JAX's keys and draw JAX's init rows
    for keys the checkpoint lacks (JAX's ``load_checkpoint`` of the same
    directory, with the same key)."""
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                     hash_capacity=CAPACITY * 4,
                                     optimizer=OPT)
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES,
                            embedding_dim=DIM, num_dense=criteo.NUM_DENSE,
                            dnn_units=UNITS)
    trainer = tr.Trainer(module, EmbeddingCollection(specs, device="cpu"),
                         dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=2, num_batches=6)]
    state = trainer.init(ti.prng_key(0), batches[0])
    for b in batches[:3]:
        state, _ = trainer.train_step(state, b)
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, trainer.collection, state.emb)
    loaded = tr.copy_state(state, "cpu")
    fresh = EmbeddingCollection(specs, device="cpu")
    # the trainer's tables took the first half of its key (``split``)
    loaded = dataclasses.replace(loaded, emb=tckpt.load_checkpoint(
        path, fresh, rng=ti.split(ti.prng_key(0))[0]))

    mesh = create_mesh(1, 1, devices8[:1])
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                hash_capacity=CAPACITY * 4, optimizer=OPT)
    jemb = jckpt.load_checkpoint(path, JaxCollection(jspecs, mesh),
                                 rng=jax.random.split(jax.random.PRNGKey(0))[0])
    new_keys = batches[4]["sparse"]
    for name, js in jemb.items():
        np.testing.assert_array_equal(loaded.emb[name].keys.numpy(),
                                      np.asarray(js.keys))
        init = fresh.initializer(name).to_config()
        want = _jax_pull(js, new_keys[name], init)
        got = fresh.pull(loaded.emb, {name: new_keys[name]})[name]
        _assert_init_rows(got, want, init)

    for b in batches[3:]:
        state, m = trainer.train_step(state, b)
        loaded, lm = trainer.train_step(loaded, b)
        assert float(m["loss"]) == float(lm["loss"])
    for name, s in state.emb.items():
        # the load re-inserts the keys in dump order, so a key's slot may
        # differ: compare rows and slots key by key
        ls = loaded.emb[name]
        assert s.num_used() == ls.num_used()
        q = s.keys[s.live()]
        src = th.find_rows(s.keys, q)
        dst = th.find_rows(ls.keys, q)
        assert bool((dst >= 0).all())
        assert torch.equal(s.weights[src], ls.weights[dst])
        assert torch.equal(s.slots["accum"][src], ls.slots["accum"][dst])
