"""Torch port, the initial state against JAX's with nothing copied.

JAX's key algebra in the port (``optim/initializers.py``): ``split``
against ``jax.random.split``, ``fold_in_static`` against flax's
``_fold_in_static``, and ``flax_param_key`` against the keys flax's
``module.init`` hands its parameters. Then whole states: a port
``EmbeddingCollection(seed=s).init()`` against JAX's
``collection.init(PRNGKey(s))`` on one shard (array tables, slots and the
hash tables' init keys), and ``Trainer.init(prng_key(0), batch)`` against
JAX's ``Trainer.init(PRNGKey(0), batch)`` for DeepFM, Wide&Deep, LR,
xDeepFM and DCN (dense parameters, optimizer state, tables, and a 3-step
loss trajectory).

Tolerances: key words, uniform, constant, bfloat16 (uniform) and
glorot_uniform values exact; normal and truncated normal values, drawn
through XLA's float32 ``erf_inv`` in JAX and the port's own, within
``2^-21 * (|want| + stddev)``; losses at rtol 1e-5 (float32 sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.core import scope as flax_scope

import openembedding_tpu as oe
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti

VOCAB, DIM, BATCH, UNITS, CIN = 64, 4, 32, (16, 8), (8, 8)
OPT = {"category": "adagrad", "learning_rate": 0.01}
TRUNC_STD = 0.87962566103423978
# name, vocabulary (-1: hash), dim, dtype, initializer (None: the
# collection's default, uniform(-1e-3, 1e-3))
MIXED = [
    ("uni", 50, 9, "float32", None),
    ("nrm", 40, 9, "float32", {"category": "normal", "stddev": 1e-4}),
    ("lin", 50, 1, "float32", {"category": "constant", "value": 0.0}),
    ("bf", 30, 4, "bfloat16", {"category": "uniform", "minval": -0.5,
                               "maxval": 0.5}),
    ("trunc", 20, 3, "float32", {"category": "normal", "truncated": True,
                                 "stddev": 0.5, "mean": 0.1}),
    ("hash", -1, 9, "float32", None),
    ("hash32", -1, 1, "float32", {"category": "constant", "value": 0.5}),
]


def _key(key) -> tuple:
    return tuple(np.asarray(key).tolist())


def _assert_drawn(got: np.ndarray, want: np.ndarray, cfg) -> None:
    """``got`` (port) against ``want`` (JAX), both float32: exact for
    uniform and constant draws, else within the ``erf_inv`` bound."""
    init = ti.make_initializer(cfg)
    kind, _ = ti.keyed_params(init)
    assert got.shape == want.shape
    if kind in (ti.UNIFORM, ti.CONSTANT):
        np.testing.assert_array_equal(got, want)
        return
    bound = 2.0**-21 * (np.abs(want) + init.stddev)
    assert np.all(np.abs(got - want) <= bound), \
        float(np.max(np.abs(got - want) - bound))


@pytest.mark.parametrize("seed", [0, 1, -5, 2**31 - 1])
def test_split_equals_jax(seed):
    for n in (2, 3, 7):
        want = jax.random.split(jax.random.PRNGKey(seed), n)
        assert ti.split(ti.prng_key(seed), n) == tuple(
            _key(k) for k in want)
    # split takes JAX keys as numpy arrays too
    key = np.asarray(jax.random.PRNGKey(seed))
    assert ti.split(key) == tuple(_key(k) for k in jax.random.split(key))


@pytest.mark.parametrize("path", [
    (), ("params",), ("MLP_0", "Dense_1", 1), ("Dense_0", 2), (0,),
    (255, 256, "x"), ("Dense_0", 2**40), ("ü", 7)])
def test_fold_in_static_equals_flax(path):
    for seed in (0, 9):
        want = flax_scope._fold_in_static(jax.random.PRNGKey(seed), path)
        assert ti.fold_in_static(ti.prng_key(seed), path) == _key(want)


def test_fold_in_static_refuses_other_parts():
    with pytest.raises(ValueError, match="int or str"):
        ti.fold_in_static(ti.prng_key(0), ("a", 1.5))


def _jax_module(kind):
    kw = {} if kind == "lr" else {"dnn_units": UNITS}
    if kind == "xdeepfm":
        kw["cin_layer_sizes"] = CIN
    return jax_models.build_model(kind, criteo.SPARSE_NAMES, **kw)


def _torch_module(kind):
    kw = {} if kind == "lr" else {"embedding_dim": DIM, "dnn_units": UNITS}
    if kind == "xdeepfm":
        # the JAX package's CIN: no split half, no per-map bias
        kw.update(cin_layer_sizes=CIN, cin_split_half=False, cin_bias=False)
    return tm.build_model(kind, criteo.SPARSE_NAMES,
                          num_dense=criteo.NUM_DENSE, **kw)


@pytest.mark.parametrize("kind", ["deepfm", "wdl", "lr", "xdeepfm", "dcn"])
def test_flax_param_keys_rebuild_module_init(kind):
    """Each kernel of JAX's ``module.init(PRNGKey(3), ...)`` is
    ``lecun_normal`` drawn from ``flax_param_key(rng, its scope, 1)``, bit
    for bit (JAX draws both), each CIN weight ``cin_w_i`` glorot_uniform
    from its scope's counter ``i + 1`` and each cross weight ``cross_w_k``
    from ``2k + 1`` (``cross_b_k`` takes ``2k + 2``), and the port names
    every parameter by its flax path."""
    rng = jax.random.PRNGKey(3)
    rows = {"fields": jnp.zeros((BATCH, len(criteo.SPARSE_NAMES), DIM)),
            "fields:linear": jnp.zeros((BATCH, len(criteo.SPARSE_NAMES),
                                        1))}
    params = _jax_module(kind).init(
        rng, jnp.zeros((BATCH, criteo.NUM_DENSE)), rows)["params"]
    leaves = {tuple(str(getattr(k, "key", k)) for k in path): v
              for path, v in jax.tree_util.tree_flatten_with_path(
                  params)[0]}
    names = [n for n, _ in _torch_module(kind).named_parameters()]
    assert {interop.flax_path(n) for n in names} == set(leaves)
    kernels = [p for p in leaves if p[-1] == "kernel"]
    assert kernels
    for path in kernels:
        key = jnp.asarray(ti.flax_param_key(_key(rng), path[:-1], 1),
                          jnp.uint32)
        want = jax.nn.initializers.lecun_normal()(key, leaves[path].shape)
        np.testing.assert_array_equal(np.asarray(leaves[path]),
                                      np.asarray(want))
    for path, v in leaves.items():
        name, _, i = path[-1].rpartition("_")
        if name not in ("cin_w", "cross_w"):
            continue
        counter = int(i) + 1 if name == "cin_w" else 2 * int(i) + 1
        key = jnp.asarray(ti.flax_param_key(_key(rng), path[:-1], counter),
                          jnp.uint32)
        want = jax.nn.initializers.glorot_uniform()(key, v.shape)
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want))


def _mixed_pair(devices8, seed):
    jcoll = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                          initializer=c, hash_capacity=256)
         for n, v, d, t, c in MIXED], create_mesh(1, 1, devices8[:1]))
    tcoll = EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=v, output_dim=d, dtype=t,
                       initializer=c, hash_capacity=256)
         for n, v, d, t, c in MIXED], device="cpu", seed=seed)
    return jcoll, tcoll


def _assert_collection_state(jcoll, tcoll, jstates, tstates):
    assert set(jstates) == set(tstates)
    for name, js in jstates.items():
        ts = tstates[name]
        if tcoll.specs[name].use_hash:
            assert ts.init_rng == _key(js.init_rng)
            assert ts.num_used() == 0
            continue
        cfg = tcoll.initializer(name).to_config()
        w = np.asarray(js.weights)
        tw, tslots = interop.table_state_to_numpy(ts)
        if w.dtype.name == "bfloat16":
            assert ti.keyed_params(tcoll.initializer(name))[0] == ti.UNIFORM
            np.testing.assert_array_equal(tw, w.view(np.uint16))
        else:
            _assert_drawn(tw, w, cfg)
        for k, v in js.slots.items():
            assert tslots[k].tobytes() == np.asarray(v).view(
                tslots[k].dtype).tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_collection_init_equals_jax_without_copy(devices8, seed):
    """``EmbeddingCollection(seed=s).init()`` holds JAX's
    ``collection.init(PRNGKey(s))`` on one shard: every array table
    (uniform, normal, constant, truncated, bfloat16), every slot, and the
    hash tables' init keys; and ``init(rng)`` follows a passed key."""
    jcoll, tcoll = _mixed_pair(devices8, seed)
    jstates = jcoll.init(jax.random.PRNGKey(seed))
    tstates = tcoll.init()
    _assert_collection_state(jcoll, tcoll, jstates, tstates)
    rng = jax.random.split(jax.random.PRNGKey(seed + 1))[1]
    _assert_collection_state(jcoll, tcoll, jcoll.init(rng),
                             tcoll.init(_key(rng)))
    only = tcoll.init(ti.prng_key(seed), only=["nrm", "hash"])
    assert set(only) == {"nrm", "hash"}
    assert torch.equal(only["nrm"].weights, tstates["nrm"].weights)
    assert only["hash"].init_rng == tstates["hash"].init_rng


def test_fused_collection_init_equals_jax_without_copy(devices8):
    """The DeepFM-shaped fused tables (``fields`` normal(0, 1e-4),
    ``fields:linear`` constant 0) equal JAX's, with nothing copied."""
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                optimizer=OPT)
    tspecs, _ = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                 optimizer=OPT)
    jcoll = oe.EmbeddingCollection(jspecs, create_mesh(1, 1, devices8[:1]))
    tcoll = EmbeddingCollection(tspecs, device="cpu", seed=3)
    _assert_collection_state(jcoll, tcoll,
                             jcoll.init(jax.random.PRNGKey(3)), tcoll.init())


def _batches(mapper, n):
    return [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=0, num_batches=n)]


@pytest.mark.parametrize("kind", ["deepfm", "wdl", "lr", "xdeepfm", "dcn"])
def test_trainer_init_equals_jax_without_copy(devices8, kind):
    """``Trainer.init(prng_key(0), batch)`` holds JAX's ``Trainer.init(
    PRNGKey(0), batch)``: dense parameters (lecun_normal kernels within
    the ``erf_inv`` bound, glorot_uniform CIN and cross weights and zero
    biases exactly), the dense optimizer's state, the tables; and 3 steps
    from the two states agree at rtol 1e-5."""
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                optimizer=OPT)
    tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                      optimizer=OPT)
    batches = _batches(mapper, 3)
    jtrainer = JaxTrainer(_jax_module(kind),
                          oe.EmbeddingCollection(
                              jspecs, create_mesh(1, 1, devices8[:1])),
                          optax.adagrad(0.01))
    jstate = jtrainer.init(jax.random.PRNGKey(0),
                           jtrainer.shard_batch(batches[0]))
    module = _torch_module(kind)
    trainer = tr.Trainer(module, EmbeddingCollection(tspecs, device="cpu"),
                         dense.adagrad(0.01))
    state = trainer.init(ti.prng_key(0), batches[0])
    want = interop.dense_params_from_flax(module, jstate.params, "cpu")
    assert set(state.params) == set(want)
    for name, w in want.items():
        got = state.params[name]
        if name.endswith(".weight"):
            std = float(np.sqrt(np.float32(1.0 / got.shape[1]))
                        / np.float32(TRUNC_STD))
            _assert_drawn(got.numpy(), w.numpy(),
                          {"category": "normal", "truncated": True,
                           "stddev": std})
        elif "cin_w_" in name or "cross_w_" in name:
            assert torch.equal(w, got)
        else:
            assert torch.equal(got, torch.zeros_like(got)) \
                and torch.equal(w, got)
    acc = interop.dense_state_from_optax(module, jstate.opt_state, "cpu")
    for name, v in acc.items():
        assert torch.equal(state.opt_state[name], v)
    for name, js in jstate.emb.items():
        tw, _ = interop.table_state_to_numpy(state.emb[name])
        _assert_drawn(tw, np.asarray(js.weights),
                      trainer.collection.initializer(name).to_config())
    jlosses, losses = [], []
    for b in batches:
        jstate, jm = jtrainer.train_step(jstate, b)
        state, m = trainer.train_step(state, b)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


def test_hash_trainer_init_keys_follow_split(devices8):
    """Under a ``Trainer`` the hash tables' init key is ``fold_in(split(
    rng)[0], variable_id)``, as in JAX's ``Trainer.init``."""
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                hash_capacity=256, optimizer=OPT)
    tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, -1, DIM,
                                      hash_capacity=256, optimizer=OPT)
    batch = _batches(mapper, 1)[0]
    jtrainer = JaxTrainer(_jax_module("deepfm"),
                          oe.EmbeddingCollection(
                              jspecs, create_mesh(1, 1, devices8[:1])),
                          optax.adagrad(0.01))
    jstate = jtrainer.init(jax.random.PRNGKey(4),
                           jtrainer.shard_batch(batch))
    coll = EmbeddingCollection(tspecs, device="cpu")
    state = tr.Trainer(_torch_module("deepfm"), coll,
                       dense.adagrad(0.01)).init(ti.prng_key(4), batch)
    emb_rng = ti.split(ti.prng_key(4))[0]
    for name, js in jstate.emb.items():
        assert state.emb[name].init_rng == _key(js.init_rng) \
            == coll.hash_init_rng(name, emb_rng)
