"""Torch port, ``training.Trainer`` against the JAX ``Trainer`` on one
device: a 5-step trajectory from copied state (tables and slots, dense
parameters, optax Adagrad state) on ``synthetic_criteo`` batches, fused
(DeepFM, xDeepFM) and per-feature (Wide&Deep and DCN through
``add_linear_columns``);
``eval_step``, ``fit(log_every=)``, ``model_sign`` and the arguments that
raise ``NotImplementedError``.

Losses agree at rtol 1e-5; the final tables, slots, dense parameters and
accumulators at atol 1e-5 + rtol 1e-4 (five steps of float32 maths whose
sums run in another order: the dense layers' products and the row
gradients' scatter-adds).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                EmbeddingSpec)
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti

VOCAB, DIM, BATCH, STEPS = 64, 4, 32, 5
UNITS = (16, 8)
CIN = (8, 8)
OPT = {"category": "adagrad", "learning_rate": 0.01}
PER_FEATURE = criteo.SPARSE_NAMES[:4]


def _batches(fused_mapper, n, seed=0):
    raw = list(criteo.synthetic_criteo(BATCH, num_buckets=VOCAB, seed=seed,
                                       num_batches=n))
    if fused_mapper is not None:
        return [fused_mapper.fuse_batch(b) for b in raw]
    raw = [{**b, "sparse": {f: b["sparse"][f] for f in PER_FEATURE}}
           for b in raw]
    return list(criteo.add_linear_columns(raw))


def _pair(devices8, kind, fused):
    """The JAX trainer and state, and the port's trainer with the JAX
    state copied over."""
    mesh = create_mesh(1, 1, devices8[:1])
    if fused:
        jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                    optimizer=OPT)
        tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                          optimizer=OPT)
        names = criteo.SPARSE_NAMES
    else:
        jspecs = jax_models.make_feature_specs(PER_FEATURE, VOCAB, DIM,
                                               optimizer=OPT)
        tspecs = tm.make_feature_specs(PER_FEATURE, VOCAB, DIM,
                                       optimizer=OPT)
        mapper, names = None, PER_FEATURE
    batches = _batches(mapper, STEPS + 1)
    extra = {"cin_layer_sizes": CIN} if kind == "xdeepfm" else {}
    jtrainer = JaxTrainer(
        jax_models.build_model(kind, names, dnn_units=UNITS, **extra),
        JaxCollection(jspecs, mesh), optax.adagrad(0.01))
    jstate = jtrainer.init(jax.random.PRNGKey(0),
                           jtrainer.shard_batch(batches[0]))
    module = tm.build_model(kind, names, embedding_dim=DIM,
                            num_dense=criteo.NUM_DENSE, dnn_units=UNITS,
                            **extra)
    trainer = tr.Trainer(module, EmbeddingCollection(tspecs, device="cpu"),
                         dense.adagrad(0.01))
    emb = {n: interop.table_state_from_numpy(
        np.asarray(s.weights), {k: np.asarray(v) for k, v in s.slots.items()},
        "cpu") for n, s in jstate.emb.items()}
    state = tr.TrainState(
        step=torch.zeros((), dtype=torch.int64),
        params=interop.dense_params_from_flax(module, jstate.params, "cpu"),
        opt_state=interop.dense_state_from_optax(module, jstate.opt_state,
                                                 "cpu"),
        emb=emb)
    return jtrainer, jstate, trainer, state, batches


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,fused", [
    ("deepfm", True), ("wdl", False), ("xdeepfm", True), ("dcn", False)],
    ids=["deepfm_fused", "wdl_per_feature", "xdeepfm_fused",
         "dcn_per_feature"])
def test_trajectory_matches_jax_trainer(devices8, kind, fused):
    jtrainer, jstate, trainer, state, batches = _pair(devices8, kind, fused)
    jlosses, losses = [], []
    for b in batches[:STEPS]:
        jstate, jm = jtrainer.train_step(jstate, b)
        state, m = trainer.train_step(state, b)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert int(state.step) == int(jstate.step) == STEPS
    for name, js in jstate.emb.items():
        w, slots = interop.table_state_to_numpy(state.emb[name])
        _close(w, js.weights)
        _close(slots["accum"], js.slots["accum"])
    flat = dict(jax.tree_util.tree_flatten_with_path(jstate.params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        interop.dense_params_to_flax(state.params))[0])
    assert set(got) == set(flat)
    for path, v in flat.items():
        _close(got[path], v)
    acc = interop.dense_state_to_optax(state.opt_state, jstate.opt_state)
    for (path, v), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0],
            jax.tree_util.tree_flatten_with_path(acc)[0]):
        _close(w, v)
    # eval on a batch not trained on
    _close(trainer.eval_step(state, batches[STEPS]).numpy(),
           jtrainer.eval_step(jstate, batches[STEPS]))


def test_dense_adagrad_matches_optax():
    """The optax form, state and all, over a few updates on a small tree."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(4).astype(np.float32)}
    tx = optax.adagrad(0.05)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = dense.adagrad(0.05)
    ts = opt.init(tp)
    for i in range(4):
        g = {k: (rng.randn(*v.shape) * (0 if i == 1 and k == "b" else 1))
             .astype(np.float32) for k, v in params.items()}
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts[k].numpy(),
                                   np.asarray(js[0].sum_of_squares[k]),
                                   rtol=1e-6, atol=1e-7)
    sp = {"a": torch.ones(2)}
    dense.sgd(0.5).apply(sp, {"a": torch.full((2,), 2.0)},
                         dense.sgd(0.5).init(sp))
    assert torch.equal(sp["a"], torch.zeros(2))


def _tiny_trainer():
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                     optimizer=OPT)
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=DIM,
                            num_dense=criteo.NUM_DENSE, dnn_units=UNITS)
    return tr.Trainer(module, EmbeddingCollection(specs, device="cpu"),
                      dense.adagrad(0.01)), mapper


def test_fit_logs_and_model_sign():
    trainer, mapper = _tiny_trainer()
    batches = _batches(mapper, 4, seed=1)
    state = trainer.init(ti.prng_key(0), batches[0])
    logs = []
    state, last = trainer.fit(state, batches, log_every=2,
                              log_fn=logs.append)
    assert [line.split(":")[0] for line in logs] == ["step 2", "step 4"]
    assert float(logs[-1].split("=")[1]) == pytest.approx(
        float(last["loss"]), abs=1e-5)
    uuid, step = trainer.model_sign(state).rsplit("-", 1)
    assert step == "4" and len(uuid) == 12
    with pytest.raises(ValueError, match="not in the collection"):
        trainer.init(ti.prng_key(0), {"sparse": {"nope": np.zeros(2)}})


@pytest.mark.parametrize("call,item", [
    # no longer unported: a hash spec kept dense raises as in JAX
    pytest.param("sparse_as_dense", "hash", id="sparse_as_dense-ragged and "
                 "hybrid features"),
    ("offload", "host offload"),
    ("pipeline_depth", "host offload"),
    ("persist_dir", "host offload"),
    # no longer unported: fit's autosave and resume keywords behave as the
    # JAX fit's (tests/test_torch_elastic.py trains through them)
    ("autosave_every", "delta checkpoints"),
    ("autosave_dir", "delta checkpoints"),
    ("resume_from", "delta checkpoints"),
])
def test_unported_arguments_raise(call, item, tmp_path):
    trainer, mapper = _tiny_trainer()
    if call == "sparse_as_dense":
        hashed = EmbeddingSpec(name="h", input_dim=-1, output_dim=DIM)
        with pytest.raises(ValueError, match=item):
            tr.Trainer(trainer.module, trainer.collection,
                       dense.adagrad(0.01), sparse_as_dense=[hashed])
        return
    if call == "autosave_every":
        # as JAX's fit: autosave_every needs autosave_dir
        with pytest.raises(ValueError, match="requires autosave_dir"):
            trainer.fit(None, [], autosave_every=1)
        return
    if call in ("autosave_dir", "resume_from"):
        # autosave_dir alone saves nothing; resume_from a directory that
        # was never armed starts fresh at cursor 0: the state and every
        # batch go through untouched
        batches = _batches(mapper, 2, seed=1)
        state = trainer.init(ti.prng_key(0), batches[0])
        path = str(tmp_path / "never-written")
        state, last = trainer.fit(state, batches, **{call: path})
        assert int(state.step) == 2 and last is not None
        assert not (tmp_path / "never-written").exists()
        return
    with pytest.raises(NotImplementedError, match=item):
        if call in ("offload", "pipeline_depth"):
            tr.Trainer(trainer.module, trainer.collection,
                       dense.adagrad(0.01), **{call: {"x": 1} if call !=
                                               "pipeline_depth" else 2})
        else:
            trainer.fit(None, [], persist_dir="d")
