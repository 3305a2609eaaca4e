"""Torch port, the ``sparse_as_dense`` hybrid against the JAX package: the
split rule, ``DenseEmbeddings``' invalid-index contract (forward and
gradients), ``HybridModel``'s initial parameters against flax's
``module.init`` with nothing copied, optax-form ``adam``, 5-step
``Trainer`` trajectories with a pooled history feature and dense-kept
features (dense Adagrad and Adam), the dense-kept path against the
collection under SGD, and the captured eval step's program cache (its
CPU form, the eager program).

Tolerances: the split rule, the lookup's rows, zero initial values and
the program counts are exact; pooled lookups within an ulp (XLA fuses the
pooling's sum into the gather, in its own order); normal draws (flax's
``lecun_normal`` kernels, ``make_feature_specs``' tables) within ``2^-21
* (|want| + stddev)`` (the port's ``erf_inv`` against XLA's, as
``tests/test_torch_init_parity.py``); ``adam`` within
rtol 1e-6 (XLA fuses each moment update into one multiply-add and
neither side rounds ``pow`` correctly); trajectories at PR 4's bounds,
losses rtol 1e-5, state atol 1e-5 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import EmbeddingSpec as JaxSpec
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu import hybrid as jhy
from openembedding_tpu import ragged as jr
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import hybrid as thy
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.analysis import retrace
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                               EmbeddingSpec)
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti

DIM, BATCH, STEPS, HIST_LEN, HIST_VOCAB = 4, 16, 5, 5, 48
UNITS = (16, 8)
NAMES = criteo.SPARSE_NAMES[:4]
VOCABS = (8, 40, 60, 16)          # threshold 16 keeps C1 and C4 dense
THRESHOLD = 16
OPT = {"category": "adagrad", "learning_rate": 0.01}


def _specs(pkg):
    """The example's hybrid-and-history specs at test size: per-feature
    vocabularies and ``:linear`` twins, plus ``hist`` (mean) and
    ``hist:linear`` (sum)."""
    spec = JaxSpec if pkg == "jax" else EmbeddingSpec
    models = jax_models if pkg == "jax" else tm
    specs = models.make_feature_specs(NAMES, list(VOCABS), DIM,
                                      optimizer=OPT)
    return tuple(specs) + (
        spec(name="hist", input_dim=HIST_VOCAB, output_dim=DIM,
             optimizer=OPT, pooling="mean"),
        spec(name="hist:linear", input_dim=HIST_VOCAB, output_dim=1,
             optimizer=OPT, pooling="sum"))


def _batches(n, seed=0):
    """Batches as ``examples/criteo_deepctr.py`` builds them with
    ``--hist_len``: each column taken modulo its vocabulary, ``:linear``
    twins, and a history drawn from ``RandomState(7)``, padded with -1."""
    rng = np.random.RandomState(7)
    out = []
    for b in criteo.add_linear_columns(criteo.synthetic_criteo(
            BATCH, num_buckets=64, seed=seed, num_batches=n)):
        sparse = {}
        for name, v in zip(NAMES, VOCABS):
            sparse[name] = sparse[name + ":linear"] = \
                (b["sparse"][name] % v).astype(np.int32)
        h = jr.pad_ragged([rng.randint(0, HIST_VOCAB,
                                       rng.randint(0, HIST_LEN + 1))
                           for _ in range(BATCH)], max_len=HIST_LEN)
        sparse["hist"] = sparse["hist:linear"] = h
        out.append({**b, "sparse": sparse})
    return out


def _jax_trainer(devices8, tx):
    mesh = create_mesh(1, 1, devices8[:1])
    sparse, dense_specs = jhy.split_sparse_dense(_specs("jax"), THRESHOLD)
    module = jax_models.build_model("deepfm", NAMES + ("hist",),
                                    dnn_units=UNITS)
    return JaxTrainer(module, JaxCollection(sparse, mesh), tx,
                      sparse_as_dense=dense_specs)


def _port_trainer(tx, device="cpu"):
    sparse, dense_specs = thy.split_sparse_dense(_specs("torch"), THRESHOLD)
    module = tm.build_model("deepfm", NAMES + ("hist",), embedding_dim=DIM,
                            num_dense=criteo.NUM_DENSE, dnn_units=UNITS)
    return tr.Trainer(module, EmbeddingCollection(sparse, device=device),
                      tx, sparse_as_dense=dense_specs)


def _copy_state(trainer, jstate):
    """The port's copy of a JAX hybrid train state."""
    emb = {n: interop.table_state_from_numpy(
        np.asarray(s.weights), {k: np.asarray(v) for k, v in s.slots.items()},
        "cpu") for n, s in jstate.emb.items()}
    return tr.TrainState(
        step=torch.zeros((), dtype=torch.int64),
        params=interop.dense_params_from_flax(trainer.module, jstate.params,
                                              "cpu"),
        opt_state=interop.dense_state_from_optax(
            trainer.module, jstate.opt_state, "cpu"),
        emb=emb)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# --- split rule, lookup --------------------------------------------------------

def _rule_specs(spec_cls):
    return tuple(spec_cls(name=f"f{i}", input_dim=v, output_dim=DIM)
                 for i, v in enumerate([8, 64, 65, 4096])) + (
        spec_cls(name="h", input_dim=-1, output_dim=DIM),)


@pytest.mark.parametrize("size,batch", [(64, None), (64, 1024), (8, None),
                                        (4096, None), (0, 66)])
def test_split_rule_matches_jax(size, batch):
    got = thy.split_sparse_dense(_rule_specs(EmbeddingSpec), size, batch)
    want = jhy.split_sparse_dense(_rule_specs(JaxSpec), size, batch)
    assert [[s.name for s in part] for part in got] == \
        [[s.name for s in part] for part in want]
    assert [vars(s) for s in got[1]] == [vars(s) for s in want[1]]
    with pytest.raises(ValueError, match="hash"):
        thy.to_dense_spec(EmbeddingSpec(name="h", input_dim=-1,
                                        output_dim=DIM))


@pytest.mark.parametrize("pooling", [None, "mean", "sqrtn"])
def test_dense_embeddings_invalid_index_contract(pooling):
    """Rows and gradients against flax's ``DenseEmbeddings``: ids outside
    ``[0, input_dim)`` give zero rows and no gradient; pooled specs pool
    their ``[B, L]`` rows."""
    vocab = 16
    spec = JaxSpec(name="f", input_dim=vocab, output_dim=DIM,
                   pooling=pooling)
    jmod = jhy.DenseEmbeddings((jhy.to_dense_spec(spec),))
    rng = np.random.RandomState(0)
    ids = rng.randint(-3, vocab + 3, (BATCH, 3) if pooling else (BATCH,))
    ids = ids.astype(np.int32)
    table = rng.randn(vocab, DIM).astype(np.float32)
    cot = rng.randn(BATCH, DIM).astype(np.float32)

    def jloss(t):
        rows = jmod.apply({"params": {"f": t}}, {"f": jnp.asarray(ids)})["f"]
        return jnp.sum(rows * cot), rows
    (_, jrows), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(table))
    tmod = thy.DenseEmbeddings((thy.to_dense_spec(EmbeddingSpec(
        name="f", input_dim=vocab, output_dim=DIM, pooling=pooling)),))
    t = torch.from_numpy(table).requires_grad_()
    rows = torch.func.functional_call(tmod, {"f": t},
                                      ({"f": torch.from_numpy(ids)},))["f"]
    (tgrad,) = torch.autograd.grad((rows * torch.from_numpy(cot)).sum(), t)
    if pooling:
        # XLA fuses the pooling's sum into the gather and adds in its own
        # order inside this program: an ulp apart
        np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                                   rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(rows.detach().numpy(),
                                      np.asarray(jrows))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-7)
    hit = np.unique(ids[(ids >= 0) & (ids < vocab)])
    untouched = np.setdiff1d(np.arange(vocab), hit)
    assert not tgrad.numpy()[untouched].any()


# --- initial state --------------------------------------------------------------

def _normal_close(got, want, stddev):
    """A normal draw against flax's: within ``2^-21 * (|want| +
    stddev)``."""
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 2.0**-21 * (np.abs(want) + stddev))


@pytest.mark.parametrize("missing", [False, True])
def test_hybrid_init_matches_flax_without_copy(devices8, missing):
    """``Trainer.init`` of the hybrid against the JAX ``Trainer.init``
    from the same key, nothing copied: the inner model's parameters under
    ``inner``, and the dense-kept tables under ``sparse_as_dense``, drawn
    with flax's counter among the sample batch's dense-kept columns. An
    ``aux`` column, dense-kept and first in spec order but read by no
    model, is left out of the sample batch in one case: neither side has
    its table, every later table's counter shifts, and a batch holding it
    raises in the port."""
    aux = {"name": "aux", "input_dim": 8, "output_dim": DIM,
           "optimizer": OPT}
    batch = _batches(1)[0]
    batch["sparse"]["aux"] = batch["sparse"]["C1"]
    sample = batch
    if missing:
        sample = {**batch, "sparse": {k: v for k, v in batch["sparse"].items()
                                      if k != "aux"}}
    mesh = create_mesh(1, 1, devices8[:1])
    sparse, kept = jhy.split_sparse_dense(
        (JaxSpec(**aux),) + _specs("jax"), THRESHOLD)
    jtrainer = JaxTrainer(
        jax_models.build_model("deepfm", NAMES + ("hist",), dnn_units=UNITS),
        JaxCollection(sparse, mesh), optax.adagrad(0.01),
        sparse_as_dense=kept)
    jstate = jtrainer.init(jax.random.PRNGKey(3),
                           jtrainer.shard_batch(sample))
    sparse, kept = thy.split_sparse_dense(
        (EmbeddingSpec(**aux),) + _specs("torch"), THRESHOLD)
    trainer = tr.Trainer(
        tm.build_model("deepfm", NAMES + ("hist",), embedding_dim=DIM,
                       num_dense=criteo.NUM_DENSE, dnn_units=UNITS),
        EmbeddingCollection(sparse, device="cpu"), dense.adagrad(0.01),
        sparse_as_dense=kept)
    state = trainer.init(ti.prng_key(3), sample)
    want = _leaves(jstate.params)
    got = _leaves(interop.dense_params_to_flax(state.params))
    assert set(got) == set(want)
    tables = [k for k in want if "sparse_as_dense" in k]
    assert len(tables) == (4 if missing else 5)
    for k, w in want.items():
        if k.endswith("['kernel']"):
            _normal_close(got[k], w, np.sqrt(np.float32(1.0 / w.shape[0]))
                          / 0.87962566)
        elif k in tables:
            _normal_close(got[k], w, 1e-4)     # make_feature_specs' normal
        else:
            np.testing.assert_array_equal(got[k], w)
    for name, js in jstate.emb.items():
        _normal_close(state.emb[name].weights.numpy(), np.asarray(js.weights),
                      1e-4)
    if missing:
        with pytest.raises(ValueError, match="has no table"):
            trainer.train_step(state, batch)
    else:
        trainer.train_step(state, batch)


# --- dense optimizer ------------------------------------------------------------

def test_dense_adam_matches_optax():
    """``dense.adam`` against ``optax.adam`` over 5 updates, state and all
    (``interop.dense_state_to_optax``), within rtol 1e-6."""
    module = tm.build_model("deepfm", NAMES, embedding_dim=DIM,
                            num_dense=criteo.NUM_DENSE, dnn_units=UNITS)
    rng = np.random.RandomState(1)
    params = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
              for k, v in module.named_parameters()}
    jparams = interop.dense_params_to_flax(params)
    tx = optax.adam(1e-3)
    jopt = tx.init(jparams)
    adam = dense.adam(1e-3)
    opt = adam.init(params)
    update = jax.jit(tx.update)
    for _ in range(5):
        grads = {k: torch.from_numpy((rng.randn(*v.shape)
                                      * 10 ** rng.uniform(-3, 1)).astype(
                                          np.float32))
                 for k, v in params.items()}
        u, jopt = update(interop.dense_params_to_flax(grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, u)
        adam.apply(params, grads, opt)
    want = _leaves(jparams)
    got = _leaves(interop.dense_params_to_flax(params))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-9)
    back = interop.dense_state_to_optax(opt, jopt)
    assert int(back[0].count) == int(jopt[0].count) == 5
    for slot in ("mu", "nu"):
        want = _leaves(getattr(jopt[0], slot))
        got = _leaves(getattr(back[0], slot))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
    again = interop.dense_state_from_optax(module, jopt, "cpu")
    assert set(again) == set(opt) and again["count"].dtype == torch.int32


# --- training -------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_hybrid_pooled_trajectory_matches_jax_trainer(devices8, opt):
    """5 steps of the hybrid with a pooled history against the JAX
    ``Trainer`` from a copy of its state: losses rtol 1e-5; collection
    tables and slots, dense parameters (the dense-kept tables among them)
    and the dense optimizer's state at atol 1e-5 + rtol 1e-4; eval scores
    on an unseen batch, captured-program form and eager alike."""
    jtx, ttx = ((optax.adagrad(0.01), dense.adagrad(0.01)) if opt ==
                "adagrad" else (optax.adam(1e-3), dense.adam(1e-3)))
    batches = _batches(STEPS + 1)
    jtrainer = _jax_trainer(devices8, jtx)
    jstate = jtrainer.init(jax.random.PRNGKey(0),
                           jtrainer.shard_batch(batches[0]))
    trainer = _port_trainer(ttx)
    state = _copy_state(trainer, jstate)
    jlosses, losses = [], []
    for b in batches[:STEPS]:
        jstate, jm = jtrainer.train_step(jstate, b)
        state, m = trainer.train_step(state, b)
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert set(state.emb) == set(jstate.emb) == {
        "C2", "C3", "C2:linear", "C3:linear", "hist", "hist:linear"}
    for name, js in jstate.emb.items():
        w, slots = interop.table_state_to_numpy(state.emb[name])
        _close(w, js.weights)
        _close(slots["accum"], js.slots["accum"])
    want = _leaves(jstate.params)
    got = _leaves(interop.dense_params_to_flax(state.params))
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v)
    back = interop.dense_state_to_optax(state.opt_state, jstate.opt_state)
    for (_, v), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(jstate.opt_state)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        _close(w, v)
    want = np.asarray(jtrainer.eval_step(jstate, batches[STEPS]))
    _close(trainer.eval_step(state, batches[STEPS]).numpy(), want)
    _close(trainer.eval_step_eager(state, batches[STEPS]).numpy(), want)


def _lr_run(kept: bool, steps=4):
    """The LR model over two features of 32 ids, their tables (constant
    0.1) and ``:linear`` twins on the collection or all dense-kept, SGD
    0.5 on both sides."""
    sgd = {"category": "sgd", "learning_rate": 0.5}
    specs = tuple(
        EmbeddingSpec(name=n + sfx, input_dim=32, output_dim=d,
                      initializer={"category": "constant", "value": v},
                      optimizer=sgd)
        for sfx, d, v in (("", DIM, 0.1), (":linear", 1, 0.0))
        for n in ("f0", "f1"))
    sparse, kept_specs = thy.split_sparse_dense(specs, 64) if kept \
        else (specs, ())
    assert len(kept_specs) == (4 if kept else 0)
    trainer = tr.Trainer(
        tm.LogisticRegression(feature_names=("f0", "f1"), num_dense=0),
        EmbeddingCollection(sparse, device="cpu"), dense.sgd(0.5),
        sparse_as_dense=kept_specs or None)
    rng = np.random.RandomState(0)

    def batch():
        cols = {n: rng.randint(0, 32, BATCH).astype(np.int32)
                for n in ("f0", "f1")}
        return {"label": (cols["f0"] % 2).astype(np.float32), "dense": None,
                "sparse": {s.name: cols[s.name.split(":")[0]]
                           for s in specs}}
    state = trainer.init(ti.prng_key(1), batch())
    losses = [float(trainer.train_step(state, batch())[1]["loss"])
              for _ in range(steps)]
    probe = torch.arange(32, dtype=torch.int32)
    if kept:
        tables = {n[len("sparse_as_dense."):]: v for n, v in
                  state.params.items() if n.startswith("sparse_as_dense.")}
    else:
        tables = trainer.collection.pull(state.emb,
                                         {s.name: probe for s in specs})
    return losses, tables


def test_hybrid_sgd_parity():
    """Under plain SGD a feature trains the same on either path: the
    dense-kept tables equal the collection's (JAX's
    ``test_hybrid_sgd_parity``, in the port)."""
    losses_s, rows_s = _lr_run(kept=False)
    losses_d, rows_d = _lr_run(kept=True)
    np.testing.assert_allclose(losses_s, losses_d, rtol=1e-5, atol=1e-6)
    assert set(rows_s) == set(rows_d)
    for name in rows_s:
        np.testing.assert_allclose(rows_s[name].numpy(),
                                   rows_d[name].detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_eval_programs_cached_like_step_programs():
    """``eval_step`` keeps programs keyed as the step programs are (its
    CPU form, the eager eval): one build per batch signature and state,
    counted by the retrace guard; a new column set or batch size, or a
    copy of the state, builds another; a stale one is dropped; its scores
    equal ``eval_step_eager``'s; the step programs are left alone."""
    trainer = _port_trainer(dense.adam(1e-3))
    batches = _batches(3)
    state = trainer.init(ti.prng_key(0), batches[0])
    state, _ = trainer.train_step(state, batches[0])
    assert trainer.builds == 1
    with retrace.RetraceGuard(budget=100) as guard:
        for b in batches:
            scores = trainer.eval_step(state, b)
            assert torch.equal(scores, trainer.eval_step_eager(state, b))
        assert guard.compiles == 1 and trainer.eval_builds == 1
        small = {**batches[0], "label": batches[0]["label"][:8],
                 "dense": batches[0]["dense"][:8],
                 "sparse": {k: v[:8] for k, v in
                            batches[0]["sparse"].items()}}
        assert trainer.eval_step(state, small).shape == (8,)
        copy = tr.copy_state(state, "cpu")
        trainer.eval_step(copy, batches[0])
        trainer.eval_step(copy, batches[1])
    assert guard.compiles == 3 and trainer.eval_builds == 3
    assert len(trainer.eval_programs) == 3
    del copy
    trainer.eval_step(tr.copy_state(state, "cpu"), batches[0])
    assert trainer.eval_builds == 4 and len(trainer.eval_programs) == 3
    assert trainer.builds == 1 and len(trainer.programs) == 1
