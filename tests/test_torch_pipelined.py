"""Torch port, the pipelined schedule (``parallel/pipelined.py``) against
the port's serial ``a2a`` step and JAX's pipelined Trainer on 2 x 2 meshes
(``tests/test_pipelined.py``'s cases).

The plane changes the schedule, never the numbers: losses, evals and
tables equal ``a2a``'s bit for bit across a lookahead, an eval between
steps, a drain and a lookahead miss; grouped+pipelined equals grouped
bit for bit; pipelined members beside serial ones stay exact. The fused
``deepfm`` Trainer on ``a2a+pipelined`` follows JAX's at rtol 1e-5 (the
tolerance of the serial planes' Trainer parity,
``test_torch_sharded_training.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import optax

import openembedding_tpu as oe
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu_torch import hash_table as tht
from openembedding_tpu_torch import offload as toff
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel.mesh import create_mesh
from openembedding_tpu_torch.utils import observability

OPT = {"category": "adagrad", "learning_rate": 0.1}
INIT = {"category": "constant", "value": 0.25}
B, L = 32, 4
NAMES = ("t3", "t6", "tp")


class TinyModel(torch.nn.Module):
    """The rows side by side, then one ``Dense``: real products for the
    dense half of the schedule."""

    def __init__(self, names, width):
        super().__init__()
        self.names = tuple(names)
        self.Dense_0 = torch.nn.Linear(width, 1)

    def forward(self, dense, rows):
        x = torch.cat([rows[n].reshape(rows[n].shape[0], -1)
                       for n in self.names] + [dense], dim=-1)
        return self.Dense_0(x).reshape(-1)


def _specs(kind, plane):
    common = dict(optimizer=OPT, initializer=INIT, plane=plane)
    if kind == "array":
        return (EmbeddingSpec("t3", 64, 3, **common),
                EmbeddingSpec("t6", 48, 6, **common),
                EmbeddingSpec("tp", 64, 3, pooling="mean", **common))
    key_dtype = "int32" if kind == "hash32" else "wide"
    hk = dict(input_dim=-1, hash_capacity=4096, key_dtype=key_dtype,
              **common)
    return (EmbeddingSpec(name="t3", output_dim=3, **hk),
            EmbeddingSpec(name="t6", output_dim=6, **hk),
            EmbeddingSpec(name="tp", output_dim=3, pooling="sum", **hk))


def _draw(rng, dist, hi, size):
    if dist == "uniform":
        return rng.randint(0, hi, size).astype(np.int64)
    probs = np.arange(1, hi + 1, dtype=np.float64) ** -1.1
    probs /= probs.sum()
    return rng.choice(hi, size=size, p=probs).astype(np.int64)


def _batch(rng, kind, dist):
    if kind == "array":
        sparse = {"t3": _draw(rng, dist, 64, B).astype(np.int32),
                  "t6": _draw(rng, dist, 48, B).astype(np.int32)}
        sparse["t3"][::7] = -1
        sparse["t6"][1::9] = 48 + 5
        pool = _draw(rng, dist, 64, (B, L)).astype(np.int32)
        pool[:, -1] = -1
        sparse["tp"] = pool
    else:
        sparse = {n: _draw(rng, dist, 100_000, B).astype(np.int32)
                  for n in ("t3", "t6")}
        pool = _draw(rng, dist, 100_000, (B, L)).astype(np.int32)
        pool[:, -1] = np.int32(tht.empty_key(np.int32))
        sparse["tp"] = pool
    return {"label": (rng.rand(B) > 0.5).astype(np.float32),
            "dense": rng.randn(B, 2).astype(np.float32),
            "sparse": sparse}


def _trainer(specs):
    coll = EmbeddingCollection(specs, create_mesh(2, 2, device="cpu"))
    return coll, tr.Trainer(TinyModel(NAMES, 3 + 6 + 3 + 2), coll,
                            dense.sgd(0.1))


def _run_plane(specs, batches, evals):
    """JAX's call pattern: lookahead, an eval after step 1 (no drain), a
    drain after step 2, a lookahead miss on the last step."""
    coll, trainer = _trainer(specs)
    state = trainer.init(ti.prng_key(1), batches[0])
    losses, scores = [], []
    for i, b in enumerate(batches):
        nxt = batches[i + 1] if i + 1 < len(batches) else None
        state, m = trainer.train_step(state, b, next_batch=nxt)
        losses.append(float(m["loss"]))
        if i == 1:
            scores.append(trainer.eval_step(state, evals[0]).numpy())
        if i == 2:
            state = trainer.drain_pipeline(state)
            assert state.pipe is None
    scores.append(trainer.eval_step(state, evals[1]).numpy())
    return losses, scores, state, trainer


def _assert_state_equal(sp, sa, msg):
    for n in NAMES:
        assert torch.equal(sp[n].weights, sa[n].weights), f"{msg}:{n}"
        for slot in sp[n].slots:
            assert torch.equal(sp[n].slots[slot], sa[n].slots[slot]), \
                f"{msg}:{n}:{slot}"
        if hasattr(sp[n], "insert_failures"):
            assert int(sp[n].insert_failures) == int(sa[n].insert_failures)


@pytest.mark.parametrize("kind,dist", [("array", "zipf"), ("wide", "zipf"),
                                       ("hash32", "uniform")])
def test_pipelined_matches_a2a(kind, dist):
    """Losses, evals and tables bit for bit against the serial plane,
    one step program over the run despite the drain (the re-prime fills
    the same buffer)."""
    rng = np.random.RandomState(7)
    batches = [_batch(rng, kind, dist) for _ in range(5)]
    evals = [_batch(rng, kind, dist) for _ in range(2)]
    la, ea, sa, _ = _run_plane(_specs(kind, "a2a"), batches, evals)
    lp, ep, sp, tp = _run_plane(_specs(kind, "a2a+pipelined"), batches,
                                evals)
    assert lp == la
    for p, a in zip(ep, ea):
        np.testing.assert_array_equal(p, a)
    _assert_state_equal(sp.emb, sa.emb, f"{kind}/{dist}")
    assert tp.builds == 1


def test_pipelined_composes_with_grouped():
    """``a2a+grouped+pipelined``: bit for bit the grouped plane, within
    its tolerance of ``a2a``."""
    rng = np.random.RandomState(3)
    batches = [_batch(rng, "array", "zipf") for _ in range(4)]
    evals = [_batch(rng, "array", "zipf") for _ in range(2)]
    coll = EmbeddingCollection(_specs("array", "a2a+grouped+pipelined"),
                               create_mesh(2, 2, device="cpu"))
    assert coll.pipelined_names() == NAMES == coll.grouped_names()
    lg, eg, sg, _ = _run_plane(_specs("array", "a2a+grouped"), batches,
                               evals)
    lp, ep, sp, tp = _run_plane(_specs("array", "a2a+grouped+pipelined"),
                                batches, evals)
    assert lp == lg
    for p, g in zip(ep, eg):
        np.testing.assert_array_equal(p, g)
    _assert_state_equal(sp.emb, sg.emb, "grouped+pipelined")
    assert tp.pipeline_plane == "a2a+grouped+pipelined"
    la, _, sa, _ = _run_plane(_specs("array", "a2a"), batches, evals)
    np.testing.assert_allclose(lp, la, rtol=1e-5, atol=1e-6)
    for n in NAMES:
        np.testing.assert_allclose(sp.emb[n].weights.numpy(),
                                   sa.emb[n].weights.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_pipelined_mixed_with_serial_planes():
    """A pipelined member beside a psum and an ``a2a`` member (and a
    cached one): the pipelined member stays exact, the model within the
    psum plane's tolerance of the all-``a2a`` run."""
    rng = np.random.RandomState(5)
    batches = [_batch(rng, "array", "zipf") for _ in range(4)]
    evals = [_batch(rng, "array", "zipf") for _ in range(2)]
    la, _, sa, _ = _run_plane(_specs("array", "a2a"), batches, evals)
    a, b, c = _specs("array", "a2a")
    for third in ("a2a", "a2a+cache"):
        mixed = (dataclasses.replace(a, plane="a2a+pipelined"),
                 dataclasses.replace(b, plane="psum"),
                 dataclasses.replace(c, plane=third))
        coll, trainer = _trainer(mixed)
        assert coll.pipelined_names() == ("t3",)
        state = trainer.init(ti.prng_key(1), batches[0])
        losses = []
        for i, bt in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            state, m = trainer.train_step(state, bt, next_batch=nxt)
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses, la, rtol=1e-5, atol=1e-6)
        assert torch.equal(state.emb["t3"].weights, sa.emb["t3"].weights)
        tp_w = state.emb["tp"]
        tp_w = getattr(tp_w, "table", tp_w).weights
        np.testing.assert_allclose(tp_w.numpy(),
                                   sa.emb["tp"].weights.numpy(), rtol=1e-5,
                                   atol=1e-6)
        ca = EmbeddingCollection(_specs("array", "a2a"),
                                 create_mesh(2, 2, device="cpu"))
        probe = {"t6": np.arange(48, dtype=np.int32)}
        np.testing.assert_allclose(
            coll.pull(state.emb, probe, batch_sharded=False)["t6"].numpy(),
            ca.pull(sa.emb, probe, batch_sharded=False)["t6"].numpy(),
            rtol=1e-5, atol=1e-6)


def test_pipelined_fit_is_build_free_after_warmup():
    """``fit`` feeds its window's head as ``next_batch``: one prime (the
    warm-up), one step program, and the guard at budget 0 holds."""
    rng = np.random.RandomState(2)
    batches = [_batch(rng, "array", "uniform") for _ in range(8)]
    _, trainer = _trainer(_specs("array", "a2a+pipelined"))
    state = trainer.init(ti.prng_key(1), batches[0])
    observability.GLOBAL.reset()
    state, last = trainer.fit(state, batches, retrace_budget=0)
    assert np.isfinite(float(last["loss"]))
    assert observability.GLOBAL.snapshot()["pipeline_primes"]["count"] == 1
    assert trainer.builds == 1
    observability.GLOBAL.reset()


def test_plane_timings_step_attribution():
    """A pipelined step records its whole wall time under
    ``step/a2a+pipelined`` (once a step); with eager pull and push
    samples beside it the overlap estimate joins, as in JAX."""
    rng = np.random.RandomState(4)
    batches = [_batch(rng, "array", "uniform") for _ in range(3)]
    coll, trainer = _trainer(_specs("array", "a2a+pipelined"))
    state = trainer.init(ti.prng_key(1), batches[0])
    observability.GLOBAL.reset()
    observability.set_evaluate_performance(True)
    try:
        for i, b in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            state, _ = trainer.train_step(state, b, next_batch=nxt)
        t = observability.plane_timings()["a2a+pipelined"]
        assert t["step_calls"] == len(batches)
        assert t["pull_calls"] >= 3 and t["push_calls"] >= 3
        assert abs(t["overlap_hidden_ms"]
                   - (t["stage_serial_ms"] - t["step_ms"])) < 1e-9
    finally:
        observability.set_evaluate_performance(False)
        observability.GLOBAL.reset()


def test_deepfm_pipelined_trainer_matches_jax(devices8):
    """The fused ``deepfm`` Trainer on ``a2a+pipelined`` over 2 x 2: its
    losses JAX's pipelined Trainer's at rtol 1e-5 (nothing copied: both
    init from key 0) and the port's ``a2a`` Trainer's bit for bit."""
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01})
    vocab, dim = 64, 4
    batches = None
    runs = {}
    for plane in ("a2a", "a2a+pipelined"):
        tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, vocab, dim,
                                          plane=plane, **kw)
        t = tr.Trainer(tm.build_model("deepfm", criteo.SPARSE_NAMES,
                                      embedding_dim=dim, dnn_units=(16, 8)),
                       EmbeddingCollection(tspecs,
                                           create_mesh(2, 2, device="cpu")),
                       dense.adagrad(0.01))
        batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
            32, num_buckets=vocab, seed=1, num_batches=4)]
        s = t.init(ti.prng_key(0), batches[0])
        losses = []
        for i, b in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            s, m = t.train_step(s, b, next_batch=nxt)
            losses.append(float(m["loss"]))
        runs[plane] = losses
    assert runs["a2a+pipelined"] == runs["a2a"]
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, vocab, dim,
                                plane="a2a+pipelined", **kw)
    jt = JaxTrainer(
        jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                               dnn_units=(16, 8)),
        oe.EmbeddingCollection(jspecs, jax_mesh(2, 2, devices8[:4])),
        optax.adagrad(0.01))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    jl = []
    for i, b in enumerate(batches):
        nxt = batches[i + 1] if i + 1 < len(batches) else None
        js, jm = jt.train_step(js, b, next_batch=nxt)
        jl.append(float(jm["loss"]))
    np.testing.assert_allclose(runs["a2a+pipelined"], jl, rtol=1e-5)


def test_offloaded_variable_rejects_pipelined_plane():
    """Offload inserts rows between steps: a pipelined offloaded variable
    is refused, as in JAX."""
    t = toff.ShardedOffloadedTable(
        "t3", EmbeddingVariableMeta(embedding_dim=4, vocabulary_size=256),
        OPT, INIT, vocab=256, cache_capacity=64, device="cpu")
    spec = dataclasses.replace(t.embedding_spec(), plane="a2a+pipelined")
    coll = EmbeddingCollection((spec,), device="cpu")
    with pytest.raises(ValueError, match="pipelined"):
        tr.Trainer(TinyModel(("t3",), 4), coll, dense.sgd(0.1),
                   offload={"t3": t})
