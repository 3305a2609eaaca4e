"""Torch port, ``analysis/retrace.py`` and the ``Trainer``'s step programs
on the CPU.

The guard's semantics as ``tests/test_retrace.py`` holds the JAX one's
(the budget, warn against raise, nesting, not reentrant, the original
exception kept), counting step-program builds instead of XLA
compilations; ``fit(retrace_budget=)`` against the JAX ``fit`` in the same
test (a fixed-shape loop passes a zero budget, a wobbling one raises);
and the program cache: the same state and shapes build nothing, a
``copy_state`` or a new column set builds a program, and ``train_step``
and ``train_step_eager`` give the same trajectory.
"""

import numpy as np
import pytest
import torch

import jax
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.analysis import retrace as jax_retrace
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.analysis import retrace
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti


def test_guard_counts_builds_and_trips_on_budget():
    with pytest.raises(retrace.RetraceBudgetExceeded, match="budget 0"):
        with retrace.RetraceGuard(budget=0, name="wobble") as guard:
            for _ in range(3):
                retrace.note_build()
    assert guard.compiles == 3 and guard.exceeded
    with retrace.RetraceGuard(budget=2) as guard:
        retrace.note_build()
        retrace.note_build()
    assert guard.compiles == 2 and not guard.exceeded
    with retrace.RetraceGuard(budget=0) as guard:
        pass                                # nothing built: stays quiet
    assert guard.compiles == 0
    retrace.note_build()                    # no guard open: counted nowhere


def test_guard_warn_mode_and_properties():
    with pytest.warns(RuntimeWarning, match="retrace budget"):
        with retrace.RetraceGuard(budget=0, on_exceed="warn") as guard:
            retrace.note_build()
    assert guard.compiles == 1 and guard.exceeded
    with pytest.raises(ValueError, match="on_exceed"):
        retrace.RetraceGuard(on_exceed="explode")


def test_guard_nests_and_is_not_reentrant():
    with retrace.RetraceGuard(budget=5) as outer:
        retrace.note_build()
        with retrace.RetraceGuard(budget=5) as inner:
            retrace.note_build()
            with pytest.raises(RuntimeError, match="not reentrant"):
                inner.__enter__()
        retrace.note_build()
    assert (outer.compiles, inner.compiles) == (3, 1)


def test_guard_does_not_mask_inner_error():
    with pytest.raises(KeyError):
        with retrace.RetraceGuard(budget=0):
            retrace.note_build()
            raise KeyError("the original error is the story")


def _port_fit(batch_sizes, budget):
    specs = tm.make_feature_specs(("f",), 64, 4)
    coll = EmbeddingCollection(
        specs, device="cpu",
        default_optimizer={"category": "sgd", "learning_rate": 0.1})
    trainer = tr.Trainer(tm.LogisticRegression(feature_names=("f",),
                                               num_dense=0),
                         coll, dense.sgd(1e-2))
    batches = list(_lr_batches(batch_sizes))
    state = trainer.init(ti.prng_key(0), batches[0])
    return trainer.fit(state, batches, retrace_budget=budget)


def _jax_fit(devices8, batch_sizes, budget):
    specs = jax_models.make_feature_specs(("f",), 64, 4)
    coll = JaxCollection(
        specs, create_mesh(1, 1, devices8[:1]),
        default_optimizer={"category": "sgd", "learning_rate": 0.1})
    trainer = JaxTrainer(
        jax_models.LogisticRegression(feature_names=("f",)), coll,
        optax.sgd(1e-2))
    batches = list(_lr_batches(batch_sizes))
    state = trainer.init(jax.random.PRNGKey(0),
                         trainer.shard_batch(batches[0]))
    return trainer.fit(state, batches, retrace_budget=budget)


def _lr_batches(batch_sizes):
    rng = np.random.RandomState(0)
    for b in batch_sizes:
        ids = rng.randint(0, 64, b).astype(np.int32)
        yield {"label": (ids % 2).astype(np.float32), "dense": None,
               "sparse": {"f": ids, "f:linear": ids}}


@pytest.mark.parametrize("sizes,trips", [([16] * 6, False),
                                         ([16, 16, 24, 32], True)],
                         ids=["fixed", "wobble"])
def test_fit_retrace_budget_wiring_matches_jax(devices8, sizes, trips):
    """``fit(retrace_budget=0)``: a fixed-shape loop passes, a loop whose
    batch size changes after the two-step warm-up raises, in the port and
    in the JAX package alike."""
    for fit in (lambda: _port_fit(sizes, 0),
                lambda: _jax_fit(devices8, sizes, 0)):
        if trips:
            with pytest.raises((retrace.RetraceBudgetExceeded,
                                jax_retrace.RetraceBudgetExceeded)):
                fit()
        else:
            state, metrics = fit()
            assert metrics is not None
    # the port's two trips: one build each for sizes 24 and 32
    if trips:
        with pytest.raises(retrace.RetraceBudgetExceeded,
                           match=r": 2 step-program build\(s\) > budget 0"):
            _port_fit(sizes, 0)
        state, _ = _port_fit(sizes, 2)
        assert int(state.step) == len(sizes)


def _tiny_trainer():
    specs, mapper = make_fused_specs(
        criteo.SPARSE_NAMES, 64, 4,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=4,
                            num_dense=criteo.NUM_DENSE, dnn_units=(16, 8))
    trainer = tr.Trainer(module, EmbeddingCollection(specs, device="cpu"),
                         dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        32, num_buckets=64, seed=0, num_batches=4)]
    return trainer, batches


def test_program_cache_keys_on_batch_and_state():
    """The same state and shapes build nothing; ``copy_state`` (new
    tensors), a batch without ``dense``, a new column set and a new batch
    size each build one program; every state keeps stepping in place."""
    specs = tm.make_feature_specs(("f", "g"), 64, 4)
    trainer = tr.Trainer(
        tm.LogisticRegression(feature_names=("f", "g"), num_dense=13),
        EmbeddingCollection(specs, device="cpu"), dense.sgd(1e-2))
    rng = np.random.RandomState(0)

    def batch(b, with_dense=True, cols=("f", "g")):
        # LR reads the ``:linear`` columns; the dim-4 ones ride along
        ids = rng.randint(0, 64, b).astype(np.int32)
        return {"label": (ids % 2).astype(np.float32),
                "dense": rng.randn(b, 13).astype(np.float32)
                if with_dense else None,
                "sparse": {**{c: ids for c in cols},
                           "f:linear": ids, "g:linear": ids}}
    state = trainer.init(ti.prng_key(0), batch(16))
    with retrace.RetraceGuard(budget=100) as guard:
        for _ in range(4):
            state, _ = trainer.train_step(state, batch(16))
    assert guard.compiles == 1 and trainer.builds == 1
    copy = tr.copy_state(state, "cpu")
    with retrace.RetraceGuard(budget=100) as guard:
        copy, _ = trainer.train_step(copy, batch(16))
        state, _ = trainer.train_step(state, batch(16))
        assert guard.compiles == 1
        state, _ = trainer.train_step(state, batch(16, with_dense=False))
        state, _ = trainer.train_step(state, batch(16, cols=("f",)))
        state, _ = trainer.train_step(state, batch(8))
        state, _ = trainer.train_step(state, batch(16, cols=("f",)))
    assert guard.compiles == 4 and trainer.builds == 5
    assert int(state.step) == 9 and int(copy.step) == 5
    # a program whose state is gone is stale: the next build drops it, and
    # a new state never replays it, whatever addresses it lands on
    assert len(trainer.programs) == 5
    del copy
    state, _ = trainer.train_step(tr.copy_state(state, "cpu"), batch(16))
    assert trainer.builds == 6 and len(trainer.programs) == 5


def test_train_step_and_eager_step_agree():
    """``train_step`` (the cached program) and ``train_step_eager`` take
    the same trajectory from copies of one state."""
    trainer, batches = _tiny_trainer()
    state = trainer.init(ti.prng_key(0), batches[0])
    eager = tr.copy_state(state, "cpu")
    for b in batches + batches:
        state, m = trainer.train_step(state, b)
        eager, me = trainer.train_step_eager(eager, b)
        assert torch.equal(m["loss"], me["loss"])
    for k, v in state.params.items():
        assert torch.equal(v, eager.params[k])
    for n, s in state.emb.items():
        assert torch.equal(s.weights, eager.emb[n].weights)
        assert torch.equal(s.slots["accum"], eager.emb[n].slots["accum"])
    assert int(state.step) == int(eager.step) == 8
    assert trainer.builds == 1
