"""Torch port, elastic ``Trainer.fit(autosave_every=, autosave_dir=,
resume_from=)`` (``tests/test_trainer_elastic.py``'s cases on the port;
the ``ShardStream`` cases come with the data-ingest slice).

A fit stopped after ``INTERRUPT`` batches (autosaving every
``AUTOSAVE``), or killed by a ``ChaosKill`` at ``trainer.fit.step``, and
resumed by a fresh trainer and collection over the same batches ends bit
for bit where the uninterrupted fit ends: the step, every dense
parameter and optimizer state, and every table's rows and slots (a hash
table's keys and failure count too, at a load where no bucket
overflows). The uninterrupted fit's losses agree with the JAX ``fit``'s
at rtol 1e-5 from the same initial state (nothing copied). The same on a
one-process 2 x 2 mesh: a sharded ``fit`` autosaves a full base and then
deltas of its logical rows, and resumes from them bit for bit, on array
tables (``a2a``, ``psum``, ``a2a+pipelined``) and hash tables; its losses
agree with JAX's ``fit`` on JAX's 2 x 2 mesh.
"""

import os

import numpy as np
import pytest
import torch

import jax
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint_delta as cd
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.analysis import chaos
from openembedding_tpu_torch.analysis.retrace import RetraceBudgetExceeded
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim.initializers import prng_key
from openembedding_tpu_torch.parallel import hot_cache
from openembedding_tpu_torch.parallel.mesh import create_mesh as tmesh

FEATURES = ("c0", "c1", "c2")
VOCAB, DIM, B = 48, 4, 8
N_BATCHES, INTERRUPT, AUTOSAVE = 6, 4, 2
UNITS = (16, 8)
OPT = {"category": "adagrad", "learning_rate": 0.1}


def _synthetic_batches(n, seed=0, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        sparse, raw = {}, {}
        for f in FEATURES:
            ids = rng.randint(0, vocab, size=B).astype(np.int32)
            raw[f] = ids
            sparse[f] = ids
            sparse[f + ":linear"] = ids
        label = ((raw["c0"] + raw["c1"]) % 2).astype(np.float32)
        dense_x = rng.randn(B, 4).astype(np.float32)
        out.append({"label": label, "dense": dense_x, "sparse": sparse})
    return out


def _build_trainer(vocab=VOCAB, hash_capacity=None, chunks=8):
    kw = {"hash_capacity": hash_capacity} if hash_capacity else {}
    specs = tm.make_feature_specs(FEATURES, -1 if hash_capacity else vocab,
                                  DIM, **kw)
    coll = EmbeddingCollection(specs, device="cpu", default_optimizer=OPT)
    coll.enable_dirty_tracking(target_chunks=chunks)
    model = tm.build_model("deepfm", FEATURES, embedding_dim=DIM,
                           num_dense=4, dnn_units=UNITS)
    return tr.Trainer(model, coll, dense.adam(1e-2))


class _Recording(tr.Trainer):
    """A trainer whose steps keep their losses."""
    losses: list

    def train_step(self, state, batch):
        state, m = super().train_step(state, batch)
        self.losses.append(float(m["loss"]))
        return state, m


def _fingerprint(state):
    out = [state.step.clone()]
    out += [v.clone() for _, v in sorted(state.params.items())]
    out += [v.clone() for _, v in sorted(state.opt_state.items())]
    for name in sorted(state.emb):
        st = hot_cache.unwrap(state.emb[name])
        out += [st.weights.clone()] + [v.clone() for _, v in
                                       sorted(st.slots.items())]
        if hasattr(st, "keys"):
            out += [st.keys.clone(), st.insert_failures.clone()]
    return out


def _assert_identical(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"leaf {i}"


@pytest.fixture(scope="module")
def world():
    batches = _synthetic_batches(N_BATCHES)
    tr_ = _build_trainer()
    s0 = tr_.init(prng_key(0), batches[0])
    s1, _ = tr_.fit(s0, list(batches))
    return {"batches": batches, "baseline": _fingerprint(s1)}


def test_interrupted_fit_resumes_bit_identical(world, tmp_path):
    ck = str(tmp_path / "auto")
    tr1 = _build_trainer()
    s1 = tr1.init(prng_key(0), world["batches"][0])
    tr1.fit(s1, list(world["batches"][:INTERRUPT]),
            autosave_every=AUTOSAVE, autosave_dir=ck)
    tr2 = _build_trainer()
    s2 = tr2.init(prng_key(0), world["batches"][0])
    s2b, _ = tr2.fit(s2, list(world["batches"]), resume_from=ck,
                     autosave_every=AUTOSAVE, autosave_dir=ck,
                     retrace_budget=0)
    _assert_identical(world["baseline"], _fingerprint(s2b))
    # the resumed state is new: it built its program once, in the warm-up
    assert tr2.builds == 1


def test_resume_from_missing_dir_is_a_fresh_start(world, tmp_path):
    ck = str(tmp_path / "never-written")
    tr_ = _build_trainer()
    s0 = tr_.init(prng_key(0), world["batches"][0])
    s1, _ = tr_.fit(s0, list(world["batches"]), resume_from=ck,
                    autosave_every=0)
    _assert_identical(world["baseline"], _fingerprint(s1))


def test_chaos_kill_mid_fit_then_resume(world, tmp_path):
    ck = str(tmp_path / "auto")
    plan = chaos.FaultPlan([chaos.FaultSpec(point="trainer.fit.step",
                                            action="kill_thread",
                                            hit=INTERRUPT)])
    tr1 = _build_trainer()
    s1 = tr1.init(prng_key(0), world["batches"][0])
    with chaos.active_plan(plan):
        with pytest.raises(chaos.ChaosKill):
            tr1.fit(s1, list(world["batches"]), autosave_every=AUTOSAVE,
                    autosave_dir=ck)
    assert plan.injected, "the kill must actually have fired"
    tr2 = _build_trainer()
    s2 = tr2.init(prng_key(0), world["batches"][0])
    s2b, _ = tr2.fit(s2, list(world["batches"]), resume_from=ck,
                     autosave_every=AUTOSAVE, autosave_dir=ck)
    _assert_identical(world["baseline"], _fingerprint(s2b))


def test_autosave_records_trained_cursor(world, tmp_path):
    ck = str(tmp_path / "auto")
    tr1 = _build_trainer()
    s1 = tr1.init(prng_key(0), world["batches"][0])
    tr1.fit(s1, list(world["batches"][:INTERRUPT]),
            autosave_every=AUTOSAVE, autosave_dir=ck)
    cd.join_compactor(ck)
    manifest = cd.read_manifest(ck)
    verified, _dropped = cd.verify_chain(ck, manifest)
    fit = cd.resume_extra(manifest, verified)["fit"]
    assert fit["cursor"] == INTERRUPT and fit["step"] >= INTERRUPT


def test_torn_tail_resumes_one_autosave_earlier(tmp_path):
    """A torn last delta: the restore lands on the autosave before it (its
    cursor and step, its tables), while the dense state is the newest
    file's, as in JAX (the dense file is rewritten whole at every save,
    outside the chain). Wide tables in small chunks keep each delta far
    under the compaction budget, so the chain stays on disk to be torn."""
    vocab = 1 << 12
    batches = _synthetic_batches(N_BATCHES, seed=5, vocab=vocab)
    runs = {}
    for n in (INTERRUPT - 1, INTERRUPT):
        t = _build_trainer(vocab=vocab, chunks=1024)
        runs[n], _ = t.fit(t.init(prng_key(0), batches[0]), batches[:n])
    ck = str(tmp_path / "auto")
    tr1 = _build_trainer(vocab=vocab, chunks=1024)
    tr1.fit(tr1.init(prng_key(0), batches[0]), list(batches[:INTERRUPT]),
            autosave_every=1, autosave_dir=ck)
    cd.join_compactor(ck)
    manifest = cd.read_manifest(ck)
    assert len(manifest["chain"]) == INTERRUPT - 1
    last = manifest["chain"][-1]
    fp = os.path.join(ck, next(iter(last["vars"].values()))["file"])
    raw = bytearray(open(fp, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(fp, "wb").write(bytes(raw))
    tr2 = _build_trainer(vocab=vocab, chunks=1024)
    s2 = tr2.init(prng_key(0), batches[0])
    with pytest.warns(RuntimeWarning, match="torn"):
        s2, cursor = tr2._restore_fit(s2, ck)
    assert cursor == INTERRUPT - 1 and int(s2.step) == INTERRUPT - 1
    for name, st in s2.emb.items():
        want = runs[INTERRUPT - 1].emb[name]
        assert torch.equal(st.weights, want.weights), name
        assert torch.equal(st.slots["accum"], want.slots["accum"]), name
    for k, v in s2.params.items():
        assert torch.equal(v, runs[INTERRUPT].params[k]), k
    for k, v in s2.opt_state.items():
        assert torch.equal(v, runs[INTERRUPT].opt_state[k]), k


def test_autosaves_keep_the_step_program(world, tmp_path):
    """An autosave only reads the state: with one every step, a fit still
    builds its step program once (``retrace_budget=0`` holds)."""
    tr_ = _build_trainer()
    s0 = tr_.init(prng_key(0), world["batches"][0])
    s1, _ = tr_.fit(s0, list(world["batches"]), autosave_every=1,
                    autosave_dir=str(tmp_path / "auto"), retrace_budget=0)
    assert tr_.builds == 1
    _assert_identical(world["baseline"], _fingerprint(s1))
    # the guard still catches a rebuild: a state swapped mid-loop
    tr2 = _build_trainer()
    s2 = tr2.init(prng_key(0), world["batches"][0])

    def swapped():
        # fit's window fetches pipeline_depth batches ahead of the step:
        # the swap at this fetch lands before the third step, inside the
        # guard
        for i, b in enumerate(list(world["batches"]) * 2):
            if i == 2 + 1 + tr2.pipeline_depth:
                s2.params.update({k: v.clone()
                                  for k, v in s2.params.items()})
            yield b
    with pytest.raises(RetraceBudgetExceeded):
        tr2.fit(s2, swapped(), retrace_budget=0)


def test_hash_fit_resumes_bit_identical(tmp_path):
    """The same on wide-key hash tables from empty: keys arrays, rows,
    slots and failure counts equal slot for slot (the chain is compacted
    in between: the folded base keeps every key's slot)."""
    batches = _synthetic_batches(N_BATCHES, seed=3, vocab=1 << 20)
    tr0 = _build_trainer(hash_capacity=1 << 14)
    s0 = tr0.init(prng_key(0), batches[0])
    base, _ = tr0.fit(s0, list(batches))
    ck = str(tmp_path / "auto")
    tr1 = _build_trainer(hash_capacity=1 << 14)
    s1 = tr1.init(prng_key(0), batches[0])
    tr1.fit(s1, list(batches[:INTERRUPT]), autosave_every=AUTOSAVE,
            autosave_dir=ck)
    cd.join_compactor(ck)
    assert cd.read_manifest(ck)["content_seq"] >= 1   # a fold happened
    tr2 = _build_trainer(hash_capacity=1 << 14)
    s2 = tr2.init(prng_key(0), batches[0])
    s2b, _ = tr2.fit(s2, list(batches), resume_from=ck)
    _assert_identical(_fingerprint(base), _fingerprint(s2b))
    for st in s2b.emb.values():
        assert st.num_used() > 0 and int(st.insert_failures) == 0


def test_losses_match_jax_fit(world, devices8):
    """The uninterrupted fit's per-step losses against the JAX fit's on
    the same batches from ``PRNGKey(0)``, nothing copied."""
    mesh = create_mesh(1, 1, devices8[:1])
    jspecs = jax_models.make_feature_specs(FEATURES, VOCAB, DIM)
    jcoll = JaxCollection(jspecs, mesh, default_optimizer=OPT)
    jlosses = []

    class JRecording(JaxTrainer):
        def train_step(self, state, batch, **kw):
            state, m = super().train_step(state, batch, **kw)
            jlosses.append(float(m["loss"]))
            return state, m
    jt = JRecording(jax_models.build_model("deepfm", FEATURES,
                                           dnn_units=UNITS),
                    jcoll, optax.adam(1e-2))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(world["batches"][0]))
    jt.fit(js, list(world["batches"]))
    port = _build_trainer()
    rec = _Recording(port.module, port.collection, dense.adam(1e-2))
    rec.losses = []
    s = rec.init(prng_key(0), world["batches"][0])
    rec.fit(s, list(world["batches"]))
    np.testing.assert_allclose(rec.losses, jlosses, rtol=1e-5)


# --- on a one-process 2 x 2 mesh ----------------------------------------------

def _build_sharded(plane, hashed, vocab=1 << 12, chunks=1024):
    kw = {"hash_capacity": 1 << 14} if hashed else {}
    specs = tm.make_feature_specs(FEATURES, -1 if hashed else vocab, DIM,
                                  plane=plane, **kw)
    coll = EmbeddingCollection(specs, tmesh(2, 2, device="cpu"),
                               default_optimizer=OPT)
    coll.enable_dirty_tracking(target_chunks=chunks)
    model = tm.build_model("deepfm", FEATURES, embedding_dim=DIM,
                           num_dense=4, dnn_units=UNITS)
    return tr.Trainer(model, coll, dense.adam(1e-2))


@pytest.mark.parametrize("plane,hashed", [
    ("a2a", False), ("psum", False), ("a2a+pipelined", False),
    ("a2a", True)], ids=["a2a", "psum", "a2a+pipelined", "hash-a2a"])
def test_sharded_fit_autosaves_deltas_and_resumes(tmp_path, plane, hashed):
    """A 2 x 2 ``fit`` autosaving every step writes a full base and then a
    delta a step (array tables: a chain of ``INTERRUPT - 1`` entries, each
    well under the base's bytes; hash tables fold into the base as they
    go, as one shard's do); a fresh trainer resumed from it ends bit for
    bit where the uninterrupted fit ends."""
    batches = _synthetic_batches(N_BATCHES, seed=5,
                                 vocab=(1 << 20) if hashed else 1 << 12)
    t0 = _build_sharded(plane, hashed)
    whole, _ = t0.fit(t0.init(prng_key(0), batches[0]), list(batches))
    ck = str(tmp_path / "auto")
    t1 = _build_sharded(plane, hashed)
    t1.fit(t1.init(prng_key(0), batches[0]), list(batches[:INTERRUPT]),
           autosave_every=1, autosave_dir=ck)
    cd.join_compactor(ck)
    manifest = cd.read_manifest(ck)
    assert manifest["last_seq"] == INTERRUPT - 1
    if hashed:
        assert manifest["content_seq"] >= 1 or manifest["chain"]
    else:
        assert len(manifest["chain"]) == INTERRUPT - 1
        base = cd._base_bytes(ck)
        assert all(0 < 10 * e["bytes"] < base for e in manifest["chain"])
    t2 = _build_sharded(plane, hashed)
    resumed, _ = t2.fit(t2.init(prng_key(0), batches[0]), list(batches),
                        resume_from=ck)
    _assert_identical(_fingerprint(whole), _fingerprint(resumed))


@pytest.mark.parametrize("plane", ["a2a", "psum"])
def test_sharded_losses_match_jax_fit(devices8, plane):
    """The 2 x 2 fit's per-step losses against JAX's fit on JAX's 2 x 2
    mesh, both from ``PRNGKey(0)``, nothing copied."""
    batches = _synthetic_batches(N_BATCHES, seed=5, vocab=1 << 12)
    jspecs = jax_models.make_feature_specs(FEATURES, 1 << 12, DIM,
                                           plane=plane)
    jcoll = JaxCollection(jspecs, create_mesh(2, 2, devices8[:4]),
                          default_optimizer=OPT)
    jlosses = []

    class JRecording(JaxTrainer):
        def train_step(self, state, batch, **kw):
            state, m = super().train_step(state, batch, **kw)
            jlosses.append(float(m["loss"]))
            return state, m
    jt = JRecording(jax_models.build_model("deepfm", FEATURES,
                                           dnn_units=UNITS),
                    jcoll, optax.adam(1e-2))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    jt.fit(js, list(batches))
    port = _build_sharded(plane, False)
    rec = _Recording(port.module, port.collection, dense.adam(1e-2))
    rec.losses = []
    rec.fit(rec.init(prng_key(0), batches[0]), list(batches))
    np.testing.assert_allclose(rec.losses, jlosses, rtol=1e-5)
