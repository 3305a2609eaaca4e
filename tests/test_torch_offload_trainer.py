"""Torch port, the ``Trainer``'s offload lane against the JAX package's:
``Trainer(offload=, pipeline_depth=)``, ``train_step(next_batch=)``,
``prefetch``, ``prepare_offload`` and ``fit(persist_dir=)`` over
``ShardedOffloadedTable`` s at one shard (JAX's on a one-device mesh, the
port's on ``device="cpu"``), on the cases of ``tests/test_offload.py``'s
``TestShardedOffload`` and ``TestPipelinedOffload`` and the pipeline
tests after them, plus cross-package trajectories.

Tolerances: losses at rtol 1e-5 against JAX (float32 sums in another
order); cache keys arrays, host stores and work ids bit for bit where the
optimizer is exact (constant init, SGD dense, the same Adagrad update
order); serial against pipelined, packed against unpacked, hand-driven
against ``fit``: bit for bit within the port.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import optax

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import EmbeddingSpec as JaxSpec
from openembedding_tpu import EmbeddingVariableMeta as JaxMeta
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu import offload as joff
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import offload as toff
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.embedding import EmbeddingCollection, \
    EmbeddingSpec
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim.initializers import prng_key
from openembedding_tpu_torch.parallel.mesh import create_mesh as tmesh

ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}
QUARTER = {"category": "constant", "value": 0.25}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the (data, model) mesh of both packages' tables: one shard here;
# tests/test_torch_offload_sharded.py runs the TestPipelinedOffload cases
# again on JAX's 2 x 4
GRID = (1, 1)


def _mesh():
    return create_mesh(*GRID, jax.devices()[:GRID[0] * GRID[1]])


def _port_where():
    """The port's placement: one device, or the one-process mesh of
    ``GRID``."""
    if GRID == (1, 1):
        return {"device": "cpu"}
    return {"mesh": tmesh(*GRID, device="cpu")}


def _tables(pkg, vocab, cache, names=("off", "off:linear"), **kw):
    out = {}
    for name in names:
        dim = 1 if name.endswith(":linear") else 4
        if pkg == "jax":
            out[name] = joff.ShardedOffloadedTable(
                name, JaxMeta(embedding_dim=dim, vocabulary_size=vocab),
                ADAGRAD, QUARTER, vocab=vocab, cache_capacity=cache,
                mesh=_mesh(), **kw)
        else:
            out[name] = toff.ShardedOffloadedTable(
                name, EmbeddingVariableMeta(embedding_dim=dim,
                                            vocabulary_size=vocab),
                ADAGRAD, QUARTER, vocab=vocab, cache_capacity=cache,
                **kw, **_port_where())
    return out


def lr_trainer(pkg, vocab=2048, cache=256, depth=2,
               names=("off", "off:linear"), **kw):
    """TestPipelinedOffload's trainer: LR over offloaded ``off`` and
    ``off:linear`` (adagrad, constant 0.25), dense SGD 0.1."""
    tabs = _tables(pkg, vocab, cache, names, persist_pending_window=2, **kw)
    specs = tuple(t.embedding_spec() for t in tabs.values())
    if pkg == "jax":
        trainer = JaxTrainer(
            jax_models.LogisticRegression(feature_names=("off",)),
            JaxCollection(specs, _mesh()), optax.sgd(0.1), offload=tabs,
            pipeline_depth=depth)
    else:
        trainer = tr.Trainer(
            tm.LogisticRegression(feature_names=("off",)),
            EmbeddingCollection(specs, **_port_where()), dense.sgd(0.1),
            offload=tabs, pipeline_depth=depth)
    return trainer, tabs


def lr_batches(n, vocab=2048, seed=0, names=("off", "off:linear")):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        lo = (i * 300) % (vocab - 400)
        ids = rng.randint(lo, lo + 400, 64).astype(np.int32)
        out.append({"label": (ids % 2).astype(np.float32), "dense": None,
                    "sparse": {k: ids for k in names}})
    return out


def init(pkg, trainer, batch):
    if pkg == "jax":
        return trainer.init(jax.random.PRNGKey(0), trainer.shard_batch(batch))
    return trainer.init(prng_key(0), batch)


def flushed(tabs, state):
    for name, t in tabs.items():
        t.flush(state.emb[name])
        t._join_writeback()
    return tabs


def assert_stores_equal(a, b, work_ids=True):
    """Host stores equal; ``work_ids``: the rows' stamps too (a run that
    persisted mid-way stamped its rows at its flushes)."""
    for name in a:
        np.testing.assert_array_equal(a[name].host_weights,
                                      b[name].host_weights)
        for k in a[name].host_slots:
            np.testing.assert_array_equal(a[name].host_slots[k],
                                          b[name].host_slots[k])
        if work_ids:
            np.testing.assert_array_equal(a[name].host_work_id,
                                          b[name].host_work_id)
        assert a[name].work_id == b[name].work_id


def keys_of(state, name):
    k = state.emb[name].keys
    return k.numpy() if isinstance(k, torch.Tensor) else np.asarray(k)


# --- cross-package trajectories -----------------------------------------------

@pytest.mark.parametrize("depth", [1, 4])
def test_fit_trajectory_matches_jax_with_evictions(depth):
    """8 steps of ``fit`` through a 256-row cache (evictions inside the
    run): per-step losses at rtol 1e-5, cache keys arrays and init keys
    bit-identical after every step, host stores and work ids equal."""
    batches = lr_batches(8)
    runs = {}
    for pkg in ("jax", "port"):
        trainer, tabs = lr_trainer(pkg, depth=depth)
        state = init(pkg, trainer, batches[0])
        losses = []
        state, _ = trainer.fit(state, batches, log_every=1,
                               log_fn=lambda s: losses.append(
                                   float(s.split("=")[1])))
        runs[pkg] = (trainer, tabs, state, losses)
    (_, jtabs, js, jl), (_, ttabs, ts, tl) = runs["jax"], runs["port"]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ttabs["off"].evictions == jtabs["off"].evictions > 0
    for name in ttabs:
        np.testing.assert_array_equal(keys_of(ts, name), keys_of(js, name))
        np.testing.assert_array_equal(
            interop.hash_state_to_numpy(ts.emb[name])[3],
            np.asarray(js.emb[name].init_rng))
    assert_stores_equal(flushed(ttabs, ts), flushed(jtabs, js))


def _deepfm_pair(vocab, cache):
    """A DeepFM over an offloaded ``uid`` (dim 4, with its linear twin)
    and an array ``ctx``, bench.py's offload model in small: JAX's and the
    port's, the port's dense state copied from JAX's init."""
    out = {}
    for pkg in ("jax", "port"):
        tabs = _tables(pkg, vocab, cache, ("uid", "uid:linear"))
        opt = {"category": "adagrad", "learning_rate": 0.01}
        ctx = [dict(name="ctx", input_dim=100, output_dim=4, optimizer=opt),
               dict(name="ctx:linear", input_dim=100, output_dim=1,
                    optimizer=opt)]
        if pkg == "jax":
            coll = JaxCollection(tuple(t.embedding_spec()
                                       for t in tabs.values())
                                 + tuple(JaxSpec(**c) for c in ctx), _mesh())
            trainer = JaxTrainer(jax_models.build_model(
                "deepfm", ("uid", "ctx"), dnn_units=(16, 8)), coll,
                optax.adagrad(0.01), offload=tabs)
        else:
            coll = EmbeddingCollection(
                tuple(t.embedding_spec() for t in tabs.values())
                + tuple(EmbeddingSpec(**c) for c in ctx), device="cpu")
            trainer = tr.Trainer(tm.build_model(
                "deepfm", ("uid", "ctx"), embedding_dim=4,
                dnn_units=(16, 8)), coll, dense.adagrad(0.01),
                offload=tabs)
        out[pkg] = (trainer, tabs)
    return out


def _zipf_batches(n, vocab, batch=64, seed=0):
    """bench.py's ``_zipf_uid_batch_maker`` stream, small."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        z = rng.zipf(1.08, size=batch)
        uid = ((z * 2654435761) % vocab).astype(np.int32)
        ctx = rng.randint(0, 100, batch).astype(np.int32)
        out.append({"label": (rng.rand(batch) > 0.75).astype(np.float32),
                    "dense": rng.randn(batch, 13).astype(np.float32),
                    "sparse": {"uid": uid, "uid:linear": uid, "ctx": ctx,
                               "ctx:linear": ctx}})
    return out


def test_deepfm_offload_steps_match_jax():
    """5 hand-driven steps of the offload benchmark's model (zipf uids,
    a 128-row cache that evicts), prefetched as bench.py drives them:
    losses at rtol 1e-5, keys bit-identical, host stores equal."""
    vocab = 5000
    batches = _zipf_batches(5, vocab)
    pair = _deepfm_pair(vocab, cache=128)
    (jtr, jtabs), (ttr, ttabs) = pair["jax"], pair["port"]
    js = jtr.init(jax.random.PRNGKey(0), jtr.shard_batch(batches[0]))
    ts = ttr.init(prng_key(0), batches[0])
    ts.params = interop.dense_params_from_flax(ttr.module, js.params, "cpu")
    ts.opt_state = interop.dense_state_from_optax(ttr.module, js.opt_state,
                                                  "cpu")
    for i, b in enumerate(batches):
        jtr.prefetch(batches[i:i + 5])
        ttr.prefetch(batches[i:i + 5])
        js, jm = jtr.train_step(js, b)
        ts, tmx = ttr.train_step(ts, b)
        np.testing.assert_allclose(float(tmx["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for name in ttabs:
            np.testing.assert_array_equal(keys_of(ts, name),
                                          keys_of(js, name))
    assert ttabs["uid"].evictions == jtabs["uid"].evictions > 0
    for t in list(jtabs.values()) + list(ttabs.values()):
        t.finish()
    flushed(jtabs, js)
    flushed(ttabs, ts)
    for name in ttabs:
        np.testing.assert_allclose(ttabs[name].host_weights,
                                   jtabs[name].host_weights,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(ttabs[name].host_work_id,
                                      jtabs[name].host_work_id)


# --- TestShardedOffload / TestPipelinedOffload on the port ------------------

def test_trainer_integration():
    """An offloaded variable trains through ``train_step`` and evals after
    ``prepare_offload``."""
    trainer, tabs = lr_trainer("port", vocab=4096, cache=256)
    rng = np.random.RandomState(0)

    def batch():
        ids = rng.randint(0, 4096, 32).astype(np.int32)
        return {"label": (ids % 2).astype(np.float32), "dense": None,
                "sparse": {"off": ids, "off:linear": ids}}

    state = trainer.init(prng_key(0), batch())
    for _ in range(3):
        state, m = trainer.train_step(state, batch())
        assert np.isfinite(float(m["loss"]))
    assert tabs["off"].work_id > 1
    b = batch()
    state = trainer.prepare_offload(state, b)
    assert trainer.eval_step(state, b).shape == (32,)


def test_packed_insert_matches_unpacked_fallback():
    """The one-transfer packed insert lands the same keys, rows and slots
    as the per-array path."""
    batches = lr_batches(6)
    out = []
    for packed in (True, False):
        trainer, tabs = lr_trainer("port", cache=4096)
        assert tabs["off"]._packed_layout(np.dtype(np.int32)) is not None
        if not packed:
            for t in tabs.values():
                t._packed_layout = lambda *_a, **_k: None
        s = trainer.init(prng_key(0), batches[0])
        for b in batches:
            s, m = trainer.train_step(s, b)
        out.append((s, float(m["loss"])))
    (a, la), (b_, lb) = out
    assert la == lb
    for name in a.emb:
        for x, y in zip(interop.hash_state_to_numpy(a.emb[name]),
                        interop.hash_state_to_numpy(b_.emb[name])):
            if isinstance(x, dict):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
            else:
                np.testing.assert_array_equal(x, y)


def test_steady_state_makes_no_per_step_device_reads(monkeypatch):
    """Between join points no step reads a tensor back to the host: no
    ``item``, ``int``, ``float`` or ``tolist`` of a tensor, no overflow
    check. The plain init-rows version reads the cache's key words
    (``base_words``; on the card the kernel takes their address), so that
    one caller is allowed. (On the card the same loop runs under
    ``torch.cuda.set_sync_debug_mode("error")``.)"""
    trainer, tabs = lr_trainer("port", cache=4096)
    batches = lr_batches(10)
    state = trainer.init(prng_key(0), batches[0])
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b)
    reads = []
    for meth in ("item", "__int__", "__float__", "tolist"):
        orig = getattr(torch.Tensor, meth)

        def counting(self, *a, _orig=orig, _m=meth, **k):
            if sys._getframe(1).f_code.co_name != "base_words":
                reads.append(_m)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counting)
    checks = []
    monkeypatch.setattr(toff.ShardedOffloadedTable, "check_overflow",
                        lambda self, cache=None: checks.append(self.name))
    for i, b in enumerate(batches[2:]):
        nxt = batches[3 + i] if 3 + i < len(batches) else None
        state, _ = trainer.train_step(state, b, next_batch=nxt)
    monkeypatch.undo()
    assert reads == [] and checks == [], (reads, checks)
    assert tabs["off"].evictions == 0
    tabs["off"].flush(state.emb["off"])
    for t in tabs.values():
        t.finish()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipelined_fit_matches_serial_steps(tmp_path, depth):
    """``fit`` with the lookahead and background persists equals explicit
    serial steps bit for bit at every depth, and the persisted chain
    restores."""
    batches = lr_batches(8)
    t_ser, tab_ser = lr_trainer("port", depth=depth)
    s_ser = t_ser.init(prng_key(0), batches[0])
    for b in batches:
        s_ser, m_ser = t_ser.train_step(s_ser, b)
    t_pipe, tab_pipe = lr_trainer("port", depth=depth)
    s_pipe = t_pipe.init(prng_key(0), batches[0])
    s_pipe, m_pipe = t_pipe.fit(s_pipe, batches,
                                persist_dir=str(tmp_path / "p"))
    assert float(m_ser["loss"]) == float(m_pipe["loss"])
    assert_stores_equal(flushed(tab_ser, s_ser), flushed(tab_pipe, s_pipe),
                        work_ids=False)
    _, tab_r = lr_trainer("port")
    c = tab_r["off"].restore(str(tmp_path / "p" / "off"))
    assert tab_r["off"].persisted_work > 0
    assert c.keys.shape[0] == tab_r["off"].cache_capacity


@pytest.mark.parametrize("depth", [2, 4])
def test_pipeline_survives_eviction_batches(depth):
    """Lookahead batches that overflow the cache take the eviction path
    mid-pipeline (the in-flight prepares recomputed at the new
    generation), equal to a cache that never evicts; one step program
    for the whole run (evictions rebuild the cache in place)."""
    batches = lr_batches(10, seed=5)
    t_small, tab_small = lr_trainer("port", cache=256, depth=depth)
    s = t_small.init(prng_key(0), batches[0])
    s, _ = t_small.fit(s, batches, retrace_budget=0)
    assert tab_small["off"]._gen > 0 and t_small.builds == 1
    t_big, tab_big = lr_trainer("port", cache=2048)
    s2 = t_big.init(prng_key(0), batches[0])
    s2, _ = t_big.fit(s2, batches)
    assert tab_big["off"].evictions == 0
    np.testing.assert_allclose(flushed(tab_small, s)["off"].host_weights,
                               flushed(tab_big, s2)["off"].host_weights,
                               rtol=1e-5, atol=1e-6)


def test_hand_driven_prefetch_matches_fit():
    """``prefetch(window); train_step(batch)`` is the pipeline ``fit``
    wires: bit-identical."""
    batches = lr_batches(8, seed=9)
    t_fit, tab_fit = lr_trainer("port", depth=2)
    s = t_fit.init(prng_key(0), batches[0])
    s, _ = t_fit.fit(s, batches)
    t_hand, tab_hand = lr_trainer("port", depth=2)
    s2 = t_hand.init(prng_key(0), batches[0])
    for i in range(len(batches)):
        t_hand.prefetch(batches[i:i + 3])
        s2, _ = t_hand.train_step(s2, batches[i])
    for t in tab_hand.values():
        t.finish()
    assert_stores_equal(flushed(tab_fit, s), flushed(tab_hand, s2))


def test_pipeline_parity_under_timing_fuzz():
    """Random host-gather delays shift every prepare / apply / evict
    interleaving at depth 4; results stay bit-identical to serial."""
    batches = lr_batches(12, seed=13)
    t_ser, tab_ser = lr_trainer("port", cache=256)
    s = t_ser.init(prng_key(0), batches[0])
    for b in batches:
        s, _ = t_ser.train_step(s, b)
    fuzz = np.random.RandomState(99)
    t_f, tab_f = lr_trainer("port", cache=256, depth=4)
    for t in tab_f.values():
        def jittery(ids, _orig=t._gather_host):
            time.sleep(float(fuzz.uniform(0, 0.03)))
            return _orig(ids)
        t._gather_host = jittery
    s2 = t_f.init(prng_key(0), batches[0])
    s2, _ = t_f.fit(s2, batches)
    assert tab_f["off"].evictions > 0
    assert_stores_equal(flushed(tab_ser, s), flushed(tab_f, s2))


def test_offload_refusals():
    """As in JAX: an offloaded name outside the collection, and
    ``autosave_every`` / ``resume_from`` with offload, raise
    ``ValueError``; an offloaded variable over a mesh across processes
    raises, giving the reference's reason; no other offload argument is
    left unported."""
    trainer, tabs = lr_trainer("port")
    with pytest.raises(ValueError, match="not in the collection"):
        tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                   trainer.collection, dense.sgd(0.1),
                   offload={"nope": tabs["off"]})
    state = trainer.init(prng_key(0), lr_batches(1)[0])
    with pytest.raises(ValueError, match="persist_dir"):
        trainer.fit(state, lr_batches(1), autosave_every=1,
                    autosave_dir="unused")
    with pytest.raises(ValueError, match="persist lane"):
        trainer.fit(state, lr_batches(1), resume_from="unused")
    assert tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                      trainer.collection, dense.sgd(0.1)).pipeline_depth == 4
    from openembedding_tpu_torch.parallel.mesh import Mesh
    spanning = Mesh(["cpu"] * 4, 2, 2, process_count=2, process_index=0)
    with pytest.raises(NotImplementedError,
                       match="reference cannot run an offloaded table"):
        tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                   EmbeddingCollection(
                       (tabs["off"].embedding_spec(),), spanning),
                   dense.sgd(0.1), offload={"off": tabs["off"]})


_PIPELINE_KILL_CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.offload import ShardedOffloadedTable
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim.initializers import prng_key

table = ShardedOffloadedTable(
    "off", EmbeddingVariableMeta(embedding_dim=1, vocabulary_size=2048),
    {{"category": "adagrad", "learning_rate": 0.1}},
    {{"category": "constant", "value": 0.25}},
    vocab=2048, cache_capacity=256, device="cpu", persist_pending_window=2)
coll = EmbeddingCollection((table.embedding_spec(name="off:linear"),),
                           device="cpu")
trainer = tr.Trainer(tm.LogisticRegression(feature_names=("off",)), coll,
                     dense.sgd(0.1), offload={{"off:linear": table}},
                     pipeline_depth=3)
rng = np.random.RandomState(11)
batches = []
for i in range(40):
    lo = (i * 300) % 1600
    ids = rng.randint(lo, lo + 400, 64).astype(np.int32)
    batches.append({{"label": (ids % 2).astype(np.float32), "dense": None,
                   "sparse": {{"off:linear": ids}}}})
state = trainer.init(prng_key(0), batches[0])
def slow_log(line):
    print(line, flush=True)
    import time; time.sleep(0.05)
trainer.fit(state, batches, log_every=1, log_fn=slow_log,
            persist_dir={pdir!r})
print("FINISHED", flush=True)
"""


def test_kill_mid_pipelined_fit_resume_exact(tmp_path):
    """A port child SIGKILLed mid-``fit`` (depth-3 lookahead, writebacks,
    background persists in flight): its committed chain sits at a batch
    boundary, and a fresh trainer resumed from it lands bit-identical to
    an uninterrupted serial run."""
    pdir = str(tmp_path / "p")
    code = _PIPELINE_KILL_CHILD.format(root=REPO, pdir=pdir)
    proc = subprocess.Popen([sys.executable, "-u", "-c", code],
                            stdout=subprocess.PIPE, text=True)
    killed = False
    for line in proc.stdout:
        if line.startswith("step 15:"):
            proc.send_signal(signal.SIGKILL)
            killed = True
            break
        assert not line.startswith("FINISHED"), "child outran the kill"
    assert killed, "child died before step 15"
    assert proc.wait() == -9, "child was not killed mid-run"
    proc.stdout.close()

    names = ("off:linear",)

    def parts(depth):
        tabs = {"off:linear": toff.ShardedOffloadedTable(
            "off", EmbeddingVariableMeta(embedding_dim=1,
                                         vocabulary_size=2048),
            ADAGRAD, QUARTER, vocab=2048, cache_capacity=256, device="cpu",
            persist_pending_window=2)}
        coll = EmbeddingCollection(
            (tabs["off:linear"].embedding_spec(name="off:linear"),),
            device="cpu")
        return tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                          coll, dense.sgd(0.1), offload=tabs,
                          pipeline_depth=depth), tabs["off:linear"]

    rng = np.random.RandomState(11)
    batches = []
    for i in range(40):
        lo = (i * 300) % 1600
        ids = rng.randint(lo, lo + 400, 64).astype(np.int32)
        batches.append({"label": (ids % 2).astype(np.float32),
                        "dense": None, "sparse": {k: ids for k in names}})
    t_ref, tab_ref = parts(1)
    s_ref = t_ref.init(prng_key(0), batches[0])
    snaps = {}
    for b in batches:
        s_ref, _ = t_ref.train_step(s_ref, b)
        tab_ref.flush(s_ref.emb["off:linear"])
        tab_ref._join_writeback()
        snaps[tab_ref.work_id] = (
            tab_ref.host_weights.copy(),
            {k: v.copy() for k, v in tab_ref.host_slots.items()},
            {k: v.clone() for k, v in s_ref.params.items()})
    t_res, tab_res = parts(3)
    s2 = t_res.init(prng_key(0), batches[0])
    s2.emb["off:linear"] = tab_res.restore(os.path.join(pdir, "off:linear"),
                                           s2.emb["off:linear"])
    w = tab_res.persisted_work
    assert w in snaps and 3 <= w <= 20, f"watermark {w}"
    ref_weights, ref_slots, ref_params = snaps[w]
    np.testing.assert_array_equal(tab_res.host_weights, ref_weights)
    for k in ref_slots:
        np.testing.assert_array_equal(tab_res.host_slots[k], ref_slots[k])
    for k, v in ref_params.items():
        s2.params[k].copy_(v)
    s2, _ = t_res.fit(s2, batches[w - 1:])
    tab_res.flush(s2.emb["off:linear"])
    tab_res._join_writeback()
    np.testing.assert_array_equal(tab_res.host_weights, tab_ref.host_weights)
    for k in tab_ref.host_slots:
        np.testing.assert_array_equal(tab_res.host_slots[k],
                                      tab_ref.host_slots[k])
