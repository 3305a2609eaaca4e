"""Torch port, the hot-row replica plane (``parallel/hot_cache.py``)
against the JAX package's on 2 x 2 meshes (``tests/test_hot_cache.py``'s
cases).

The cached plane against the port's ``a2a`` and against JAX's cached
plane on the same streams and refresh cadence (constant init, so both
start equal): pulled rows and tables at the JAX tests' tolerance (rtol
1e-5, atol 1e-6; the replica's sum over senders adds in its own order),
the admitted keys exactly, the counters (hits, misses, bytes saved)
exactly. The host sketch equals JAX's on the same key streams; the
lookup partition, admission, checkpoints, the Trainer's wiring and
``export_dense`` as in JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel import hot_cache as jhot
from openembedding_tpu.parallel import sharded_hash as jsh
from openembedding_tpu.parallel import sharded_table as jst
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import hash_table as tht
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.optim.optimizers import make_optimizer
from openembedding_tpu_torch.parallel import hot_cache as hot
from openembedding_tpu_torch.parallel import sharded_hash as sh
from openembedding_tpu_torch.parallel import sharded_table as st
from openembedding_tpu_torch.parallel.mesh import create_mesh
from openembedding_tpu_torch.utils import observability as obs

VOCAB, DIM, B, K = 64, 4, 16, 16
OPT = {"category": "adagrad", "learning_rate": 0.1}
INIT = {"category": "constant", "value": 0.25}
TOL = dict(rtol=1e-5, atol=1e-6)


def _streams(rng, n):
    zipf = np.minimum(rng.zipf(1.3, size=(n, B)) - 1, VOCAB - 1)
    uni = rng.randint(0, VOCAB, size=(n, B))
    return zipf.astype(np.int32), uni.astype(np.int32)


def _np(x):
    return np.asarray(jax.device_get(x))


def _meshes(devices8):
    return jax_mesh(2, 2, devices8[:4]), create_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("layout", ["mod", "div"])
@pytest.mark.parametrize("stream", ["zipf", "uniform"])
def test_array_cached_plane_matches_a2a_and_jax(devices8, layout, stream):
    """8 steps across refreshes every 3: the cached plane's rows and
    table against the port's ``a2a`` and JAX's cached plane; the same
    keys admitted; the replica mirrors the rows it covers."""
    jmesh, tmesh = _meshes(devices8)
    jmeta = oe.EmbeddingVariableMeta(embedding_dim=DIM,
                                     vocabulary_size=VOCAB)
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=VOCAB)
    jopt, opt = oe.make_optimizer(OPT), make_optimizer(OPT)
    jspec = jst.make_sharding_spec(jmeta, jmesh, layout=layout,
                                   plane="a2a+cache", cache_k=K)
    spec_a = st.make_sharding_spec(meta, tmesh, layout=layout, plane="a2a")
    spec_c = st.make_sharding_spec(meta, tmesh, layout=layout,
                                   plane="a2a+cache", cache_k=K)
    js = jst.create_sharded_table(jmeta, jopt, INIT, mesh=jmesh, spec=jspec)
    sa = st.create_sharded_table(meta, opt, INIT, mesh=tmesh, spec=spec_a)
    sc = st.create_sharded_table(meta, opt, INIT, mesh=tmesh, spec=spec_c)
    assert isinstance(sc, hot.CachedState)
    rng = np.random.RandomState(0)
    zipf, uni = _streams(rng, 8)
    ids = zipf if stream == "zipf" else uni
    grads = rng.randn(8, B, DIM).astype(np.float32)
    jmgr = jhot.HotCacheManager(mesh=jmesh, spec=jspec, k=K,
                                refresh_every=3)
    mgr = hot.HotCacheManager(spec=spec_c, k=K, refresh_every=3)
    buffers = (sc.cache.keys.data_ptr(), sc.cache.rows.data_ptr())
    for s in range(8):
        idx, g = torch.from_numpy(ids[s]), torch.from_numpy(grads[s])
        ra = st.pull_sharded(sa, idx, mesh=tmesh, spec=spec_a)
        rc = st.pull_sharded(sc, idx, mesh=tmesh, spec=spec_c)
        rj = jst.pull_sharded(js, jnp.asarray(ids[s]), mesh=jmesh,
                              spec=jspec)
        np.testing.assert_allclose(rc.numpy(), ra.numpy(), **TOL)
        np.testing.assert_allclose(rc.numpy(), _np(rj), **TOL)
        st.apply_gradients_sharded(sa, opt, idx, g, mesh=tmesh, spec=spec_a)
        st.apply_gradients_sharded(sc, opt, idx, g, mesh=tmesh, spec=spec_c)
        js = jst.apply_gradients_sharded(js, jopt, jnp.asarray(ids[s]),
                                         jnp.asarray(grads[s]), mesh=jmesh,
                                         spec=jspec)
        mgr.observe(ids[s])
        jmgr.observe(ids[s])
        if mgr.due:
            assert mgr.refresh(sc) is sc
        if jmgr.due:
            js = jmgr.refresh(js)
        np.testing.assert_array_equal(sc.cache.keys.numpy(),
                                      _np(js.cache.keys))
    assert mgr.refreshes >= 2
    # the refresh rewrote the replica in place (a captured step keeps it)
    assert buffers == (sc.cache.keys.data_ptr(), sc.cache.rows.data_ptr())
    for a, b in ((sa.weights, sc.table.weights),
                 (sa.slots["accum"], sc.table.slots["accum"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    np.testing.assert_allclose(sc.table.weights.numpy(),
                               _np(js.table.weights), **TOL)
    ck = sc.cache.keys.numpy()
    live = ck >= 0
    if live.any():
        want = st.pull_sharded(sa, torch.from_numpy(ck[live]), mesh=tmesh,
                               spec=spec_a, batch_sharded=False)
        np.testing.assert_allclose(sc.cache.rows.numpy()[live],
                                   want.numpy(), **TOL)


@pytest.mark.parametrize("key_width", [32, 64])
def test_hash_cached_plane_matches_a2a_and_jax(devices8, key_width):
    """Hash tables (int32 and wide pair keys): every seen key reads back
    alike on the cached plane, the port's ``a2a`` and JAX's cached plane
    across refreshes, with the same keys admitted."""
    jmesh, tmesh = _meshes(devices8)
    jmeta = oe.EmbeddingVariableMeta(embedding_dim=DIM,
                                     vocabulary_size=2**63)
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=2**63)
    jopt, opt = oe.make_optimizer(OPT), make_optimizer(OPT)
    jspec = jsh.make_hash_sharding_spec(jmesh, 1024, plane="a2a+cache",
                                        key_width=key_width, cache_k=K)
    spec_a = sh.make_hash_sharding_spec(tmesh, 1024, plane="a2a",
                                        key_width=key_width)
    spec_c = sh.make_hash_sharding_spec(tmesh, 1024, plane="a2a+cache",
                                        key_width=key_width, cache_k=K)
    js = jsh.create_sharded_hash_table(jmeta, jopt, mesh=jmesh, spec=jspec)
    sa = sh.create_sharded_hash_table(meta, opt, mesh=tmesh, spec=spec_a)
    sc = sh.create_sharded_hash_table(meta, opt, mesh=tmesh, spec=spec_c)
    rng = np.random.RandomState(1)
    keys64 = (np.minimum(rng.zipf(1.3, size=(8, B)), 500) * 7919
              ).astype(np.int64)
    grads = rng.randn(8, B, DIM).astype(np.float32)

    def to_idx(a):
        return tht.split64(a) if key_width == 64 else a.astype(np.int32)

    jmgr = jhot.HotCacheManager(mesh=jmesh, spec=jspec, k=K,
                                refresh_every=3)
    mgr = hot.HotCacheManager(spec=spec_c, k=K, refresh_every=3)
    for s in range(8):
        idx, g = torch.from_numpy(to_idx(keys64[s])), torch.from_numpy(
            grads[s])
        ra = sh.pull_sharded(sa, idx, INIT, mesh=tmesh, spec=spec_a)
        rc = sh.pull_sharded(sc, idx, INIT, mesh=tmesh, spec=spec_c)
        rj = jsh.pull_sharded(js, jnp.asarray(to_idx(keys64[s])), INIT,
                              mesh=jmesh, spec=jspec)
        np.testing.assert_allclose(rc.numpy(), ra.numpy(), **TOL)
        np.testing.assert_allclose(rc.numpy(), _np(rj), **TOL)
        sh.apply_gradients_sharded(sa, opt, INIT, idx, g, mesh=tmesh,
                                   spec=spec_a)
        sh.apply_gradients_sharded(sc, opt, INIT, idx, g, mesh=tmesh,
                                   spec=spec_c)
        js = jsh.apply_gradients_sharded(
            js, jopt, INIT, jnp.asarray(to_idx(keys64[s])),
            jnp.asarray(grads[s]), mesh=jmesh, spec=jspec)
        mgr.observe(keys64[s])
        jmgr.observe(keys64[s])
        if mgr.due:
            mgr.refresh(sc)
        if jmgr.due:
            js = jmgr.refresh(js)
        np.testing.assert_array_equal(sc.cache.keys.numpy(),
                                      _np(js.cache.keys))
    assert mgr.refreshes >= 2
    seen = torch.from_numpy(to_idx(np.unique(keys64.ravel())))
    ra = sh.pull_sharded(sa, seen, None, mesh=tmesh, spec=spec_a,
                         batch_sharded=False)
    rc = sh.pull_sharded(sc, seen, None, mesh=tmesh, spec=spec_c,
                         batch_sharded=False)
    np.testing.assert_allclose(rc.numpy(), ra.numpy(), **TOL)
    # keys slot for slot (the same inserts in the same order)
    np.testing.assert_array_equal(sc.table.keys.numpy(), _np(js.table.keys))


def test_cache_counters_equal_jax(devices8):
    """``cache_hits``, ``cache_misses`` and ``ici_bytes_saved`` after a
    zipf pull and push equal JAX's; hits > 0; hits + misses = 2B; a
    uniform stream's rows equal the uncached plane's."""
    jmesh, tmesh = _meshes(devices8)
    jmeta = oe.EmbeddingVariableMeta(embedding_dim=DIM,
                                     vocabulary_size=VOCAB)
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=VOCAB)
    jopt, opt = oe.make_optimizer(OPT), make_optimizer(OPT)
    jspec = jst.make_sharding_spec(jmeta, jmesh, plane="a2a+cache",
                                   cache_k=K)
    spec_c = st.make_sharding_spec(meta, tmesh, plane="a2a+cache",
                                   cache_k=K)
    js = jst.create_sharded_table(jmeta, jopt, INIT, mesh=jmesh, spec=jspec)
    sc = st.create_sharded_table(meta, opt, INIT, mesh=tmesh, spec=spec_c)
    rng = np.random.RandomState(2)
    zipf, uni = _streams(rng, 4)
    jmgr = jhot.HotCacheManager(mesh=jmesh, spec=jspec, k=K,
                                refresh_every=1)
    mgr = hot.HotCacheManager(spec=spec_c, k=K, refresh_every=1)
    for s in range(3):
        mgr.observe(zipf[s])
        jmgr.observe(zipf[s])
    mgr.refresh(sc)
    js = jmgr.refresh(js)
    stats = []
    for o, run in (
            (jobs, lambda: (
                jst.pull_sharded(js, jnp.asarray(zipf[3]), mesh=jmesh,
                                 spec=jspec),
                jst.apply_gradients_sharded(
                    js, jopt, jnp.asarray(zipf[3]),
                    jnp.ones((B, DIM), jnp.float32), mesh=jmesh,
                    spec=jspec))),
            (obs, lambda: (
                st.pull_sharded(sc, torch.from_numpy(zipf[3]), mesh=tmesh,
                                spec=spec_c),
                st.apply_gradients_sharded(
                    sc, opt, torch.from_numpy(zipf[3]),
                    torch.ones(B, DIM), mesh=tmesh, spec=spec_c)))):
        o.GLOBAL.reset()
        o.set_evaluate_performance(True)
        try:
            out = run()
            jax.effects_barrier()
            jax.block_until_ready(jax.tree.leaves(out[1])
                                  if o is jobs else [])
            stats.append(o.cache_stats())
        finally:
            o.set_evaluate_performance(False)
            o.GLOBAL.reset()
    assert stats[1] == stats[0]
    assert stats[1]["cache_hits"] > 0 and stats[1]["ici_bytes_saved"] > 0
    assert stats[1]["cache_hits"] + stats[1]["cache_misses"] == 2 * B
    spec_a = st.make_sharding_spec(meta, tmesh, plane="a2a")
    sa = st.create_sharded_table(meta, opt, INIT, mesh=tmesh, spec=spec_a)
    st.apply_gradients_sharded(sa, opt, torch.from_numpy(zipf[3]),
                               torch.ones(B, DIM), mesh=tmesh, spec=spec_a)
    ra = st.pull_sharded(sa, torch.from_numpy(uni[0]), mesh=tmesh,
                         spec=spec_a)
    rc = st.pull_sharded(sc, torch.from_numpy(uni[0]), mesh=tmesh,
                         spec=spec_c)
    np.testing.assert_allclose(rc.numpy(), ra.numpy(), **TOL)


def _sketches(**kw):
    return hot.FreqSketch(**kw), jhot.FreqSketch(**kw)


def test_freq_sketch_decay_and_admission_equal_jax():
    for sk in _sketches(decay=0.5, prune_below=0.4):
        sk.update(np.array([1, 1, 1, 1, 2, 2, 3]))
        assert sk.topk(2).tolist() == [1, 2]
        sk.decay()
        sk.decay()
        assert 3 not in set(sk.topk(10).tolist())
        sk.update(np.array([9] * 5))
        assert sk.topk(1).tolist() == [9]
    t, j = _sketches()
    for sk in (t, j):
        sk.update(np.array([7, 5, 7, 5]))
    assert t.topk(2).tolist() == j.topk(2).tolist() == [5, 7]
    t, j = _sketches(decay=1.0, max_entries=100)
    for sk in (t, j):
        sk.update(np.repeat(np.arange(50), 3))
        sk.update(np.arange(1000, 1101))
        assert len(sk) <= 100
    assert t.topk(50).tolist() == j.topk(50).tolist()
    assert set(t.topk(50).tolist()) == set(range(50))


@pytest.mark.parametrize("dense_vocab", [None, 100])
def test_freq_sketch_modes_equal_jax_on_one_stream(dense_vocab):
    """Dense and dict modes count, decay and rank as JAX's on the same
    key streams (and the dense mode as the dict mode)."""
    t, j = _sketches(decay=0.5, dense_vocab=dense_vocab)
    rng = np.random.RandomState(3)
    for step in range(6):
        ks = rng.randint(0, 100, 64)
        for sk in (t, j):
            sk.update(ks)
        if step % 2:
            for sk in (t, j):
                sk.decay()
        assert t.topk(10).tolist() == j.topk(10).tolist()
        assert len(t) == len(j) and t.approx_bytes() == j.approx_bytes()
    # JAX's own case: 5 batches, then a decay, dense mode = dict mode
    dense_, dict_ = hot.FreqSketch(decay=0.5, dense_vocab=100), \
        hot.FreqSketch(decay=0.5)
    rng = np.random.RandomState(3)
    for _ in range(5):
        ks = rng.randint(0, 100, 64)
        dense_.update(ks)
        dict_.update(ks)
    assert dense_.topk(10).tolist() == dict_.topk(10).tolist()
    dense_.decay()
    dict_.decay()
    assert dense_.topk(10).tolist() == dict_.topk(10).tolist()
    tiny, jtiny = _sketches(dense_vocab=8)
    for sk in (tiny, jtiny):
        sk.update(np.array([3, 3, 5]))
    assert set(tiny.topk(8).tolist()) == set(jtiny.topk(8).tolist()) \
        == {3, 5}


def test_freq_sketch_sampling_covers_structured_layouts():
    """Past ``SAMPLE_CAP`` entries the stride sample rotates its phase,
    so every column of a ``[B, F]`` batch is seen, as in JAX."""
    t, j = _sketches(decay=1.0, dense_vocab=64)
    assert hot.FreqSketch.SAMPLE_CAP == jhot.FreqSketch.SAMPLE_CAP
    F = 26
    batch = np.tile(np.arange(F, dtype=np.int64)[None, :],
                    ((hot.FreqSketch.SAMPLE_CAP // F) + 200, 1))
    for _ in range(F):
        t.update(batch)
        j.update(batch)
    assert t.topk(F).tolist() == j.topk(F).tolist()
    assert set(t.topk(F).tolist()) == set(range(F))


def test_lookup_partition_static_shapes():
    """The hit partition: narrow and wide (unsigned 64-bit order) keys,
    positions and hits JAX's, the hits masked to the sentinel."""
    keys = np.full(8, np.iinfo(np.int32).min, np.int32)
    keys[:4] = [3, 7, 11, 40]
    keys.sort()
    q = np.array([7, 5, 40, -1, 3, 63], np.int32)
    valid = (q >= 0) & (q < VOCAB)
    pos, hit = hot.lookup(torch.from_numpy(keys), torch.from_numpy(q),
                          torch.from_numpy(valid))
    jpos, jhit = jhot.lookup(jnp.asarray(keys), jnp.asarray(q),
                             jnp.asarray(valid))
    assert hit.tolist() == [True, False, True, False, True, False]
    assert hit.tolist() == _np(jhit).tolist()
    assert pos[hit].tolist() == _np(jpos)[_np(jhit)].tolist()
    assert hot.mask_hits(torch.from_numpy(q), hit, -1).tolist() \
        == [-1, 5, -1, -1, -1, 63]
    cand = np.array([2**40 + 5, -3 & (2**64 - 1), 17, 2**33], np.uint64)
    keys64 = np.sort(cand).astype(np.int64)
    pad = np.int64(np.uint64(0x8000000080000000))
    full = np.concatenate([keys64, [pad] * 4])
    full = full[np.argsort(full.view(np.uint64))]
    wkeys = tht.split64(full)
    wq = tht.split64(np.array([17, 99, 2**40 + 5, -3], np.int64))
    wvalid = np.ones(4, bool)
    wpos, whit = hot.lookup(torch.from_numpy(wkeys), torch.from_numpy(wq),
                            torch.from_numpy(wvalid))
    jwpos, jwhit = jhot.lookup(jnp.asarray(wkeys), jnp.asarray(wq),
                               jnp.asarray(wvalid))
    assert whit.tolist() == [True, False, True, True] \
        == _np(jwhit).tolist()
    assert wpos[whit].tolist() == _np(jwpos)[_np(jwhit)].tolist()
    wres = hot.mask_hits(torch.from_numpy(wq), whit,
                         tht.empty_key(torch.int32))
    assert wres[1, 1] != tht.empty_key(torch.int32)
    assert (wres[[0, 2, 3], 1] == tht.empty_key(torch.int32)).all()
    # static shapes: the outputs are the query's length whatever hits
    assert pos.shape == hit.shape == (6,) and wpos.shape == (4,)


def test_build_cache_rejects_absent_hash_keys(devices8):
    """Admission drops candidates absent from a hash table (a replica
    row would shadow an unseen key's init row), as JAX's does."""
    _, tmesh = _meshes(devices8)
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=2**63)
    opt = make_optimizer(OPT)
    spec_c = sh.make_hash_sharding_spec(tmesh, 1024, plane="a2a+cache",
                                        key_width=32, cache_k=8)
    sc = sh.create_sharded_hash_table(meta, opt, mesh=tmesh, spec=spec_c)
    sh.apply_gradients_sharded(
        sc, opt, INIT, torch.tensor([5, 9, 13], dtype=torch.int32),
        torch.ones(3, DIM), mesh=tmesh, spec=spec_c, batch_sharded=False)
    cache = hot.build_cache(sc.table, np.array([5, 9, 777, 888], np.int64),
                            8, spec=spec_c)
    live = cache.keys != torch.iinfo(torch.int32).min
    assert set(cache.keys[live].tolist()) == {5, 9}
    # the admitted rows and slots are the owners'
    rows = sh.pull_sharded(sc, cache.keys[live], None, mesh=tmesh,
                           spec=spec_c, batch_sharded=False)
    assert torch.equal(cache.rows[live], rows)


def test_cached_plane_checkpoint_roundtrip(devices8, tmp_path):
    """A save holds only the table (JAX's loader reads it back); a load
    attaches an all-padding replica and pulls the same rows."""
    jmesh, tmesh = _meshes(devices8)
    spec = dict(name="v", input_dim=VOCAB, output_dim=DIM,
                plane="a2a+cache", cache_k=K, optimizer=OPT,
                initializer=INIT)
    coll = EmbeddingCollection([EmbeddingSpec(**spec)], tmesh)
    states = coll.init(ti.prng_key(0))
    assert isinstance(states["v"], hot.CachedState)
    idx = torch.arange(16, dtype=torch.int32)
    coll.apply_gradients(states, {"v": idx}, {"v": torch.ones(16, DIM)})
    mgr = coll.make_hot_cache_manager("v")
    mgr.observe(np.arange(16, dtype=np.int32))
    mgr.refresh(states["v"])
    assert (states["v"].cache.keys >= 0).any()
    tck.save_checkpoint(str(tmp_path / "c"), coll, states)
    loaded = tck.load_checkpoint(str(tmp_path / "c"), coll)
    assert isinstance(loaded["v"], hot.CachedState)
    assert torch.equal(loaded["v"].table.weights, states["v"].table.weights)
    assert (loaded["v"].cache.keys == torch.iinfo(torch.int32).min).all()
    out = coll.pull(loaded, {"v": idx}, batch_sharded=False)["v"]
    want = coll.pull(states, {"v": idx}, batch_sharded=False)["v"]
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    jcoll = oe.EmbeddingCollection([oe.EmbeddingSpec(**spec)], jmesh)
    jl = jax_ckpt.load_checkpoint(str(tmp_path / "c"), jcoll)
    assert isinstance(jl["v"], jhot.CachedState)
    np.testing.assert_allclose(
        _np(jcoll.pull(jl, {"v": jnp.asarray(idx.numpy())},
                       batch_sharded=False)["v"]), want.numpy(), rtol=1e-6,
        atol=1e-6)


def test_trainer_wires_hot_cache_equal_jax(devices8):
    """The Trainer builds a manager for each cached variable (the
    ``:linear`` twin sharing its base's sketch), observes every step,
    refreshes in place (one step program over the run) and admits JAX's
    Trainer's keys; losses at rtol 1e-5."""
    jmesh, tmesh = _meshes(devices8)
    feats = ("u",)
    kw = dict(plane="a2a+cache", cache_k=K, cache_refresh_every=2,
              optimizer=OPT)
    jspecs = jax_models.make_feature_specs(feats, VOCAB, DIM, **kw)
    tspecs = tm.make_feature_specs(feats, VOCAB, DIM, **kw)
    jt = oe.Trainer(jax_models.build_model("lr", feats),
                    oe.EmbeddingCollection(jspecs, jmesh), optax.sgd(0.1))
    t = tr.Trainer(tm.build_model("lr", feats, num_dense=3),
                   EmbeddingCollection(tspecs, tmesh), dense.sgd(0.1))
    rng = np.random.RandomState(4)
    zipf, _ = _streams(rng, 5)
    batches = [{"label": (rng.rand(B) > 0.5).astype(np.float32),
                "dense": rng.randn(B, 3).astype(np.float32),
                "sparse": {"u": z, "u:linear": z}} for z in zipf]
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    s = t.init(ti.prng_key(0), batches[0])
    for b in batches:
        js, jm = jt.train_step(js, b)
        s, m = t.train_step(s, b)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert set(t._hot) == {"u", "u:linear"}
    assert t._hot["u:linear"].sketch is t._hot["u"].sketch
    assert all(mgr.refreshes >= 2 for mgr in t._hot.values())
    assert t.builds == 1
    for name in t._hot:
        cached = s.emb[name]
        assert isinstance(cached, hot.CachedState)
        assert (cached.cache.keys >= 0).any()
        np.testing.assert_array_equal(cached.cache.keys.numpy(),
                                      _np(js.emb[name].cache.keys))


def test_export_dense_unwraps_cached_plane(devices8):
    """``export_dense`` reads the table through the replica: logical row
    order, padding dropped."""
    _, tmesh = _meshes(devices8)
    coll = EmbeddingCollection(
        [EmbeddingSpec("v", VOCAB + 3, DIM, plane="a2a+cache", cache_k=K,
                       optimizer=OPT, initializer=INIT)], tmesh)
    states = coll.init(ti.prng_key(0))
    ids = torch.arange(VOCAB + 3)
    g = torch.arange(VOCAB + 3, dtype=torch.float32)[:, None].expand(
        -1, DIM).contiguous()
    coll.apply_gradients(states, {"v": ids}, {"v": g}, batch_sharded=False)
    out = tck.export_dense(coll, states)
    assert out["v"].shape == (VOCAB + 3, DIM)
    want = coll.pull(states, {"v": ids}, batch_sharded=False)["v"]
    np.testing.assert_array_equal(out["v"], want.numpy())


def test_cached_state_crosses_interop(devices8):
    """JAX's table and replica after a refresh, carried into the port
    (``interop.cached_state_from_numpy``): the port's cached pull serves
    JAX's rows, its hits JAX's, and the replica reads back as it came."""
    from openembedding_tpu_torch import interop
    jmesh, tmesh = _meshes(devices8)
    jmeta = oe.EmbeddingVariableMeta(embedding_dim=DIM,
                                     vocabulary_size=VOCAB)
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=VOCAB)
    jopt = oe.make_optimizer(OPT)
    jspec = jst.make_sharding_spec(jmeta, jmesh, plane="a2a+cache",
                                   cache_k=K)
    spec_c = st.make_sharding_spec(meta, tmesh, plane="a2a+cache",
                                   cache_k=K)
    js = jst.create_sharded_table(jmeta, jopt, INIT, mesh=jmesh, spec=jspec)
    rng = np.random.RandomState(5)
    zipf, _ = _streams(rng, 3)
    jmgr = jhot.HotCacheManager(mesh=jmesh, spec=jspec, k=K,
                                refresh_every=1)
    for s in range(3):
        js = jst.apply_gradients_sharded(
            js, jopt, jnp.asarray(zipf[s]),
            jnp.asarray(rng.randn(B, DIM).astype(np.float32)), mesh=jmesh,
            spec=jspec)
        jmgr.observe(zipf[s])
    js = jmgr.refresh(js)
    table = interop.sharded_table_state_from_numpy(
        _np(js.table.weights), {k: _np(v) for k, v in
                                js.table.slots.items()}, 4, "cpu")
    sc = interop.cached_state_from_numpy(
        table, _np(js.cache.keys), _np(js.cache.rows),
        {k: _np(v) for k, v in js.cache.slots.items()}, "cpu")
    keys, rows, slots = interop.cache_state_to_numpy(sc)
    np.testing.assert_array_equal(keys, _np(js.cache.keys))
    np.testing.assert_array_equal(rows, _np(js.cache.rows))
    idx = zipf[2]
    got = st.pull_sharded(sc, torch.from_numpy(idx), mesh=tmesh,
                          spec=spec_c)
    want = jst.pull_sharded(js, jnp.asarray(idx), mesh=jmesh, spec=jspec)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    pos, hit = hot.lookup(sc.cache.keys, torch.from_numpy(idx),
                          torch.ones(B, dtype=torch.bool))
    assert hit.any()
