"""Torch port, the host-offload tier's tables against the JAX package's
(``openembedding_tpu/offload.py``): ``HostOffloadedTable`` on the cases of
``tests/test_offload.py:27-150``, and ``ShardedOffloadedTable`` at one
shard on the table-level cases (eviction against a plain table, persist,
kill and restore, the compressed chain, stale prepares, a gather retried
under an eviction, the overflow counter), each run through JAX's table on
a one-device mesh and the port's on ``device="cpu"`` with the same seeded
numpy inputs.

Exact where the work is a copy or integer (host stores after SGD with
learning rate 1, work ids, cache keys slot for slot, persist files); Adagrad
rows at rtol 1e-6 against JAX, as the port's other optimizer tests.
"""

import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu import EmbeddingVariableMeta as JaxMeta
from openembedding_tpu import offload as joff
from openembedding_tpu.parallel import sharded_hash as jsh
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import offload as toff
from openembedding_tpu_torch import table as ttable
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel import sharded_hash as tsh
from openembedding_tpu_torch.parallel.mesh import create_mesh as tmesh

DIM = 4
SGD = {"category": "sgd", "learning_rate": 1.0}
ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}
HALF = {"category": "constant", "value": 0.5}
QUARTER = {"category": "constant", "value": 0.25}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_pair(**kw):
    """JAX's ``HostOffloadedTable`` and the port's, same arguments."""
    kw.setdefault("vocab", 1000)
    kw.setdefault("cache_capacity", 256)
    opt, init = kw.pop("opt", SGD), kw.pop("init", HALF)
    meta_kw = dict(embedding_dim=DIM, vocabulary_size=kw["vocab"])
    return (joff.HostOffloadedTable(JaxMeta(**meta_kw), opt, init, **kw),
            toff.HostOffloadedTable(EmbeddingVariableMeta(**meta_kw), opt,
                                    init, device="cpu", **kw))


def _jax_step(t, ids, grads):
    t.apply_gradients(jnp.asarray(ids), jnp.asarray(grads))


def _port_step(t, ids, grads):
    t.apply_gradients(ids, torch.from_numpy(grads))


def _both(pair, fn):
    """``fn(table, step)`` on JAX's table and the port's."""
    return fn(pair[0], _jax_step), fn(pair[1], _port_step)


def _assert_host_equal(j, t):
    np.testing.assert_array_equal(t.host_weights, j.host_weights)
    for k in j.host_slots:
        np.testing.assert_array_equal(t.host_slots[k], j.host_slots[k])
    np.testing.assert_array_equal(t.host_work_id, j.host_work_id)
    assert t.work_id == j.work_id


# --- HostOffloadedTable (tests/test_offload.py:27-150) ----------------------

def test_pull_through_cache_matches_host():
    pair = host_pair()
    ids = np.array([1, 500, 999], np.int32)

    def run(t, _step):
        t.prepare(ids)
        return np.asarray(t.pull(ids if isinstance(t, toff.HostOffloadedTable)
                                 else jnp.asarray(ids)))
    jrows, trows = _both(pair, run)
    np.testing.assert_array_equal(trows, jrows)
    np.testing.assert_array_equal(trows, pair[1].host_weights[ids])
    np.testing.assert_array_equal(pair[1].cache.keys.numpy(),
                                  np.asarray(pair[0].cache.keys))


def test_update_flush_writeback():
    pair = host_pair()
    ids = np.array([7, 8, 9], np.int32)

    def run(t, step):
        t.prepare(ids)
        step(t, ids, np.ones((3, DIM), np.float32))
        stale = t.host_weights[ids].copy()
        flushed = t.flush()
        t.prepare(ids)
        return stale, flushed
    (jstale, jn), (tstale, tn) = _both(pair, run)
    np.testing.assert_array_equal(tstale, 0.5)   # stale until the flush
    assert tn == jn == 3
    _assert_host_equal(*pair)
    np.testing.assert_array_equal(pair[1].host_weights[ids], -0.5)
    assert (pair[1].host_work_id[ids] > 0).all()
    np.testing.assert_array_equal(pair[1].pull(ids).numpy(), -0.5)


def test_tiny_cache_eviction_cycle():
    pair = host_pair(cache_capacity=64)
    replica = pair[1].host_weights.copy()

    def run(t, step):
        rng = np.random.RandomState(0)
        for _ in range(8):
            uniq = np.unique(rng.randint(0, 1000, 40).astype(np.int32))
            t.prepare(uniq)
            step(t, uniq, np.full((uniq.size, DIM), 0.1, np.float32))
        t.flush()
    _both(pair, run)
    rng = np.random.RandomState(0)
    for _ in range(8):
        replica[np.unique(rng.randint(0, 1000, 40))] -= np.float32(0.1)
    _assert_host_equal(*pair)
    np.testing.assert_allclose(pair[1].host_weights, replica, rtol=1e-5,
                               atol=1e-6)


def test_incremental_persist_restore(tmp_path):
    pair = host_pair()
    ids1, ids2 = np.array([1, 2, 3], np.int32), np.array([10, 11], np.int32)

    def run(t, step):
        p = str(tmp_path / type(t).__module__)
        t.prepare(ids1)
        step(t, ids1, np.ones((3, DIM), np.float32))
        info = t.persist(p)
        t.prepare(ids2)
        step(t, ids2, np.full((2, DIM), 2.0, np.float32))
        return p, info, t.persist(p)
    (jp, jinfo, jinfo2), (tp, tinfo, tinfo2) = _both(pair, run)
    assert tinfo == jinfo and tinfo["file"].startswith("base_")
    assert tinfo2 == jinfo2 and tinfo2["file"].startswith("inc_")
    assert tinfo2["rows"] == 2
    # each package restores both chains (base + increment)
    for p in (jp, tp):
        j2, t2 = host_pair()
        j2.restore(p)
        t2.restore(p)
        _assert_host_equal(j2, t2)
        np.testing.assert_array_equal(t2.host_weights[ids1], -0.5)
        np.testing.assert_array_equal(t2.host_weights[ids2], -1.5)
        np.testing.assert_array_equal(t2.host_weights[20], 0.5)
        assert t2.work_id > t2.persisted_work == pair[1].persisted_work


def test_persist_chain_compaction(tmp_path):
    assert toff.COMPACT_CHAIN_LEN == joff.COMPACT_CHAIN_LEN
    pair = host_pair()

    def run(t, step):
        p = str(tmp_path / type(t).__module__)
        for k in range(toff.COMPACT_CHAIN_LEN + 3):
            ids = np.array([k % 16, 16 + k % 7], np.int32)
            t.prepare(ids)
            step(t, ids, np.full((2, DIM), k + 1, np.float32))
            t.persist(p)
        with open(os.path.join(p, toff.OFFLOAD_META_FILE)) as f:
            return p, json.load(f)
    (jp, jmeta), (tp, tmeta) = _both(pair, run)
    assert tmeta["checkpoints"] == jmeta["checkpoints"]
    assert len(tmeta["checkpoints"]) <= toff.COMPACT_CHAIN_LEN
    on_disk = {f for f in os.listdir(tp) if f.endswith(".npz")}
    assert on_disk == {e["file"] for e in tmeta["checkpoints"]}
    _, t2 = host_pair()
    t2.restore(tp)
    np.testing.assert_array_equal(t2.host_weights, pair[0].host_weights)


def test_should_persist_window():
    pair = host_pair(persist_pending_window=3)
    ids = np.array([1], np.int32)

    def run(t, step):
        before = t.should_persist
        for _ in range(3):
            t.prepare(ids)
            step(t, ids, np.ones((1, DIM), np.float32))
        return before, t.should_persist
    assert _both(pair, run) == ((False, True), (False, True))


def test_restore_vocab_mismatch(tmp_path):
    _, t = host_pair()
    p = str(tmp_path / "off")
    t.persist(p)
    small = toff.HostOffloadedTable(
        EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=500),
        SGD, vocab=500, cache_capacity=64, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        small.restore(p)


def test_host_store_initial_rows_equal_jax():
    """Non-constant initializers: the host stores' first rows as JAX draws
    them, with nothing copied (the whole store from ``PRNGKey(seed)`` for
    ``HostOffloadedTable``; chunk ``[lo, hi)`` from ``fold_in(PRNGKey(
    seed), lo)`` for ``ShardedOffloadedTable``, over two chunks)."""
    init = {"category": "uniform", "minval": -0.5, "maxval": 0.5}
    j, t = host_pair(vocab=300, init=init, seed=3)
    np.testing.assert_array_equal(t.host_weights, j.host_weights)
    chunk = (64 << 20) // (2 * 4)   # rows of one 64 MiB chunk at dim 2
    vocab = chunk + 5
    kw = dict(vocab=vocab, cache_capacity=256, seed=7)
    meta = dict(embedding_dim=2, vocabulary_size=vocab)
    js = joff.ShardedOffloadedTable(
        "u", JaxMeta(**meta), SGD, init,
        mesh=create_mesh(1, 1, jax.devices()[:1]), **kw)
    ts = toff.ShardedOffloadedTable("u", EmbeddingVariableMeta(**meta), SGD,
                                    init, device="cpu", **kw)
    for rows in (slice(0, 4096), slice(chunk - 3, vocab)):
        np.testing.assert_array_equal(ts.host_weights[rows],
                                      js.host_weights[rows])


# --- ShardedOffloadedTable at one shard ------------------------------------

# the (data, model) mesh of the cases below: one shard here;
# tests/test_torch_offload_sharded.py runs them again on JAX's 2 x 4
GRID = (1, 1)


def _mesh():
    return create_mesh(*GRID, jax.devices()[:GRID[0] * GRID[1]])


def _port_where():
    """The port table's placement: one device, or the one-process mesh of
    ``GRID``."""
    if GRID == (1, 1):
        return {"device": "cpu"}
    return {"mesh": tmesh(*GRID, device="cpu")}


def sharded_pair(vocab=1024, cache=256, opt=ADAGRAD, init=QUARTER,
                 name="off", **kw):
    meta = dict(embedding_dim=DIM, vocabulary_size=vocab)
    return (joff.ShardedOffloadedTable(name, JaxMeta(**meta), opt, init,
                                       vocab=vocab, cache_capacity=cache,
                                       mesh=_mesh(), **kw),
            toff.ShardedOffloadedTable(name, EmbeddingVariableMeta(**meta),
                                       opt, init, vocab=vocab,
                                       cache_capacity=cache, **kw,
                                       **_port_where()))


def _stream(steps, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(steps):
        # rotate through id ranges so the small cache must evict
        lo = (i * 160) % 800
        ids = rng.randint(lo, lo + 200, 64).astype(np.int32)
        out.append((ids, rng.randn(64, DIM).astype(np.float32)))
    return out


def _jax_push(table, cache, ids, grads):
    return jsh.apply_gradients_sharded(
        cache, table.optimizer, table.initializer, jnp.asarray(ids),
        jnp.asarray(grads), mesh=table.mesh, spec=table.spec,
        batch_sharded=False)


def _port_push(table, cache, ids, grads):
    if table.sharded:
        tsh.apply_gradients_sharded(
            cache, table.optimizer, table.initializer, torch.from_numpy(ids),
            torch.from_numpy(grads), mesh=table.mesh, spec=table.spec,
            batch_sharded=False)
        return cache
    th.apply_gradients(cache, table.optimizer, table.initializer,
                       torch.from_numpy(ids), torch.from_numpy(grads))
    return cache


def _port_pull(table, cache, ids):
    if table.sharded:
        return tsh.pull_sharded(cache, torch.from_numpy(ids), None,
                                mesh=table.mesh, spec=table.spec,
                                batch_sharded=False)
    return th.pull(cache, torch.from_numpy(ids), None)


def _port_failures(cache):
    """The port cache's live failure counter (a sharded cache's per
    shard)."""
    return getattr(cache, "shard_failures", cache.insert_failures)


def _run_stream(table, cache, items, push):
    for ids, grads in items:
        cache = table.prepare(cache, ids)
        cache = push(table, cache, ids, grads)
        table.note_update(ids)
    return cache


def _flushed(table, cache):
    table.flush(cache)
    table._join_writeback()
    return table


def _assert_cache_equal(jc, tc):
    keys, weights, slots, rng = interop.hash_state_to_numpy(tc)
    np.testing.assert_array_equal(keys, np.asarray(jc.keys))
    np.testing.assert_array_equal(rng, np.asarray(jc.init_rng))
    np.testing.assert_allclose(weights, np.asarray(jc.weights), rtol=1e-6)


def test_eviction_parity_with_plain_table():
    """8 steps through a 256-row cache (evictions among them) equal JAX's
    tier and a plain in-memory table trained on the same stream."""
    jt, tt = sharded_pair()
    stream = _stream(8)
    jc = _run_stream(jt, jt.create_cache(), stream, _jax_push)
    tc = _run_stream(tt, tt.create_cache(), stream, _port_push)
    assert tt.evictions == jt.evictions > 0
    _assert_cache_equal(jc, tc)
    _flushed(jt, jc)
    _flushed(tt, tc)
    np.testing.assert_allclose(tt.host_weights, jt.host_weights, rtol=1e-6)
    np.testing.assert_array_equal(tt.host_work_id, jt.host_work_id)
    plain = ttable.create_table(EmbeddingVariableMeta(
        embedding_dim=DIM, vocabulary_size=1024), ADAGRAD, QUARTER,
        device="cpu")
    for ids, grads in stream:
        ttable.apply_gradients(plain, ADAGRAD, torch.from_numpy(ids),
                               torch.from_numpy(grads))
    np.testing.assert_allclose(tt.host_weights, plain.weights.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_persist_kill_restore_continue(tmp_path):
    """Train, persist (base, then an increment), lose the process, restore
    into a fresh table and continue: equal to the uninterrupted run, and
    the port's chain restores into JAX's table (and JAX's into the
    port's) with the same rows and watermark."""
    stream, more = _stream(6, seed=3), _stream(2, seed=9)
    runs = {}
    for pkg, t, push in (("jax", sharded_pair()[0], _jax_push),
                         ("port", sharded_pair()[1], _port_push)):
        pdir = str(tmp_path / pkg)
        c = _run_stream(t, t.create_cache(), stream[:3], push)
        t.persist(c, pdir)
        c = _run_stream(t, c, stream[3:], push)
        t.persist(c, pdir)
        _flushed(t, c)
        runs[pkg] = (t, c, pdir, t.host_weights.copy())
    for src in ("jax", "port"):
        _, _, pdir, want = runs[src]
        jt2, tt2 = sharded_pair()
        jc2, tc2 = jt2.restore(pdir), tt2.restore(pdir)
        for t2 in (jt2, tt2):
            np.testing.assert_allclose(t2.host_weights, want, rtol=1e-6)
            assert t2.work_id == runs[src][0].work_id + 1
            assert t2.persisted_work == runs[src][0].persisted_work
        _assert_cache_equal(jc2, tc2)
    # the port continues from its restore as from its uninterrupted run
    t1, c1, pdir, _ = runs["port"]
    t2 = sharded_pair()[1]
    c2 = t2.restore(pdir)
    c1 = _run_stream(t1, c1, more, _port_push)
    c2 = _run_stream(t2, c2, more, _port_push)
    np.testing.assert_allclose(_flushed(t2, c2).host_weights,
                               _flushed(t1, c1).host_weights,
                               rtol=1e-6, atol=1e-7)


def test_restore_in_place_keeps_the_cache_tensors(tmp_path):
    """``restore(path, cache)`` rebuilds the given cache in place (what a
    captured step needs) and equals a fresh restore's cache."""
    _, t = sharded_pair()
    c = _run_stream(t, t.create_cache(), _stream(2), _port_push)
    t.persist(c, str(tmp_path / "p"))
    ptrs = [c.keys.data_ptr(), c.weights.data_ptr(),
            c.init_rng.data_ptr()]
    t2 = sharded_pair()[1]
    fresh = t2.restore(str(tmp_path / "p"))
    again = t.restore(str(tmp_path / "p"), c)
    assert again is c
    assert [c.keys.data_ptr(), c.weights.data_ptr(),
            c.init_rng.data_ptr()] == ptrs
    for a, b in zip(interop.hash_state_to_numpy(again)[::3],
                    interop.hash_state_to_numpy(fresh)[::3]):
        np.testing.assert_array_equal(a, b)


def test_persist_restore_remote_uri():
    """The persist chain streams to fsspec URIs (``memory://``), and each
    package reads the other's."""
    stream = _stream(3, seed=4)
    uris = {}
    for pkg, t, push in (("jax", sharded_pair()[0], _jax_push),
                         ("port", sharded_pair()[1], _port_push)):
        uri = f"memory://off-{pkg}-{uuid.uuid4().hex}"
        c = _run_stream(t, t.create_cache(), stream[:2], push)
        t.persist(c, uri)
        c = _run_stream(t, c, stream[2:], push)
        assert t.persist(c, uri)["file"].startswith("inc_")
        uris[pkg] = (uri, _flushed(t, c).host_weights.copy())
    for uri, want in uris.values():
        for t2 in sharded_pair():
            t2.restore(uri)
            np.testing.assert_allclose(t2.host_weights, want, rtol=1e-6)


def test_persist_compress_chain(tmp_path):
    """A zlib chain restores as a raw one, raw and zlib entries share a
    chain, the zlib files are smaller on a constant store, and the files
    match JAX's member for member."""
    def mk(pkg, compress):
        meta = dict(embedding_dim=DIM, vocabulary_size=512)
        kw = dict(vocab=512, cache_capacity=128, persist_compress=compress)
        if pkg == "jax":
            return joff.ShardedOffloadedTable("t", JaxMeta(**meta), SGD,
                                              HALF, mesh=_mesh(), **kw)
        return toff.ShardedOffloadedTable("t", EmbeddingVariableMeta(**meta),
                                          SGD, HALF, **kw, **_port_where())

    stores = {}
    for pkg in ("jax", "port"):
        for codec in ("", "zlib"):
            t = mk(pkg, codec)
            c = t.create_cache()
            for lo, hi in ((0, 40), (40, 60)):
                ids = np.arange(lo, hi, dtype=np.int32)
                c = t.prepare(c, ids)
                t.note_update(ids)
            d = str(tmp_path / f"{pkg}{codec}")
            t.persist(c, d)                       # base
            ids3 = np.arange(60, 70, dtype=np.int32)
            c = t.prepare(c, ids3)
            t.note_update(ids3)
            t.persist(c, d)                       # increment
            stores[pkg, codec] = d
    size = {k: sum(os.path.getsize(os.path.join(d, f))
                   for f in os.listdir(d)) for k, d in stores.items()}
    assert size["port", "zlib"] < size["port", ""] * 0.5, size
    for key, d in stores.items():
        jd = stores["jax", key[1]]
        assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
        for f in os.listdir(d):
            if f.endswith(".npz"):
                a, b = np.load(os.path.join(d, f)), np.load(
                    os.path.join(jd, f))
                assert sorted(a.files) == sorted(b.files)
                for m in a.files:
                    np.testing.assert_array_equal(a[m], b[m])
    r_raw, r_z = mk("port", ""), mk("port", "")
    r_raw.restore(stores["port", ""])
    r_z.restore(stores["port", "zlib"])
    np.testing.assert_array_equal(r_raw.host_weights, r_z.host_weights)
    assert r_raw.persisted_work == r_z.persisted_work
    # mixed chain: a raw table appends a raw increment onto a zlib chain
    t2 = mk("port", "")
    c = t2.restore(stores["jax", "zlib"])
    ids4 = np.arange(70, 80, dtype=np.int32)
    c = t2.prepare(c, ids4)
    t2.note_update(ids4)
    t2.persist(c, stores["jax", "zlib"])
    t3 = mk("jax", "zlib")
    t3.restore(stores["jax", "zlib"])
    assert t3.persisted_work == t2.work_id


def _mk_sgd(vocab=2048, cache=256):
    return sharded_pair(vocab=vocab, cache=cache, opt=SGD, name="t")


def test_stale_prepare_recomputed_at_apply():
    """A prepare made before an eviction is recomputed at its apply (its
    generation is stale), and its rows land: in both packages, with the
    same books and cache keys."""
    out = []
    for t in _mk_sgd():
        cache = t.create_cache()
        ids_a = np.arange(0, 50, dtype=np.int32)
        prep_a = t.host_prepare(ids_a)
        assert not prep_a.needs_evict and prep_a.gen == 0
        prep_b = t.host_prepare(np.arange(100, 260, dtype=np.int32))
        assert prep_b.needs_evict
        cache = t.apply_prepared(cache, prep_b)
        assert t.evictions == 1 and t._gen == 1
        cache = t.apply_prepared(cache, prep_a)
        assert t.gen_retries >= 1
        assert bool(t._resident[ids_a].all())
        out.append((t, cache))
    (jt, jc), (tt, tc) = out
    assert (tt.gen_retries, tt._gen) == (jt.gen_retries, jt._gen)
    _assert_cache_equal(jc, tc)
    got = _port_pull(tt, tc, np.arange(50, dtype=np.int32)).numpy()
    np.testing.assert_array_equal(got, tt.host_weights[:50])


def test_gather_retry_when_evicted_mid_gather():
    """An eviction landing while a lookahead gather is parked forces that
    prepare to retry at the new generation."""
    for t in _mk_sgd():
        cache = t.create_cache()
        warm = np.arange(0, 135, dtype=np.int32)
        cache = t.prepare(cache, warm)
        t.note_update(warm)
        in_gather, release = threading.Event(), threading.Event()
        orig, fired, out = t._gather_host, [], {}

        def blocking_gather(ids, _orig=orig):
            if not fired:
                fired.append(True)
                in_gather.set()
                release.wait(timeout=30)
            return _orig(ids)

        t._gather_host = blocking_gather

        def prep_thread(_t=t):
            out["prep"] = _t.host_prepare(np.arange(200, 240,
                                                    dtype=np.int32))

        th_ = threading.Thread(target=prep_thread)
        th_.start()
        assert in_gather.wait(timeout=30)
        big = t.host_prepare(np.arange(300, 345, dtype=np.int32))
        assert big.needs_evict
        ev = threading.Thread(target=lambda _t=t, _c=cache: out.update(
            cache2=_t.apply_prepared(_c, big)))
        ev.start()
        deadline = time.time() + 60
        while t._gen == 0 and time.time() < deadline:
            time.sleep(0.01)
        assert t._gen == 1, "eviction did not complete"
        release.set()
        th_.join(timeout=60)
        ev.join(timeout=60)
        assert not th_.is_alive() and not ev.is_alive()
        prep = out["prep"]
        assert t.gen_retries >= 1
        assert prep.gen == t._gen and not prep.needs_evict
        t.cancel_prepared(prep)
        assert t._planned_count == 0


def test_overflow_check_every_n_batches():
    """With the knob set, a deferred overflow surfaces within N
    ``note_update`` calls, in both packages."""
    for t, flag in zip(sharded_pair(vocab=512, opt=SGD, name="t",
                                    overflow_check_every_n_batches=3),
                       (jnp.asarray(1, jnp.int32), torch.tensor(1))):
        t._overflow_latest = flag
        ids = np.array([1, 2], np.int32)
        t.note_update(ids)
        t.note_update(ids)   # lag below N: no device read yet
        with pytest.raises(RuntimeError, match="insert overflow"):
            t.note_update(ids)
        t.finish()


def test_check_overflow_prefers_live_cache_counter():
    """``flush`` reads the live cache's counter: failures the step's own
    push counted after the last host insert are caught."""
    jt, tt = _mk_sgd()
    jc = jt.create_cache(jax.random.PRNGKey(0))
    tc = tt.create_cache(ti.prng_key(0))
    assert jt._overflow_latest is None and tt._overflow_latest is None
    with pytest.raises(RuntimeError, match="insert overflow"):
        jt.flush(jc.replace(insert_failures=jnp.asarray(2, jnp.int32)))
    _port_failures(tc).fill_(2)
    with pytest.raises(RuntimeError, match="insert overflow"):
        tt.flush(tc)
    _port_failures(tc).zero_()
    assert tt.flush(tc) == jt.flush(jc) == 0
    tt._join_writeback()


def test_mesh_or_shards_raise_naming_item_9():
    """Only a mesh across processes raises, giving the reference's reason
    (its writeback reads the whole sharded cache onto one host and its
    host books see one process's batch); a one-process mesh shards the
    cache; the arguments are JAX's and ``device``."""
    import inspect
    from openembedding_tpu_torch.parallel.mesh import Mesh
    meta = EmbeddingVariableMeta(embedding_dim=DIM, vocabulary_size=64)
    spanning = Mesh(["cpu"] * 4, 2, 2, process_count=2, process_index=1)
    with pytest.raises(NotImplementedError,
                       match="reads the whole sharded cache onto one host"):
        toff.ShardedOffloadedTable("x", meta, SGD, vocab=64,
                                   cache_capacity=128, mesh=spanning)
    params = set(inspect.signature(toff.ShardedOffloadedTable).parameters)
    assert params - {"device"} == set(
        inspect.signature(joff.ShardedOffloadedTable).parameters)
    t = toff.ShardedOffloadedTable("x", meta, SGD, vocab=64,
                                   cache_capacity=128,
                                   mesh=tmesh(1, 2, device="cpu"))
    assert t.sharded and t.create_cache().num_shards == 2


_KILL_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.offload import HostOffloadedTable
from openembedding_tpu_torch.utils import fs

t = HostOffloadedTable(
    EmbeddingVariableMeta(embedding_dim=4, vocabulary_size=1000),
    {{"category": "sgd", "learning_rate": 1.0}},
    {{"category": "constant", "value": 0.5}},
    vocab=1000, cache_capacity=256, device="cpu")
p = {pdir!r}
ids1 = np.array([1, 2, 3], np.int32)
t.prepare(ids1)
t.apply_gradients(ids1, torch.ones((3, 4)))
t.persist(p)                               # committed base checkpoint
ids2 = np.array([10, 11], np.int32)
t.prepare(ids2)
t.apply_gradients(ids2, torch.full((2, 4), 2.0))

mode = {mode!r}
if mode == "mid_file":
    orig_write = fs._AtomicFile.write
    def dying_write(self, data):
        orig_write(self, bytes(data)[: max(1, len(data) // 2)])
        self._f.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    fs._AtomicFile.write = dying_write
else:
    def dying_json(path, obj):
        os.kill(os.getpid(), signal.SIGKILL)
    import openembedding_tpu_torch.offload as off
    off.fs.write_json_atomic = dying_json
print("persisting", flush=True)
t.persist(p)                               # never returns
"""


@pytest.mark.parametrize("mode", ["mid_file", "pre_meta"])
def test_kill_mid_persist_restores_watermark(tmp_path, mode):
    """A port process SIGKILLed inside its second persist leaves the base
    restorable at the previous watermark, by the port and by JAX; the
    survivor's next persist sweeps the debris."""
    pdir = str(tmp_path / "off")
    code = _KILL_CHILD.format(root=REPO, pdir=pdir, mode=mode)
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == -9, (out.returncode, out.stdout, out.stderr)
    assert "persisting" in out.stdout
    j2, t2 = host_pair()
    j2.restore(pdir)
    t2.restore(pdir)
    _assert_host_equal(j2, t2)
    np.testing.assert_array_equal(t2.host_weights[[1, 2, 3]], -0.5)
    np.testing.assert_array_equal(t2.host_weights[[10, 11]], 0.5)
    ids3 = np.array([42], np.int32)
    t2.prepare(ids3)
    t2.apply_gradients(ids3, torch.ones((1, DIM)))
    t2.persist(pdir)
    left = sorted(os.listdir(pdir))
    with open(os.path.join(pdir, toff.OFFLOAD_META_FILE)) as f:
        chain = {e["file"] for e in json.load(f)["checkpoints"]}
    assert set(left) == chain | {toff.OFFLOAD_META_FILE}, (left, chain)
    j3, t3 = host_pair()
    j3.restore(pdir)
    t3.restore(pdir)
    np.testing.assert_array_equal(t3.host_weights[42], -0.5)
    _assert_host_equal(j3, t3)


def test_bfloat16_store_matches_jax():
    """A bfloat16 table: the host store holds the rows' 16-bit words
    (numpy has no bfloat16), inserts take the per-array path (the packed
    one needs float32), and 4 steps with evictions leave the same words
    as JAX's ``ml_dtypes`` store and the same float32 slots."""
    meta = dict(datatype="bfloat16", embedding_dim=DIM,
                vocabulary_size=1024)
    init = {"category": "uniform", "minval": -0.5, "maxval": 0.5}
    kw = dict(vocab=1024, cache_capacity=256, seed=5)
    jt = joff.ShardedOffloadedTable("b", JaxMeta(**meta), SGD, init,
                                    mesh=_mesh(), **kw)
    tt = toff.ShardedOffloadedTable("b", EmbeddingVariableMeta(**meta), SGD,
                                    init, device="cpu", **kw)
    assert tt.host_weights.dtype == np.uint16
    assert tt._packed_layout(np.dtype(np.int32)) is None
    np.testing.assert_array_equal(tt.host_weights,
                                  np.asarray(jt.host_weights).view(np.uint16))
    stream = _stream(4, seed=6)
    jc = _run_stream(jt, jt.create_cache(), stream, _jax_push)
    tc = _run_stream(tt, tt.create_cache(), stream, _port_push)
    assert tt.evictions == jt.evictions > 0
    _flushed(jt, jc)
    _flushed(tt, tc)
    np.testing.assert_array_equal(tt.host_weights,
                                  np.asarray(jt.host_weights).view(np.uint16))
    np.testing.assert_array_equal(tt.host_work_id, jt.host_work_id)
