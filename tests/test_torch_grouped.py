"""Torch port, the grouped multi-table exchange (``parallel/grouped.py``)
against the port's per-table ``a2a`` loop and JAX's grouped plane on 2 x 2
meshes (``tests/test_grouped.py``'s cases).

Four tables (dims 3 and 4 share a bucket of 4 with a pooled member, dim 6
takes 8), array, int32 hash and wide hash, zipf and uniform streams with
out-of-range ids and padding; constant init, so every collection starts
equal. Pulls and states agree at the JAX test's tolerance (rtol 1e-5,
atol 1e-6: only the add order of duplicate gradients may differ); the
planner's groups, the windows' static sizes and the counters equal
JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import hash_table as jht
from openembedding_tpu.parallel import grouped as jgrouped
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.optim.optimizers import make_optimizer
from openembedding_tpu_torch.parallel import grouped
from openembedding_tpu_torch.parallel import sharded_table as st
from openembedding_tpu_torch.parallel.mesh import create_mesh
from openembedding_tpu_torch.utils import observability

OPT = {"category": "adagrad", "learning_rate": 0.1}
INIT = {"category": "constant", "value": 0.25}
B, L = 32, 4
TOL = dict(rtol=1e-5, atol=1e-6)


def _spec_kw(kind, plane):
    common = dict(optimizer=OPT, initializer=INIT, plane=plane)
    if kind == "array":
        return [dict(name="t3", input_dim=64, output_dim=3, **common),
                dict(name="t4", input_dim=96, output_dim=4, **common),
                dict(name="t6", input_dim=48, output_dim=6, **common),
                dict(name="tp", input_dim=64, output_dim=3, pooling="mean",
                     **common)]
    key_dtype = "int32" if kind == "hash32" else "wide"
    hk = dict(input_dim=-1, hash_capacity=4096, key_dtype=key_dtype,
              **common)
    return [dict(name="t3", output_dim=3, **hk),
            dict(name="t4", output_dim=4, **hk),
            dict(name="t6", output_dim=6, **hk),
            dict(name="tp", output_dim=3, pooling="sum", **hk)]


def _colls(devices8, kind, plane):
    kws = _spec_kw(kind, plane)
    return (oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in kws],
                                   jax_mesh(2, 2, devices8[:4])),
            EmbeddingCollection([EmbeddingSpec(**k) for k in kws],
                                create_mesh(2, 2, device="cpu")))


def _draw(rng, dist, hi, size):
    if dist == "uniform":
        return rng.randint(0, hi, size).astype(np.int64)
    probs = np.arange(1, hi + 1, dtype=np.float64) ** -1.1
    probs /= probs.sum()
    return rng.choice(hi, size=size, p=probs).astype(np.int64)


def _batch(rng, kind, dist):
    if kind == "array":
        vocab = {"t3": 64, "t4": 96, "t6": 48}
        out = {n: _draw(rng, dist, v, B).astype(np.int32)
               for n, v in vocab.items()}
        out["t4"][::7] = -1
        out["t4"][1::9] = 96 + 5
        pool = _draw(rng, dist, 64, (B, L)).astype(np.int32)
        pool[:, -1] = -1
        out["tp"] = pool
        return out
    out = {n: _draw(rng, dist, 100_000, B) for n in ("t3", "t4", "t6")}
    if kind == "hash32":
        out = {n: v.astype(np.int32) for n, v in out.items()}
    pool = _draw(rng, dist, 100_000, (B, L))
    pool[:, -1] = jht.empty_key(np.int64)
    out["tp"] = pool if kind != "hash32" else np.where(
        pool == jht.empty_key(np.int64), jht.empty_key(np.int32),
        pool).astype(np.int32)
    return out


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("kind,dist", [("array", "zipf"), ("wide", "zipf"),
                                       ("hash32", "uniform")])
def test_grouped_matches_per_table_and_jax(devices8, kind, dist):
    """2 steps: the grouped pulls and states against the port's per-table
    ``a2a`` and JAX's grouped plane; the read-only contract (missing keys
    give zero rows) on hash groups."""
    jc, cg = _colls(devices8, kind, "a2a+grouped")
    _, ca = _colls(devices8, kind, "a2a")
    assert cg.grouped_names() == ("t3", "t4", "t6", "tp") \
        == jc.grouped_names()
    js, sg, sa = (jc.init(jax.random.PRNGKey(3)), cg.init(ti.prng_key(3)),
                  ca.init(ti.prng_key(3)))
    rng = np.random.RandomState(7)
    for _ in range(2):
        inp = _batch(rng, kind, dist)
        rg, ra, rj = cg.pull(sg, inp), ca.pull(sa, inp), jc.pull(js, inp)
        for n in inp:
            np.testing.assert_allclose(rg[n].numpy(), ra[n].numpy(), **TOL,
                                       err_msg=f"pull:{n}")
            np.testing.assert_allclose(rg[n].numpy(), _np(rj[n]), **TOL,
                                       err_msg=f"jax pull:{n}")
        grads = {n: rng.randn(*ra[n].shape).astype(np.float32)
                 for n in inp}
        cg.apply_gradients(sg, inp, {n: torch.from_numpy(g)
                                     for n, g in grads.items()})
        ca.apply_gradients(sa, inp, {n: torch.from_numpy(g)
                                     for n, g in grads.items()})
        js = jc.apply_gradients(js, inp, {n: jnp.asarray(g)
                                          for n, g in grads.items()})
    for n in ("t3", "t4", "t6", "tp"):
        for a, b, j in ((sg[n].weights, sa[n].weights, js[n].weights),) + \
                tuple((sg[n].slots[k], sa[n].slots[k], js[n].slots[k])
                      for k in sg[n].slots):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
            np.testing.assert_allclose(a.numpy(), _np(j), **TOL)
        if kind != "array":
            assert int(sg[n].insert_failures) \
                == int(sa[n].insert_failures) \
                == int(js[n].insert_failures)
            np.testing.assert_array_equal(sg[n].keys.numpy(),
                                          _np(js[n].keys))
    if kind != "array":
        probe = {"t3": np.arange(50, 150).astype(
            np.int32 if kind == "hash32" else np.int64)}
        pg = cg.pull(sg, probe, read_only=True)["t3"]
        pa = ca.pull(sa, probe, read_only=True)["t3"]
        np.testing.assert_allclose(pg.numpy(), pa.numpy(), **TOL)


def test_plan_groups_static_key(devices8):
    """Bucket 4 holds dims 3 and 4 and the pooled member, bucket 8 dim 6,
    with JAX's offset bases; int32 and wide hash keys never share a
    stream; the plans equal JAX's."""
    jc, tc = _colls(devices8, "array", "a2a+grouped")
    names = ("t3", "t4", "t6", "tp")

    def shape(plans):
        return [(p.kind, p.bucket_dim, p.key_dtype, p.bases,
                 tuple(m.name for m in p.members)) for p in plans]
    plans = grouped.plan_groups(tc, names)
    assert shape(plans) == shape(jgrouped.plan_groups(jc, names))
    assert shape(plans)[0][1:] == (4, "int32", (0, 64, 160, 224),
                                   ("t3", "t4", "tp"))
    mixed_kw = _spec_kw("hash32", "a2a+grouped")[:2] \
        + _spec_kw("wide", "a2a+grouped")[2:]
    jm = oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in mixed_kw],
                                jax_mesh(2, 2, devices8[:4]))
    tmx = EmbeddingCollection([EmbeddingSpec(**k) for k in mixed_kw],
                              create_mesh(2, 2, device="cpu"))
    key = {tuple(m.name for m in p.members): (p.kind, p.key_dtype)
           for p in grouped.plan_groups(tmx, names)}
    assert key == {("t3", "t4"): ("hash", "int32"),
                   ("t6",): ("hash", "wide"), ("tp",): ("hash", "wide")}
    assert shape(grouped.plan_groups(tmx, names)) \
        == shape(jgrouped.plan_groups(jm, names))


def test_plan_groups_offset_span_split():
    """Groups split before their padded vocabularies leave int32."""
    specs = [EmbeddingSpec(f"big{i}", 1 << 30, 4, optimizer=OPT,
                           initializer=INIT, plane="a2a+grouped")
             for i in range(3)]
    coll = EmbeddingCollection(specs, create_mesh(2, 2, device="cpu"),
                               default_initializer=INIT)
    plans = grouped.plan_groups(coll, tuple(s.name for s in specs))
    assert [len(p.members) for p in plans] == [1, 1, 1]
    assert all(p.bases[-1] <= 2**31 - 1 for p in plans)


def test_plan_groups_rejects_other_planes():
    coll = EmbeddingCollection(
        [EmbeddingSpec(**k) for k in _spec_kw("array", "a2a")],
        create_mesh(2, 2, device="cpu"))
    with pytest.raises(ValueError, match="a2a\\+grouped"):
        grouped.plan_groups(coll, ("t3",))
    assert coll.grouped_names() == ()


def test_stream_bounds_and_windows_match_jax():
    """A member's window is its global entry count before dedup (a
    static size); each owner's sorted stream is cut at the member's first
    entry, clamped into range: the windows JAX's owners take."""
    rng = np.random.RandomState(1)
    bases = (0, 64, 160, 224)
    stream = np.concatenate([rng.randint(bases[t], bases[t + 1], 20 + 7 * t)
                             for t in range(3)]).astype(np.int32)
    stream[::5] = -2**31
    rng.shuffle(stream)
    bounds = (25, 11, 30)
    plan = grouped.GroupPlan(kind="array", bucket_dim=4, key_dtype="int32",
                             members=(None,) * 3, bases=bases)
    assert grouped._stream_bounds(plan, [torch.zeros(25), torch.zeros(11),
                                         torch.zeros(3, 10)]) == bounds
    col = torch.from_numpy(np.stack([stream, stream[::-1].copy()]))
    got = list(grouped._sorted_member_windows(col, bounds, bases[:-1]))
    for row in range(2):
        want = list(jgrouped._sorted_member_windows(
            jnp.asarray(col[row].numpy()), bounds, bases[:-1]))
        for (t, (kw, ow)), (jt, (jkw, jow)) in zip(got, want):
            assert t == jt
            np.testing.assert_array_equal(kw[row].numpy(), _np(jkw))
            np.testing.assert_array_equal(ow[row].numpy(), _np(jow))


def test_grouped_composes_with_cache_plane(devices8):
    """Grouped tables beside a cached and a psum table: every variable's
    pulls and logical rows as on the all-``a2a`` collection, and as JAX's
    mixed collection."""
    def kws(planes):
        return [dict(name=n, input_dim=64, output_dim=4, optimizer=OPT,
                     initializer=INIT, plane=p) for n, p in planes.items()]
    mixed = {"g1": "a2a+grouped", "g2": "a2a+grouped",
             "hot": "a2a+cache", "base": "psum"}
    tm = EmbeddingCollection([EmbeddingSpec(**k) for k in kws(mixed)],
                             create_mesh(2, 2, device="cpu"))
    ta = EmbeddingCollection(
        [EmbeddingSpec(**k) for k in kws({n: "a2a" for n in mixed})],
        create_mesh(2, 2, device="cpu"))
    jm = oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in kws(mixed)],
                                jax_mesh(2, 2, devices8[:4]))
    assert tm.grouped_names() == ("g1", "g2")
    sm, sa, js = (tm.init(ti.prng_key(5)), ta.init(ti.prng_key(5)),
                  jm.init(jax.random.PRNGKey(5)))
    mgr = tm.make_hot_cache_manager("hot")
    rng = np.random.RandomState(11)
    for step in range(3):
        inp = {n: rng.randint(0, 64, B).astype(np.int32) for n in mixed}
        rm, ra = tm.pull(sm, inp), ta.pull(sa, inp)
        for n in mixed:
            np.testing.assert_allclose(rm[n].numpy(), ra[n].numpy(), **TOL,
                                       err_msg=n)
        grads = {n: rng.randn(B, 4).astype(np.float32) for n in mixed}
        tm.apply_gradients(sm, inp, {n: torch.from_numpy(g)
                                     for n, g in grads.items()})
        ta.apply_gradients(sa, inp, {n: torch.from_numpy(g)
                                     for n, g in grads.items()})
        js = jm.apply_gradients(js, inp, {n: jnp.asarray(g)
                                          for n, g in grads.items()})
        mgr.observe(inp["hot"])
        if step == 0:
            mgr.refresh(sm["hot"])     # the replica serves from step 2
    probe = {n: np.arange(64, dtype=np.int32) for n in mixed}
    pm, pa, pj = tm.pull(sm, probe), ta.pull(sa, probe), jm.pull(js, probe)
    for n in mixed:
        np.testing.assert_allclose(pm[n].numpy(), pa[n].numpy(), **TOL,
                                   err_msg=n)
        np.testing.assert_allclose(pm[n].numpy(), _np(pj[n]), **TOL,
                                   err_msg=n)


def test_per_table_fallback_on_grouped_spec():
    """A grouped table addressed per table (serving, checkpoints) runs
    the plain ``a2a`` exchange: the same rows and updates."""
    mesh = create_mesh(2, 2, device="cpu")
    meta = EmbeddingVariableMeta(embedding_dim=4, vocabulary_size=64)
    states, specs = {}, {}
    for plane in ("a2a", "a2a+grouped"):
        specs[plane] = st.make_sharding_spec(meta, mesh, plane=plane)
        states[plane] = st.create_sharded_table(
            meta, OPT, INIT, mesh=mesh, spec=specs[plane],
            rng=ti.prng_key(2))
    idx = torch.arange(64, dtype=torch.int32)
    rows = {p: st.pull_sharded(states[p], idx, mesh=mesh, spec=specs[p])
            for p in specs}
    assert torch.equal(rows["a2a+grouped"], rows["a2a"])
    g = torch.from_numpy(np.random.RandomState(0).randn(64, 4).astype(
        np.float32))
    for p in specs:
        st.apply_gradients_sharded(states[p], make_optimizer(OPT), idx, g,
                                   mesh=mesh, spec=specs[p])
    assert torch.equal(states["a2a+grouped"].weights,
                       states["a2a"].weights)


def test_grouped_counters_and_plane_timings(devices8):
    """Gated counters: 2 groups a dispatch, pull and push, JAX's
    ``grouped_exchange_bytes``; the pull and push times land under
    ``a2a+grouped``; nothing is recorded with the gate off."""
    jc, tc = _colls(devices8, "array", "a2a+grouped")
    states, js = tc.init(ti.prng_key(0)), jc.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    inp = _batch(rng, "array", "uniform")
    grads = {n: rng.randn(*(np.shape(v)[:1] + (dim,))).astype(np.float32)
             for (n, v), dim in zip(inp.items(), (3, 4, 6, 3))}
    observability.GLOBAL.reset()
    tc.pull(states, inp)
    assert "grouped_groups" not in observability.GLOBAL.snapshot()
    snaps = []
    for o, run in (
            (observability, lambda: (
                tc.pull(states, inp),
                tc.apply_gradients(states, inp, {
                    n: torch.from_numpy(g) for n, g in grads.items()}))),
            (jobs, lambda: (
                jc.pull(js, inp),
                jc.apply_gradients(js, inp, {
                    n: jnp.asarray(g) for n, g in grads.items()})))):
        o.GLOBAL.reset()
        o.set_evaluate_performance(True)
        try:
            run()
        finally:
            o.set_evaluate_performance(False)
        snaps.append((o.GLOBAL.snapshot(), o.plane_timings()))
        o.GLOBAL.reset()
    (snap, timings), (jsnap, _) = snaps
    assert snap["grouped_groups"]["count"] == 4 \
        == jsnap["grouped_groups"]["count"]
    assert snap["grouped_exchange_bytes"]["count"] \
        == jsnap["grouped_exchange_bytes"]["count"] > 0
    assert timings["a2a+grouped"]["pull_calls"] == 2
    assert timings["a2a+grouped"]["push_calls"] == 2
    assert timings["a2a+grouped"]["pull_ms"] >= 0.0
