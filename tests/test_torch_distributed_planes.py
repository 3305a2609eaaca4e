"""Torch port, the cached, grouped and pipelined planes across processes
on the CPU: two ``gloo`` processes on a 2 x 2 mesh that spans them, one
data row each (``tests/test_torch_distributed.py``'s harness).

Five 5-step ``deepfm`` trajectories, each process feeding its half of
every batch: ``a2a+cache`` on the fused array tables (zipfian ids, a
refresh every 2 steps) and on the fused wide-key hash tables,
``a2a+pipelined`` on the fused array tables with a lookahead, and
``a2a+grouped`` and ``a2a+grouped+pipelined`` over a per-feature
collection of six variables (two array features and a hash feature,
dims 4 and 1). Each is held against JAX's one-process 2 x 2 mesh on 4
virtual CPU devices and against the port's one-process mesh: losses
rtol 1e-5, tables atol 1e-6 + rtol 1e-5, hash keys slot for slot, the
replica's keys equal on both ranks and to the one-process replicas',
the dense parameters equal on both ranks. Bit for bit within the two
processes' run: pipelined against serial ``a2a``, grouped+pipelined
against grouped. The cached and pipelined part dumps load in JAX's
``load_checkpoint`` on a 2 x 4 mesh and in the port's one-process mesh
equal to the two processes' tables. The workers also hold the guards
that keep the processes in step: a prime on one process only, and
``fit`` over sources of different lengths, raise on both.
"""

import os
import sys

import numpy as np
import pytest

from test_torch_distributed import (WORKER_TIMEOUT_S, _free_port, _rows,
                                    _state_arrays, run_workers)

VOCAB, DIM, BATCH, STEPS, K = 64, 4, 32, 5, 16
OPT = {"category": "adagrad", "learning_rate": 0.01}
# case -> (plane, kind): "fused" array tables, "fused-hash" wide-key
# tables, "features" per-feature variables (two array, one hash)
CASES = {"cache": ("a2a+cache", "fused"),
         "cache-hash": ("a2a+cache", "fused-hash"),
         "pipelined": ("a2a+pipelined", "fused"),
         "grouped": ("a2a+grouped", "features"),
         "grouped-pipelined": ("a2a+grouped+pipelined", "features")}
# the dumps written by the workers, loaded by JAX and one process
DUMPS = ("cache", "pipelined")


def _features():
    from openembedding_tpu_torch.data import criteo
    return tuple(criteo.SPARSE_NAMES[:3])


def _spec_kw(plane, kind) -> dict:
    """The spec makers' keywords, the same in both packages."""
    kw = dict(optimizer=OPT, plane=plane)
    if plane == "a2a+cache":
        kw.update(cache_k=K, cache_refresh_every=2)
    if kind != "fused":
        kw.update(hash_capacity=2048)
    return kw


def _vocab(kind):
    if kind == "fused":
        return VOCAB
    if kind == "fused-hash":
        return -1
    return [VOCAB, VOCAB, -1]


def _specs(plane, kind, make_fused, make_features):
    """``(specs, mapper)`` from a package's spec makers (``make_fused``,
    ``make_features``); the mapper None per feature."""
    if kind == "features":
        return make_features(_features(), _vocab(kind), DIM,
                             **_spec_kw(plane, kind)), None
    return make_fused(_criteo_names(), _vocab(kind), DIM,
                      **_spec_kw(plane, kind))


def _criteo_names():
    from openembedding_tpu_torch.data import criteo
    return criteo.SPARSE_NAMES


def _batches(kind, mapper):
    """The global batches: the fused columns, or the three features'
    ids and their ``:linear`` twins (zipfian ids either way)."""
    from openembedding_tpu_torch.data import criteo
    raw = list(criteo.synthetic_criteo(BATCH, num_buckets=VOCAB, seed=1,
                                       num_batches=STEPS))
    if mapper is not None:
        return [mapper.fuse_batch(b) for b in raw]
    feats = _features()
    return list(criteo.add_linear_columns(
        {**b, "sparse": {f: b["sparse"][f] for f in feats}} for b in raw))


def _port_setup(case, mesh):
    """The port's trainer of ``case`` on ``mesh`` and its global
    batches."""
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    plane, kind = CASES[case]
    specs, mapper = _specs(plane, kind, make_fused_specs,
                           tm.make_feature_specs)
    names = _features() if kind == "features" else _criteo_names()
    t = tr.Trainer(tm.build_model("deepfm", names, embedding_dim=DIM,
                                  dnn_units=(16, 8)),
                   EmbeddingCollection(specs, mesh), dense.adagrad(0.01))
    return t, _batches(kind, mapper)


def _train(t, batches, pipelined):
    """5 steps of the port's trainer (a lookahead on a pipelined plane):
    ``(state, losses)``."""
    from openembedding_tpu_torch.optim import initializers as ti
    s = t.init(ti.prng_key(0), batches[0])
    losses = []
    for i, b in enumerate(batches):
        kw = {"next_batch": batches[i + 1] if i + 1 < len(batches)
              else None} if pipelined else {}
        s, m = t.train_step(s, b, **kw)
        losses.append(float(m["loss"]))
    return s, losses


def _replica_keys(emb) -> dict:
    from openembedding_tpu_torch.parallel import hot_cache
    return {f"{n}/replica": st.cache.keys.numpy().copy()
            for n, st in emb.items() if isinstance(st, hot_cache.CachedState)}


# --- the workers -------------------------------------------------------------

def _worker_case(rank, mesh, case, out):
    """One trajectory on this process's half of every batch; the losses,
    tables, replica keys and dense parameters to ``out``. Pipelined
    cases feed placed slices (the lookahead is keyed on the batch
    object); the cached and pipelined cases save part dumps."""
    from openembedding_tpu_torch import checkpoint as tck
    t, batches = _port_setup(case, mesh)
    half = BATCH // 2
    local = [t.shard_batch(_rows(b, rank * half, (rank + 1) * half))
             for b in batches]
    s, losses = _train(t, local, "pipelined" in case)
    assert t.builds == 1, t.builds
    if case.startswith("cache"):
        # refreshes after steps 2 and 4: steps 3 and 5 hit the replica
        assert [m.refreshes for m in t._hot.values()] == [2, 2]
        assert all((st.cache.keys >= 0).any() for st in s.emb.values())
    res = {"losses": np.asarray(losses), **_state_arrays(s.emb),
           **_replica_keys(s.emb),
           **{f"param/{k}": v.numpy() for k, v in s.params.items()}}
    if case == "pipelined":
        _pipeline_guards(t, s, local, rank)
        s = t.drain_pipeline(s)
    np.savez(os.path.join(out, f"{case}.{rank}.npz"), **res)
    if case in DUMPS:
        tck.save_checkpoint(os.path.join(out, f"{case}_dump"),
                            t.collection, s.emb)


def _pipeline_guards(t, s, local, rank):
    """A prime on rank 0 only, and ``fit`` over 2 batches on rank 0
    against 3 on rank 1: both raise on both ranks, before any step."""
    step = int(s.step)
    if rank == 0:
        s = t.drain_pipeline(s)
    with pytest.raises(ValueError, match="pipeline primes"):
        t.train_step(s, local[-1], next_batch=None)
    with pytest.raises(ValueError, match="fit's window"):
        t.fit(s, local[:2 + rank])
    assert int(s.step) == step


def _worker_serial(rank, mesh, out):
    """The pipelined case's batches on serial ``a2a`` (its bit-for-bit
    baseline) across the same processes."""
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    specs, mapper = make_fused_specs(_criteo_names(), VOCAB, DIM,
                                     optimizer=OPT)
    t = tr.Trainer(tm.build_model("deepfm", _criteo_names(),
                                  embedding_dim=DIM, dnn_units=(16, 8)),
                   EmbeddingCollection(specs, mesh), dense.adagrad(0.01))
    half = BATCH // 2
    local = [t.shard_batch(_rows(b, rank * half, (rank + 1) * half))
             for b in _batches("fused", mapper)]
    s, losses = _train(t, local, False)
    np.savez(os.path.join(out, f"serial.{rank}.npz"),
             losses=np.asarray(losses), **_state_arrays(s.emb))


def _worker(rank: int, port: str, out: str) -> None:
    import torch
    torch.set_num_threads(2)
    from openembedding_tpu_torch import distributed
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                           device="cpu", timeout=WORKER_TIMEOUT_S)
    mesh = distributed.create_global_mesh(data=2, model=2)
    for case in CASES:
        _worker_case(rank, mesh, case, out)
    _worker_serial(rank, mesh, out)
    distributed.barrier("done")
    distributed.shutdown()
    print(f"worker {rank}: ok", flush=True)


# --- the parent --------------------------------------------------------------

@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist_planes"))
    port = _free_port()
    outs = run_workers(lambda r: [sys.executable, os.path.abspath(__file__),
                                  str(r), str(port), out],
                       WORKER_TIMEOUT_S)
    for r, o in enumerate(outs):
        assert f"worker {r}: ok" in o, o
    return out


def _ranks(workers, case):
    """Both ranks' results, the dense parameters equal bit for bit, and
    the tables as one process's stacked arrays (shards in rank order)."""
    r0 = dict(np.load(os.path.join(workers, f"{case}.0.npz")))
    r1 = dict(np.load(os.path.join(workers, f"{case}.1.npz")))
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    tables = {}
    for k in r0:
        if k.startswith("param/") or k.endswith("/replica"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        elif k != "losses":
            tables[k] = np.concatenate([r0[k], r1[k]])
    return r0, tables


def _jax_run(case, devices8, batches):
    """JAX's one-process 2 x 2 trainer of ``case`` on the global batches:
    ``(losses, emb)``."""
    import jax
    import optax
    import openembedding_tpu as oe
    from openembedding_tpu import Trainer as JaxTrainer
    from openembedding_tpu.fused import make_fused_specs as jax_fused
    from openembedding_tpu.models import deepctr as jax_models
    from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
    plane, kind = CASES[case]
    jspecs, _ = _specs(plane, kind, jax_fused,
                       jax_models.make_feature_specs)
    names = _features() if kind == "features" else _criteo_names()
    jt = JaxTrainer(jax_models.build_model("deepfm", names,
                                           dnn_units=(16, 8)),
                    oe.EmbeddingCollection(jspecs,
                                           jax_mesh(2, 2, devices8[:4])),
                    optax.adagrad(0.01))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    losses = []
    for i, b in enumerate(batches):
        kw = {"next_batch": batches[i + 1] if i + 1 < len(batches)
              else None} if "pipelined" in case else {}
        js, m = jt.train_step(js, b, **kw)
        losses.append(float(m["loss"]))
    return losses, js.emb


@pytest.mark.parametrize("case", list(CASES))
def test_planes_across_processes_match_one(workers, devices8, case):
    """5 steps of the two-process trainer against the port's one-process
    2 x 2 mesh and JAX's: losses rtol 1e-5, tables atol 1e-6 + rtol
    1e-5, hash keys slot for slot, replica keys equal everywhere; dense
    parameters equal on both ranks; pipelined = serial and
    grouped+pipelined = grouped bit for bit across the processes."""
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    r0, tables = _ranks(workers, case)
    t, batches = _port_setup(case, create_mesh(2, 2, device="cpu"))
    s, losses = _train(t, batches, "pipelined" in case)
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    one = _state_arrays(s.emb)
    assert one.keys() == tables.keys()
    for k, v in one.items():
        if k.endswith("/keys"):
            np.testing.assert_array_equal(tables[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(tables[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    replicas = _replica_keys(s.emb)
    assert replicas.keys() == {k for k in r0 if k.endswith("/replica")}
    for k, v in replicas.items():
        np.testing.assert_array_equal(r0[k], v, err_msg=k)
    jl, jemb = _jax_run(case, devices8, batches)
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    for name, jst in jemb.items():
        if f"{name}/replica" in r0:
            np.testing.assert_array_equal(r0[f"{name}/replica"],
                                          np.asarray(jst.cache.keys))
        jst = jst.table if hasattr(jst, "table") else jst
        np.testing.assert_allclose(tables[f"{name}/weights"],
                                   np.asarray(jst.weights), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        if f"{name}/keys" in tables:
            np.testing.assert_array_equal(tables[f"{name}/keys"],
                                          np.asarray(jst.keys))
    base = {"pipelined": "serial", "grouped-pipelined": "grouped"}.get(case)
    if base is not None:
        b0 = dict(np.load(os.path.join(workers, f"{base}.0.npz")))
        np.testing.assert_array_equal(r0["losses"], b0["losses"])
        for k in tables:
            np.testing.assert_array_equal(r0[k], b0[k], err_msg=k)


@pytest.mark.parametrize("case", DUMPS)
def test_part_dumps_load_in_jax_and_one_process(workers, devices8, case):
    """The cached and the (drained) pipelined trajectories' part dumps,
    written by both processes: JAX's ``load_checkpoint`` on a 2 x 4 mesh
    and the port's on the one-process 2 x 2 mesh of the same plane give
    every row of the two processes' tables (a cached dump holds the
    table, not the replica)."""
    import jax.numpy as jnp
    import openembedding_tpu as oe
    from openembedding_tpu import checkpoint as jax_ckpt
    from openembedding_tpu.fused import make_fused_specs as jax_fused
    from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
    from openembedding_tpu_torch import checkpoint as tck
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.parallel import hot_cache
    from openembedding_tpu_torch.parallel import sharded_table as st
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    _, tables = _ranks(workers, case)
    d = os.path.join(workers, f"{case}_dump")
    jspecs, _ = jax_fused(_criteo_names(), VOCAB, DIM, optimizer=OPT)
    jcoll = oe.EmbeddingCollection(jspecs, jax_mesh(2, 4, devices8[:8]))
    jl = jax_ckpt.load_checkpoint(d, jcoll)
    plane, kind = CASES[case]
    tspecs, _ = _specs(plane, kind, make_fused_specs, None)
    coll = EmbeddingCollection(tspecs, create_mesh(2, 2, device="cpu"))
    tl = tck.load_checkpoint(d, coll)
    for spec in tspecs:
        ids = np.arange(spec.input_dim, dtype=np.int32)
        jrows = np.asarray(jcoll.pull(jl, {spec.name: jnp.asarray(ids)},
                                      batch_sharded=False)[spec.name])
        phys = st.logical_to_physical(coll.sharding_spec(spec.name),
                                      spec.input_dim, "cpu").numpy()
        want = tables[f"{spec.name}/weights"]
        np.testing.assert_array_equal(jrows, want[phys], err_msg=spec.name)
        got = hot_cache.unwrap(tl[spec.name])
        np.testing.assert_array_equal(got.weights.numpy(), want,
                                      err_msg=spec.name)
        for k, v in got.slots.items():
            np.testing.assert_array_equal(
                v.numpy(), tables[f"{spec.name}/slot_{k}"], err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
