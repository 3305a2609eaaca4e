"""Torch port, training across processes (``distributed.py``) on the CPU:
two ``gloo`` processes on a 2 x 2 mesh that spans them, one data row
each.

The workers are this file run as a script (they import no JAX). Their
cases are JAX's (``tests/distributed_worker.py``): barrier, broadcast,
row 5 at -8.0 after one step whose gradients come from both processes,
the part checkpoint reloaded on the same cluster, and ``mode='delta'``
refused. Then 5 ``deepfm`` steps at small width on ``a2a`` and ``psum``,
array and hash, and one case each of ``+bf16`` and ``+int8``: the
two-process losses and tables are held against JAX's one-process 2 x 2
mesh on 4 virtual CPU devices and against the port's one-process mesh
(losses rtol 1e-5, tables atol 1e-6 + rtol 1e-5), the dense parameters
equal on both ranks. Bit for bit: the hash keys slot for slot, the
``psum`` replicas of the two ranks, and JAX's SGD cases; the tables of a
trajectory are not, since the dense gradients reach the update as the
sum of the two processes' halves and the loss as the sum of their
shares, each rounded apart from one process's sum over the whole batch.
The port's two-process part dump loads in JAX's ``load_checkpoint`` on
a 2 x 4 mesh and gives the same rows.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

VOCAB, DIM, BATCH, STEPS = 64, 4, 32, 5
# (plane, vocab): vocab -1 is the wide-key hash table
CASES = {"a2a": ("a2a", VOCAB), "psum": ("psum", VOCAB),
         "a2a-hash": ("a2a", -1), "psum-hash": ("psum", -1),
         "a2a+bf16": ("a2a+bf16", VOCAB), "a2a+int8": ("a2a+int8", VOCAB)}
WORKER_TIMEOUT_S = 150


def _specs(plane, vocab):
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.fused import make_fused_specs
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01},
              plane=plane)
    if vocab == -1:
        kw.update(hash_capacity=2048, key_dtype="wide")
    return make_fused_specs(criteo.SPARSE_NAMES, vocab, DIM, **kw)


def _batches(mapper):
    from openembedding_tpu_torch.data import criteo
    return [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=1, num_batches=STEPS)]


def _rows(batch, lo, hi):
    """Rows ``lo:hi`` of every leaf of a batch."""
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    return None if batch is None else np.asarray(batch)[lo:hi]


def _trainer(specs, mesh):
    from openembedding_tpu_torch import training as tr
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.models import deepctr as tm
    from openembedding_tpu_torch.optim import dense
    return tr.Trainer(
        tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=DIM,
                       dnn_units=(16, 8)),
        EmbeddingCollection(specs, mesh), dense.adagrad(0.01))


def _state_arrays(emb) -> dict:
    """A collection's tables as numpy arrays (the tables, not a plane's
    derived state): ``<name>/<field>``."""
    from openembedding_tpu_torch.parallel import hot_cache
    out = {}
    for name, st in emb.items():
        st = hot_cache.unwrap(st)
        out[f"{name}/weights"] = st.weights.numpy().copy()
        for k, v in st.slots.items():
            out[f"{name}/slot_{k}"] = v.numpy().copy()
        if hasattr(st, "keys"):
            out[f"{name}/keys"] = st.keys.numpy().copy()
    return out


# --- the workers -------------------------------------------------------------

def _worker_basic(rank, mesh, out):
    """JAX's worker cases; the part dump goes to ``out/basic``."""
    import torch
    from openembedding_tpu_torch import checkpoint as tck
    from openembedding_tpu_torch import distributed
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.parallel import sharded_hash
    distributed.barrier("boot")
    v = distributed.broadcast(np.asarray([123.0 + rank], np.float32))
    assert float(v[0]) == 123.0, v
    v = distributed.broadcast({"rank": rank, "t": torch.tensor([rank])},
                              is_source=rank == 1)
    assert v["rank"] == 1 and v["t"].tolist() == [1], v
    # a value that must agree across processes raises on every one
    distributed.check_agree(7, "equal values pass")
    with pytest.raises(ValueError, match="set alike"):
        distributed.check_agree(rank, "set alike")
    sgd = {"category": "sgd", "learning_rate": 1.0}
    spec = EmbeddingSpec(name="t", input_dim=32, output_dim=4,
                         initializer={"category": "constant", "value": 0.0},
                         optimizer=sgd)
    hspec = EmbeddingSpec(name="h", input_dim=-1, output_dim=4,
                          hash_capacity=256, optimizer=sgd,
                          initializer={"category": "constant",
                                       "value": 0.25})
    coll = EmbeddingCollection((spec, hspec), mesh)
    states = coll.init()
    # 4 rows a process, global 8, every one row 5 with gradient 1: -8
    # only if the gradients crossed the process boundary
    gb = distributed.local_batch_to_global(
        {"t": np.full((4,), 5, np.int32)}, mesh)
    rows = coll.pull(states, gb)
    assert tuple(rows["t"].shape) == (4, 4)
    coll.apply_gradients(states, gb, {"t": torch.ones_like(rows["t"])})
    probe = distributed.local_batch_to_global(
        {"t": np.asarray([5, 6] if rank == 0 else [5, 7], np.int32)}, mesh)
    got = coll.pull(states, probe)["t"][:, 0].tolist()
    assert got == [-8.0, 0.0], got
    hk = distributed.local_batch_to_global(
        {"h": np.asarray([1001, 1002] if rank == 0 else [1003, 1004],
                         np.int32)}, mesh)
    coll.apply_gradients(states, hk, {"h": torch.ones((2, 4))})
    assert sharded_hash.total_insert_failures(
        states["h"], mesh, coll.sharding_spec("h")) == 0
    d = os.path.join(out, "basic")
    tck.save_checkpoint(d, coll, states, model_sign="mh-1")
    with pytest.raises(ValueError, match="single-process"):
        tck.save_checkpoint(d, coll, states, mode="delta")
    loaded = tck.load_checkpoint(d, coll)
    assert coll.pull(loaded, probe)["t"][:, 0].tolist() == [-8.0, 0.0]
    hprobe = distributed.local_batch_to_global(
        {"h": np.asarray([1001, 1003] if rank == 0 else [1004, 9999],
                         np.int32)}, mesh)
    hrows = coll.pull(loaded, hprobe, read_only=True)["h"][:, 0].tolist()
    assert hrows == ([0.25 - 1.0] * 2 if rank == 0 else [0.25 - 1.0, 0.0])
    # failed inserts: an a2a table's total sums the processes' shards, a
    # psum replica counts its own (every process holds the same)
    for plane in ("a2a", "psum"):
        tiny = EmbeddingSpec(name="tiny", input_dim=-1, output_dim=4,
                             hash_capacity=16, optimizer=sgd, plane=plane)
        tcoll = EmbeddingCollection((tiny,), mesh)
        tstates = tcoll.init()
        keys = distributed.local_batch_to_global(
            {"tiny": np.arange(64, dtype=np.int32) + 1000 * rank}, mesh)
        tcoll.apply_gradients(tstates, keys, {"tiny": torch.ones((64, 4))})
        mine = int(tstates["tiny"].insert_failures)
        r0, r1 = (int(distributed.broadcast(np.asarray([mine]),
                                            is_source=rank == r)[0])
                  for r in (0, 1))
        total = sharded_hash.total_insert_failures(
            tstates["tiny"], mesh, tcoll.sharding_spec("tiny"))
        assert mine > 0, (plane, mine)
        if plane == "a2a":
            assert total == r0 + r1, (total, r0, r1)
        else:
            assert r0 == r1 == total == mine, (total, r0, r1)


def _worker_case(rank, mesh, case, out):
    """One trajectory: 5 steps on this process's half of each batch; the
    losses, the tables held and the dense parameters to ``out``; the
    ``a2a`` array case also saves a part dump."""
    from openembedding_tpu_torch import checkpoint as tck
    from openembedding_tpu_torch.optim import initializers as ti
    plane, vocab = CASES[case]
    specs, mapper = _specs(plane, vocab)
    t = _trainer(specs, mesh)
    half = BATCH // 2
    local = [_rows(b, rank * half, (rank + 1) * half)
             for b in _batches(mapper)]
    s = t.init(ti.prng_key(0), local[0])
    with pytest.raises(ValueError, match="single-process"):
        t.fit(s, local, autosave_every=1, autosave_dir=out)
    assert int(s.step) == 0
    losses = []
    for b in local:
        s, m = t.train_step(s, t.shard_batch(b))
        losses.append(float(m["loss"]))
    res = {"losses": np.asarray(losses), **_state_arrays(s.emb),
           **{f"param/{k}": v.numpy() for k, v in s.params.items()},
           "builds": np.asarray(t.builds)}
    np.savez(os.path.join(out, f"{case}.{rank}.npz"), **res)
    if case == "a2a":
        tck.save_checkpoint(os.path.join(out, "a2a_dump"), t.collection,
                            s.emb)


def _worker(rank: int, port: str, out: str) -> None:
    import torch
    torch.set_num_threads(2)
    from openembedding_tpu_torch import distributed
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                           device="cpu", timeout=WORKER_TIMEOUT_S)
    assert distributed.num_workers() == 2
    assert distributed.worker_rank() == rank
    mesh = distributed.create_global_mesh(data=2, model=2)
    assert list(mesh.local_positions) == [2 * rank, 2 * rank + 1]
    _worker_basic(rank, mesh, out)
    for case in CASES:
        _worker_case(rank, mesh, case, out)
    distributed.barrier("done")
    distributed.shutdown()
    print(f"worker {rank}: ok", flush=True)


# --- the parent --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(argv_of, timeout: float):
    """Start one worker a rank (``argv_of(rank)``), wait for both; a
    worker that fails or a timeout kills the other and fails. Returns
    their outputs."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(argv_of(r), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} exited {p.returncode}:\n{o}"
    return outs


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    port = _free_port()
    outs = run_workers(lambda r: [sys.executable, os.path.abspath(__file__),
                                  str(r), str(port), out],
                       WORKER_TIMEOUT_S)
    for r, o in enumerate(outs):
        assert f"worker {r}: ok" in o, o
    return out


def test_run_workers_fails_on_a_failing_worker():
    """A worker that exits nonzero fails the run at once (its peer,
    blocked in a collective, is killed), never waiting out the timeout."""
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match="exited"):
        run_workers(lambda r: [sys.executable, "-c",
                               "import sys, time; time.sleep(60)" if r
                               else "import sys; sys.exit(3)"], 60)
    assert time.monotonic() - t0 < 30


def test_worker_cases(workers, devices8):
    """JAX's worker cases passed in both processes (asserted there); the
    two-process part dump loads in JAX's ``load_checkpoint`` on a 2 x 4
    mesh and in the port's one-process 2 x 2 mesh, rows exact."""
    import jax.numpy as jnp
    import openembedding_tpu as oe
    from openembedding_tpu import checkpoint as jax_ckpt
    from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
    from openembedding_tpu_torch import checkpoint as tck
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    d = os.path.join(workers, "basic")
    files = os.listdir(os.path.join(d, "var_0_t.d"))
    assert {f.split("_", 1)[0] for f in files} == {"part0", "part1"}, files
    assert {"part0_ids.npy", "part1_weights.npy"} <= set(files), files
    sgd = {"category": "sgd", "learning_rate": 1.0}
    kw = [dict(name="t", input_dim=32, output_dim=4, optimizer=sgd,
               initializer={"category": "constant", "value": 0.0}),
          dict(name="h", input_dim=-1, output_dim=4, hash_capacity=256,
               optimizer=sgd,
               initializer={"category": "constant", "value": 0.25})]
    jcoll = oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in kw],
                                   jax_mesh(2, 4, devices8[:8]))
    jl = jax_ckpt.load_checkpoint(d, jcoll)
    jrows = np.asarray(jcoll.pull(jl, {"t": jnp.asarray([5, 6, 7])},
                                  batch_sharded=False)["t"])
    np.testing.assert_array_equal(jrows[:, 0], [-8.0, 0.0, 0.0])
    jh = np.asarray(jcoll.pull(jl, {"h": jnp.asarray([1002, 1004, 77])},
                               batch_sharded=False, read_only=True)["h"])
    np.testing.assert_array_equal(jh[:, 0], [0.25 - 1.0, 0.25 - 1.0, 0.0])
    coll = EmbeddingCollection([EmbeddingSpec(**k) for k in kw],
                               create_mesh(2, 2, device="cpu"))
    tl = tck.load_checkpoint(d, coll)
    probe = {"t": np.arange(32, dtype=np.int32),
             "h": np.asarray([1001, 1002, 1003, 1004, 77], np.int32)}
    trows = coll.pull(tl, probe, read_only=True, batch_sharded=False)
    np.testing.assert_array_equal(
        trows["t"].numpy(),
        np.asarray(jcoll.pull(jl, {"t": jnp.asarray(probe["t"])},
                              batch_sharded=False)["t"]))
    np.testing.assert_array_equal(
        trows["h"].numpy(),
        np.asarray(jcoll.pull(jl, {"h": jnp.asarray(probe["h"])},
                              batch_sharded=False, read_only=True)["h"]))


def _global_arrays(workers, case, plane):
    """The two ranks' tables as one process's stacked arrays: ``a2a``
    shards concatenated in rank order; a ``psum`` replica, equal on both
    ranks bit for bit."""
    r0 = dict(np.load(os.path.join(workers, f"{case}.0.npz")))
    r1 = dict(np.load(os.path.join(workers, f"{case}.1.npz")))
    for k in r0:
        if k.startswith("param/"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    tables = {}
    for k in r0:
        if k.startswith("param/") or k in ("losses", "builds"):
            continue
        if plane == "psum":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
            tables[k] = r0[k]
        else:
            tables[k] = np.concatenate([r0[k], r1[k]])
    return r0, r1, tables


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_one(workers, devices8, case):
    """5 steps of the two-process trainer against JAX's one-process 2 x 2
    mesh and the port's: losses rtol 1e-5, tables atol 1e-6 + rtol 1e-5;
    dense parameters equal on both ranks, psum replicas equal, hash keys
    slot for slot; the step eager, one program."""
    import jax
    import optax
    import openembedding_tpu as oe
    from openembedding_tpu import Trainer as JaxTrainer
    from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
    from openembedding_tpu.models import deepctr as jax_models
    from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.optim import initializers as ti
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    plane, vocab = CASES[case]
    r0, r1, tables = _global_arrays(workers, case, plane.split("+")[0])
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    assert int(r0["builds"]) == 1
    specs, mapper = _specs(plane, vocab)
    batches = _batches(mapper)
    t = _trainer(specs, create_mesh(2, 2, device="cpu"))
    s = t.init(ti.prng_key(0), batches[0])
    losses = []
    for b in batches:
        s, m = t.train_step(s, t.shard_batch(b))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    one = _state_arrays(s.emb)
    assert one.keys() == tables.keys()
    for k, v in one.items():
        if k.endswith("/keys"):
            np.testing.assert_array_equal(tables[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(tables[k], v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01},
              plane=plane)
    if vocab == -1:
        kw.update(hash_capacity=2048, key_dtype="wide")
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, vocab, DIM, **kw)
    jt = JaxTrainer(
        jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                               dnn_units=(16, 8)),
        oe.EmbeddingCollection(jspecs, jax_mesh(2, 2, devices8[:4])),
        optax.adagrad(0.01))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    jl = []
    for b in batches:
        js, jm = jt.train_step(js, b)
        jl.append(float(jm["loss"]))
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-5)
    for name, jst in js.emb.items():
        jst = jst.table if hasattr(jst, "table") else jst
        np.testing.assert_allclose(tables[f"{name}/weights"],
                                   np.asarray(jst.weights), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        if vocab == -1:
            np.testing.assert_array_equal(tables[f"{name}/keys"],
                                          np.asarray(jst.keys))


def test_two_process_dump_loads_in_jax(workers, devices8):
    """The ``a2a`` trajectory's part dump, written by both processes, in
    JAX's ``load_checkpoint`` on a 2 x 4 mesh: every row equals the two
    processes' tables."""
    import jax.numpy as jnp
    import openembedding_tpu as oe
    from openembedding_tpu import checkpoint as jax_ckpt
    from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
    from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.parallel import sharded_table as st
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    _, _, tables = _global_arrays(workers, "a2a", "a2a")
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01})
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM, **kw)
    jcoll = oe.EmbeddingCollection(jspecs, jax_mesh(2, 4, devices8[:8]))
    jl = jax_ckpt.load_checkpoint(os.path.join(workers, "a2a_dump"), jcoll)
    tspecs, _ = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM, **kw)
    coll = EmbeddingCollection(tspecs, create_mesh(2, 2, device="cpu"))
    for spec in tspecs:
        vocab = spec.input_dim
        ids = np.arange(vocab, dtype=np.int32)
        jrows = np.asarray(jcoll.pull(jl, {spec.name: jnp.asarray(ids)},
                                      batch_sharded=False)[spec.name])
        phys = st.logical_to_physical(coll.sharding_spec(spec.name), vocab,
                                      "cpu").numpy()
        np.testing.assert_array_equal(
            jrows, tables[f"{spec.name}/weights"][phys])


def test_multihost_driver_at_its_defaults():
    """``examples.multihost_train`` at its defaults on two CPU ranks:
    rank 0 logs steps 5 and 10 (finite losses) and both finish."""
    import re
    port = _free_port()
    outs = run_workers(lambda r: [
        sys.executable, "-m", "openembedding_tpu_torch.examples."
        "multihost_train", "--master", f"127.0.0.1:{port}",
        "--num_workers", "2", "--worker_rank", str(r), "--device", "cpu"],
        WORKER_TIMEOUT_S)
    assert "worker 1/2: mesh {'data': 2, 'model': 1} on cpu (gloo)" \
        in outs[1], outs[1]
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", outs[0])]
    assert len(losses) == 2 and np.isfinite(losses).all(), outs[0]
    assert "multihost training done" in outs[0]


def test_planes_that_raise_across_processes():
    """The cached, grouped and pipelined planes build over a mesh across
    processes, each process holding its own shards, and every process
    lists the same cached, grouped and pipelined variables; an exchange
    over processes needs a batch-sharded batch; a mesh whose data rows
    do not split over the processes raises; ``export_dense``, which needs
    every row, refuses a process's share."""
    import torch
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.parallel import alltoall
    from openembedding_tpu_torch.parallel.hot_cache import CachedState
    from openembedding_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(["cpu"] * 4, 2, 2, process_count=2, process_index=1)
    assert mesh.spans_processes and list(mesh.local_positions) == [2, 3]
    assert mesh.process_of(1) == 0 and mesh.process_of(3) == 1
    planes = ("a2a+cache", "a2a+grouped", "a2a+pipelined",
              "a2a+grouped+pipelined")
    specs = [EmbeddingSpec(f"x{i}", 8, 2, plane=p)
             for i, p in enumerate(planes)] + [
        EmbeddingSpec(f"h{i}", -1, 2, hash_capacity=64, plane=p)
        for i, p in enumerate(planes)]
    names = []
    for rank in range(2):
        coll = EmbeddingCollection(specs, Mesh(
            ["cpu"] * 4, 2, 2, process_count=2, process_index=rank))
        names.append((coll.cached_names(), coll.grouped_names(),
                      coll.pipelined_names()))
        states = coll.init()
        for spec in specs:
            st = states[spec.name]
            assert isinstance(st, CachedState) == (spec.plane
                                                   == "a2a+cache")
            table = st.table if isinstance(st, CachedState) else st
            assert list(table.held) == [2 * rank, 2 * rank + 1]
    assert names[0] == names[1] == (
        ("x0", "h0"), ("x1", "x3", "h1", "h3"), ("x2", "x3", "h2", "h3"))
    with pytest.raises(ValueError, match="batch-sharded"):
        alltoall.exchange_pull(torch.zeros(8, dtype=torch.int32),
                               lambda r: r, lambda k: k, sentinel=-1,
                               dim=2, dtype=torch.float32, num_shards=4,
                               groups=1, mesh=mesh)
    with pytest.raises(ValueError, match="do not split"):
        Mesh(["cpu"] * 3, 3, 1, process_count=2)
    from openembedding_tpu_torch import checkpoint as tck
    with pytest.raises(ValueError, match="one process"):
        tck.export_dense(EmbeddingCollection(
            [EmbeddingSpec("x", 8, 2)], mesh), {})


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
