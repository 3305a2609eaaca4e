"""Torch port, training and checkpoints over a one-process mesh against
the JAX package's sharded collection on the 8-device CPU mesh (the
tables themselves: ``test_torch_sharded.py``).

``Trainer.init(prng_key(0), batch)`` on the same ``(data, model)`` mesh
as JAX's, with nothing copied, then 5 steps: losses and tables at rtol
1e-5 (``a2a`` and ``psum``, array and hash). A 2 x 2 save of one state
in each package: files byte for byte, loads across topologies exact.
``fit`` over a sharded collection autosaves full and resumes bit for
bit.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import openembedding_tpu as oe
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh as jax_mesh
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection, EmbeddingSpec
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel.mesh import create_mesh

ADAGRAD = {"category": "adagrad", "learning_rate": 0.1}
VOCAB, DIM, BATCH = 1000, 4, 16


def _trainers(devices8, plane, d, m, vocab, key_dtype="wide"):
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01},
              plane=plane)
    if vocab == -1:
        kw.update(hash_capacity=2048, key_dtype=key_dtype)
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, vocab, DIM, **kw)
    tspecs, mapper = make_fused_specs(criteo.SPARSE_NAMES, vocab, DIM, **kw)
    jt = JaxTrainer(
        jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                               dnn_units=(16, 8)),
        oe.EmbeddingCollection(jspecs, jax_mesh(d, m, devices8[:d * m])),
        optax.adagrad(0.01))
    t = tr.Trainer(
        tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=DIM,
                       dnn_units=(16, 8)),
        EmbeddingCollection(tspecs, create_mesh(d, m, device="cpu")),
        dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        32, num_buckets=vocab if vocab > 0 else 1000, seed=1,
        num_batches=5)]
    return jt, t, batches


@pytest.mark.parametrize("case", [("a2a", 2, 2, 64, "wide"),
                                  ("psum", 2, 2, 64, "wide"),
                                  ("a2a", 2, 2, -1, "wide"),
                                  ("psum", 2, 2, -1, "wide"),
                                  ("a2a", 1, 4, -1, "int32")],
                         ids=lambda c: "-".join(map(str, c)))
def test_trainer_trajectory_matches_jax(devices8, case):
    """``Trainer.init(prng_key(0), batch)`` on the same mesh as JAX's,
    nothing copied, then 5 steps: losses and tables at rtol 1e-5."""
    plane, d, m, vocab, key_dtype = case
    jt, t, batches = _trainers(devices8, plane, d, m, vocab, key_dtype)
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    s = t.init(ti.prng_key(0), batches[0])
    jl, tl = [], []
    for b in batches:
        js, jm = jt.train_step(js, b)
        s, m_ = t.train_step(s, t.shard_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(float(m_["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for name, jst in js.emb.items():
        np.testing.assert_allclose(s.emb[name].weights.numpy(),
                                   np.asarray(jst.weights),
                                   rtol=1e-5, atol=1e-7)
    assert t.builds == 1


@pytest.mark.parametrize("plane", ["a2a", "psum"])
def test_checkpoints_across_topologies(devices8, tmp_path, plane):
    """A 2x2 save (array ``mod`` layout and int32 hash) of one state in
    each package: the files equal byte for byte (the hash dump per key
    too); each loads the other's, the port on 1x1, 2x2 and 1x4 meshes,
    JAX on 2x4, rows exact."""
    specs = [dict(name="a", input_dim=VOCAB, output_dim=DIM, plane=plane,
                  optimizer=ADAGRAD),
             dict(name="h", input_dim=-1, output_dim=DIM, plane=plane,
                  key_dtype="int32", hash_capacity=4096,
                  optimizer=ADAGRAD)]
    jm = jax_mesh(2, 2, devices8[:4])
    jcoll = oe.EmbeddingCollection([oe.EmbeddingSpec(**k) for k in specs],
                                   jm)
    tcoll = EmbeddingCollection([EmbeddingSpec(**k) for k in specs],
                                create_mesh(2, 2, device="cpu"))
    jstates = jcoll.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    for _ in range(2):
        ids = {"a": rng.integers(0, VOCAB, (BATCH, 2)).astype(np.int32),
               "h": (rng.integers(0, 300, (BATCH, 2)) * 13).astype(
                   np.int32)}
        g = {k: rng.standard_normal((BATCH, 2, DIM)).astype(np.float32)
             for k in ids}
        jstates = jcoll.apply_gradients(
            jstates, ids, {k: jnp.asarray(v) for k, v in g.items()})
    # the same state in the port (JAX's global physical arrays)
    ja, jh = jstates["a"], jstates["h"]
    tstates = {
        "a": interop.sharded_table_state_from_numpy(
            np.asarray(ja.weights),
            {k: np.asarray(v) for k, v in ja.slots.items()},
            tcoll.sharding_spec("a").num_shards, "cpu"),
        "h": interop.sharded_hash_state_from_numpy(
            np.asarray(jh.keys), np.asarray(jh.weights),
            {k: np.asarray(v) for k, v in jh.slots.items()},
            tcoll.sharding_spec("h").num_shards, "cpu",
            init_rng=np.asarray(jh.init_rng))}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jdir, jcoll, jstates)
    tck.save_checkpoint(tdir, tcoll, tstates)
    for f in ("weights.npy", "slot_accum.npy", "../var_1_h.d/keys.npy",
              "../var_1_h.d/weights.npy"):
        assert open(f"{jdir}/var_0_a.d/{f}", "rb").read() \
            == open(f"{tdir}/var_0_a.d/{f}", "rb").read(), f
    tmeta = json.load(open(f"{tdir}/model_meta"))
    assert tmeta["extra"]["variable_num_shards"] == json.load(open(
        f"{jdir}/model_meta"))["extra"]["variable_num_shards"]

    def per_key(d):
        k = np.load(f"{d}/var_1_h.d/keys.npy")
        w = np.load(f"{d}/var_1_h.d/weights.npy")
        return dict(zip(k.tolist(), map(tuple, w.tolist())))
    jk, tk = per_key(jdir), per_key(tdir)
    assert jk.keys() == tk.keys()
    for k in jk:
        assert tk[k] == jk[k]
    probe = {"a": np.arange(VOCAB, dtype=np.int32)[:, None],
             "h": np.array(sorted(jk), np.int32)[:, None]}
    for d, m in ((1, 1), (2, 2), (1, 4)):
        mesh = create_mesh(d, m, device="cpu")
        coll = EmbeddingCollection([EmbeddingSpec(**k) for k in specs],
                                   mesh)
        for src, want in ((jdir, jstates), (tdir, None)):
            loaded = tck.load_checkpoint(src, coll)
            rows = coll.pull(loaded, probe, read_only=True)
            if want is not None:
                wrows = jcoll.pull(want, probe, read_only=True)
                for k in rows:
                    np.testing.assert_array_equal(rows[k].numpy(),
                                                  np.asarray(wrows[k]))
    # JAX loads the port's save on a 2x4 mesh
    jcoll24 = oe.EmbeddingCollection(
        [oe.EmbeddingSpec(**k) for k in specs],
        jax_mesh(2, 4, devices8[:8]))
    jl = jax_ckpt.load_checkpoint(tdir, jcoll24)
    tl = tck.load_checkpoint(tdir, coll)
    for k in probe:
        np.testing.assert_array_equal(
            coll.pull(tl, probe, read_only=True)[k].numpy(),
            np.asarray(jcoll24.pull(jl, probe, read_only=True)[k]))


def test_fit_autosaves_full_and_resumes_on_a_mesh(tmp_path):
    """A sharded collection tracks its logical rows: ``fit``'s autosave
    writes a full base and then a delta chain with the cursor in its
    manifest, and a fresh trainer resumed from it trains on bit for bit;
    an offloaded variable whose cache is not sharded like the
    collection's variable raises."""
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, 64, DIM,
                                     optimizer=ADAGRAD)

    def trainer():
        coll = EmbeddingCollection(specs, create_mesh(2, 2, device="cpu"))
        coll.enable_dirty_tracking(target_chunks=64)
        return tr.Trainer(
            tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=DIM,
                           dnn_units=(16, 8)), coll, dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        32, num_buckets=64, seed=2, num_batches=6)]
    t = trainer()
    s0 = t.init(ti.prng_key(0), batches[0])
    whole, _ = t.fit(tr.copy_state(s0, "cpu"), batches)
    d = str(tmp_path / "auto")
    t.fit(tr.copy_state(s0, "cpu"), batches[:4], autosave_every=2,
          autosave_dir=d)
    from openembedding_tpu_torch import checkpoint_delta as cd
    cd.join_compactor(d)
    manifest = cd.read_manifest(d)
    assert manifest["chain"] or manifest["content_seq"] >= 1
    assert manifest["last_seq"] == 1
    t2 = trainer()
    resumed, _ = t2.fit(t2.init(ti.prng_key(0), batches[0]), batches,
                        resume_from=d)
    assert int(resumed.step) == 6
    for name in whole.emb:
        assert torch.equal(resumed.emb[name].weights, whole.emb[name].weights)
    for k, v in whole.params.items():
        assert torch.equal(resumed.params[k], v)
    with pytest.raises(ValueError, match="shard"):
        tr.Trainer(tm.build_model("lr", criteo.SPARSE_NAMES),
                   EmbeddingCollection(specs, create_mesh(1, 2,
                                                          device="cpu")),
                   dense.adagrad(0.01), offload={"fields": object()})
