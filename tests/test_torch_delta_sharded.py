"""Torch port, delta checkpoints and hot-swap of SHARDED variables against
the JAX package, on JAX's own 2 x 4 mesh (``tests/test_delta_checkpoint.py``
runs every case there).

The first half runs the bodies of ``tests/test_torch_delta.py``'s cases
again with its ``layout`` fixture overridden: the array variable on the
``a2a`` or the ``psum`` plane, the hash variable on ``a2a``, the tables
stacked shards of a one-process 2 x 4 mesh. The second half holds the
port against JAX: a base and chain that JAX writes from a 2 x 4 mesh load
in the port onto 2 x 4 and onto one shard, and the chain the port writes
from 2 x 4 is JAX's byte for byte and loads in JAX; a 2 x 2 ``Trainer``'s
deltas hot-swap into the port's and JAX's registries, whole and as two
shard slices, the served rows equal to each other and to the trainer's
logical rows. Every comparison is exact.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import checkpoint as jck
from openembedding_tpu import checkpoint_delta as jcd
from openembedding_tpu.parallel import hot_cache as jhot
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu_torch import checkpoint as ck
from openembedding_tpu_torch import checkpoint_delta as cd
from openembedding_tpu_torch import interop
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                EmbeddingSpec)
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.parallel.mesh import create_mesh as tmesh
from openembedding_tpu_torch.serving.registry import ModelRegistry

from test_torch_delta import (  # noqa: F401 — collected here on a mesh
    ADAGRAD, _fixed_zip_time, _npz, _strip,
    test_applied_seq_survives_compaction, test_apply_delta_hot_swap_e2e,
    test_compaction_folds_chain, test_compactor_refuses_torn_entry,
    test_delta_bytes_ratio_10x, test_delta_roundtrip_bit_identical,
    test_dense_state_persists_through_skipped_delta,
    test_full_save_carries_burned_seqs, test_full_save_resets_stale_chain,
    test_returned_payload_owns_its_rows, test_torn_final_delta_discarded, test_writer_killed_mid_delta_recovers)


@pytest.fixture(params=["a2a", "psum"])
def layout(request):
    """The imported cases' collection on a 2 x 4 mesh, the array variable
    on this plane (the hash variable on ``a2a``)."""
    return request.param


def test_sharded_variables_track_logical_rows():
    """Tracking arms on every plane of a mesh; marks name logical rows and
    keys, so a sharded variable's dirty chunks are one shard's."""
    def coll(where, plane):
        c = EmbeddingCollection(
            (EmbeddingSpec("arr", 256, 4, plane=plane),
             EmbeddingSpec("hsh", -1, 4, hash_capacity=1024,
                           plane=plane.replace("+pipelined", ""))),
            default_optimizer=ADAGRAD, **where)
        c.enable_dirty_tracking(target_chunks=32)
        return c
    ids = {"arr": np.asarray([0, 9, 255, 300, -1], np.int32),
           "hsh": np.asarray([[5, 0], [7, 1]], np.int32)}
    one = coll({"device": "cpu"}, "a2a")
    one.mark_dirty(ids)
    for plane in ("a2a", "psum", "a2a+bf16", "a2a+int8", "a2a+grouped",
                  "a2a+pipelined", "a2a+cache"):
        c = coll({"mesh": tmesh(2, 2, device="cpu")}, plane)
        assert set(c.dirty_trackers) == {"arr", "hsh"}
        c.mark_dirty(ids)
        for name in ids:
            assert list(c.dirty_trackers[name].dirty_chunks()) == \
                list(one.dirty_trackers[name].dirty_chunks()), (plane, name)


# --- against the JAX package on JAX's 2 x 4 mesh ------------------------------

XVARS = [("arr", 96, 4, "float32", False), ("arr16", 64, 3, "bfloat16",
                                              False),
         ("hsh", -1, 4, "float32", True), ("hsh16", -1, 3, "bfloat16", True)]


def _specs(spec_cls, plane):
    return [spec_cls(name=n, input_dim=v, output_dim=d, dtype=t,
                     hash_capacity=512, plane="a2a" if hashed else plane)
            for n, v, d, t, hashed in XVARS]


def _mesh_colls(devices8, plane, chunks=16):
    jcoll = oe.EmbeddingCollection(_specs(oe.EmbeddingSpec, plane),
                                   create_mesh(2, 4, devices8),
                                   default_optimizer=ADAGRAD)
    tcoll = EmbeddingCollection(
        _specs(EmbeddingSpec, plane),
        tmesh(2, 4, device="cpu"), default_optimizer=ADAGRAD)
    one = EmbeddingCollection(
        _specs(EmbeddingSpec, "a2a"), device="cpu",
        default_optimizer=ADAGRAD)
    for c in (jcoll, tcoll, one):
        c.enable_dirty_tracking(target_chunks=chunks)
    return jcoll, tcoll, one


def _port_of_mesh(jcoll, jstates):
    """The port's stacked shards of JAX's 2 x 4 states: its global
    physical arrays as they are."""
    out = {}
    for name, *_, hashed in XVARS:
        st = jhot.unwrap(jstates[name])
        n = jcoll.sharding_spec(name).num_shards
        slots = {k: np.asarray(v) for k, v in st.slots.items()}
        if hashed:
            out[name] = interop.sharded_hash_state_from_numpy(
                np.asarray(st.keys), np.asarray(st.weights), slots, n,
                "cpu", init_rng=np.asarray(st.init_rng),
                insert_failures=int(st.insert_failures))
        else:
            out[name] = interop.sharded_table_state_from_numpy(
                np.asarray(st.weights), slots, n, "cpu")
    return out


def _xtrain(jcoll, jstates, tcolls, seed):
    """One JAX push on every variable; the port collections' trackers
    marked with the same ids."""
    rng = np.random.RandomState(seed)
    idx = {}
    for name, vocab, _, _, hashed in XVARS:
        idx[name] = rng.randint(0, 2**20 if hashed else vocab,
                                12).astype(np.int32)
    jidx = {k: jnp.asarray(v) for k, v in idx.items()}
    rows = jcoll.pull(jstates, jidx, batch_sharded=False)
    jstates = jcoll.apply_gradients(
        jstates, jidx, {k: jnp.ones_like(v) * 0.25 for k, v in rows.items()},
        batch_sharded=False)
    for c in tcolls:
        c.mark_dirty(idx)
    return jstates, idx


def _words(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_rows(coll_a, a, coll_b, b, probes):
    """Equal logical rows of every variable (array ids ``0 .. vocab``,
    hash ``probes``), pulled read-only through each collection."""
    for name, vocab, *_, hashed in XVARS:
        ids = {name: probes[name] if hashed
               else np.arange(vocab, dtype=np.int32)}
        ra = coll_a.pull(a, ids, read_only=True, batch_sharded=False)[name]
        rb = coll_b.pull(b, ids, read_only=True, batch_sharded=False)[name]
        assert torch.equal(_words(ra), _words(rb)), name


@pytest.mark.parametrize("plane", ["a2a", "psum"])
def test_mesh_chains_cross_read_with_jax(devices8, tmp_path, monkeypatch,
                                         plane):
    """JAX and the port each write a base and 3 deltas from the same
    2 x 4 states (array variables on ``plane``, hash on ``a2a``; f32 and
    bf16): equal dirty chunk sets, byte-identical delta files and equal
    manifests. JAX's chain loads in the port onto 2 x 4 (the stacked
    shards equal JAX's global arrays, hash keys slot for slot) and onto
    one shard (the same logical rows); the port's chain loads in JAX onto
    2 x 4, equal to JAX's trained states."""
    _fixed_zip_time(monkeypatch)
    jcoll, tcoll, one = _mesh_colls(devices8, plane)
    jstates = jcoll.init(jax.random.PRNGKey(0))
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jpath, jcoll, jstates, mode="delta", step=0)
    ck.save_checkpoint(tpath, tcoll, _port_of_mesh(jcoll, jstates),
                       mode="delta", step=0)
    seen = []
    for seq in (1, 2, 3):
        jstates, idx = _xtrain(jcoll, jstates, (tcoll, one), seq)
        seen.append(idx)
        for name in jcoll.dirty_trackers:
            assert list(jcoll.dirty_trackers[name].dirty_chunks()) == \
                list(tcoll.dirty_trackers[name].dirty_chunks()), name
        jcd.save_delta(jpath, jcoll, jstates, step=seq,
                       compact_bytes_ratio=1e18, background_compact=False)
        cd.save_delta(tpath, tcoll, _port_of_mesh(jcoll, jstates),
                      step=seq, compact_bytes_ratio=1e18,
                      background_compact=False)
    jm, tm_ = jcd.read_manifest(jpath), cd.read_manifest(tpath)
    assert _strip(jm) == _strip(tm_) and len(tm_["chain"]) == 3
    for entry in tm_["chain"]:
        for info in entry["vars"].values():
            assert _npz(jpath, info["file"]) == _npz(tpath, info["file"])
    want = _port_of_mesh(jcoll, jstates)
    info = {}
    got = ck.load_checkpoint(jpath, tcoll, info=info)
    assert info["applied_seq"] == 3
    for name, *_, hashed in XVARS:
        a, b = got[name], want[name]
        assert torch.equal(_words(a.weights), _words(b.weights)), name
        for s in a.slots:
            assert torch.equal(a.slots[s], b.slots[s]), (name, s)
        if hashed:
            assert torch.equal(a.keys, b.keys), name
    probes = {name: np.concatenate([s[name] for s in seen])
              for name, *_ in XVARS}
    _assert_rows(one, ck.load_checkpoint(jpath, one), tcoll, want, probes)
    back = jck.load_checkpoint(tpath, jcoll)
    for name, *_, hashed in XVARS:
        fields = ("keys", "weights") if hashed else ("weights",)
        for f in fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jhot.unwrap(back[name]), f)),
                np.asarray(getattr(jhot.unwrap(jstates[name]), f)))
        for s, v in jhot.unwrap(back[name]).slots.items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(jhot.unwrap(jstates[name]).slots[s]))


# --- a 2 x 2 trainer's deltas served -----------------------------------------

def test_trainer_deltas_hot_swap_into_both_registries(devices8, tmp_path):
    """A 2 x 2 ``a2a`` trainer (fused ``deepfm`` tables) saves a base and
    publishes two deltas; the port's and JAX's registries load the base
    and apply the deltas (whole, and as the two members of a ``G = 2``
    shard group): every served row equals the other registry's and the
    trainer's logical row, bit for bit."""
    vocab, dim = 64, 4
    specs, mapper = make_fused_specs(criteo.SPARSE_NAMES, vocab, dim,
                                     optimizer=ADAGRAD)
    coll = EmbeddingCollection(specs, tmesh(2, 2, device="cpu"))
    coll.enable_dirty_tracking(target_chunks=64)
    trainer = tr.Trainer(
        tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=dim,
                       dnn_units=(16, 8)), coll, dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        32, num_buckets=vocab, seed=4, num_batches=3)]
    state = trainer.init(ti.prng_key(0), batches[0])
    path = str(tmp_path / "chain")
    state, _ = trainer.train_step(state, batches[0])
    ck.save_checkpoint(path, coll, state.emb, mode="delta", step=1)
    base = str(tmp_path / "base")      # the base alone, before the deltas
    shutil.copytree(path, base)
    deltas = []
    for step, b in enumerate(batches[1:], start=2):
        state, _ = trainer.train_step(state, b)
        deltas.append(cd.save_delta(
            path, coll, state.emb, step=step, compact_bytes_ratio=1e18,
            background_compact=False, return_payload=True)["delta"])
    assert [d.seq for d in deltas] == [1, 2]
    assert [d.seq for d in cd.read_deltas_since(path, 0)] == [1, 2]
    names = sorted(coll.specs)
    probe = {n: np.arange(coll.specs[n].input_dim) for n in names}
    want = {n: coll.pull(state.emb, {n: probe[n]}, read_only=True,
                         batch_sharded=False)[n].numpy() for n in names}
    jmesh = create_mesh(1, 1, devices8[:1])
    for g in (1, 2):
        total = {n: np.zeros_like(w) for n, w in want.items()}
        for k in range(g):
            reg, jreg = ModelRegistry(device="cpu"), JaxRegistry(jmesh)
            for r in (reg, jreg):
                r.create_model(base, model_sign="m", shard_index=k,
                               shard_count=g)
            for d in deltas:
                wire = cd.encode_delta(d)
                assert reg.apply_delta("m", wire)["applied"]
                assert jreg.apply_delta("m", jcd.decode_delta(wire))[
                    "applied"]
            for n in names:
                got = reg.find_model("m").lookup(n, probe[n]).numpy()
                np.testing.assert_array_equal(
                    got, np.asarray(jreg.find_model("m").lookup(n, probe[n])))
                owned = (probe[n] % g) == k
                np.testing.assert_array_equal(got[owned], want[n][owned])
                total[n] += got
        for n in names:
            np.testing.assert_array_equal(total[n], want[n])
