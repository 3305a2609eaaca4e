"""Torch port, the dense-state file (``utils/msgpack_state.py``) against
flax: the port's bytes of a ``(params, opt_state)`` pair are byte-
identical to ``flax.serialization.to_bytes`` of the JAX ``Trainer``'s
pair holding the same values (fused DeepFM with dense Adagrad, the
``sparse_as_dense`` hybrid with dense Adam, SGD), each side restores the
other's bytes exactly, and checkpoints carry it both ways. The msgpack
subset is held against the ``msgpack`` package value by value.
"""

import msgpack
import numpy as np
import pytest
import torch

import jax
import optax
from flax import serialization

from openembedding_tpu import EmbeddingCollection as JaxCollection
from openembedding_tpu import Trainer as JaxTrainer
from openembedding_tpu import checkpoint as jax_ckpt
from openembedding_tpu import hybrid as jhy
from openembedding_tpu.fused import make_fused_specs as jax_fused_specs
from openembedding_tpu.models import deepctr as jax_models
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu_torch import checkpoint as tck
from openembedding_tpu_torch import hybrid as thy
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                EmbeddingSpec)
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.utils import msgpack_state as ms

DIM, VOCAB, BATCH, UNITS = 4, 64, 16, (16, 8)
OPT = {"category": "adagrad", "learning_rate": 0.01}
NAMES = criteo.SPARSE_NAMES[:4]
VOCABS = (8, 40, 60, 16)


def _fused(devices8, tx):
    mesh = create_mesh(1, 1, devices8[:1])
    jspecs, _ = jax_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                optimizer=OPT)
    _, mapper = make_fused_specs(criteo.SPARSE_NAMES, VOCAB, DIM,
                                 optimizer=OPT)
    jt = JaxTrainer(jax_models.build_model("deepfm", criteo.SPARSE_NAMES,
                                           dnn_units=UNITS),
                    JaxCollection(jspecs, mesh), tx)
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES,
                            embedding_dim=DIM, num_dense=criteo.NUM_DENSE,
                            dnn_units=UNITS)
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=1, num_batches=3)]
    return jt, module, batches


def _hybrid(devices8, tx):
    mesh = create_mesh(1, 1, devices8[:1])
    jspecs = jax_models.make_feature_specs(NAMES, list(VOCABS), DIM,
                                           optimizer=OPT)
    sparse, dense_specs = jhy.split_sparse_dense(jspecs, 16)
    jt = JaxTrainer(jax_models.build_model("deepfm", NAMES,
                                           dnn_units=UNITS),
                    JaxCollection(sparse, mesh), tx,
                    sparse_as_dense=dense_specs)
    tspecs = tm.make_feature_specs(NAMES, list(VOCABS), DIM, optimizer=OPT)
    _, tdense = thy.split_sparse_dense(tspecs, 16)
    module = thy.HybridModel(tm.build_model(
        "deepfm", NAMES, embedding_dim=DIM, num_dense=criteo.NUM_DENSE,
        dnn_units=UNITS), tdense)
    batches = []
    for b in criteo.add_linear_columns(criteo.synthetic_criteo(
            BATCH, num_buckets=VOCAB, seed=1, num_batches=3)):
        sparse_cols = {}
        for name, v in zip(NAMES, VOCABS):
            sparse_cols[name] = sparse_cols[name + ":linear"] = \
                (b["sparse"][name] % v).astype(np.int32)
        batches.append({**b, "sparse": sparse_cols})
    return jt, module, batches


BUILDS = {"deepfm-adagrad": (_fused, optax.adagrad(0.01)),
          "hybrid-adam": (_hybrid, optax.adam(1e-2)),
          "deepfm-sgd": (_fused, optax.sgd(0.01))}


def _trained(devices8, which):
    """The JAX trainer's (params, opt_state) after two steps, and the
    port's copy of it."""
    build, tx = BUILDS[which]
    jt, module, batches = build(devices8, tx)
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    for b in batches[:2]:
        js, _ = jt.train_step(js, b)
    jpair = jax.device_get((js.params, js.opt_state))
    params = interop.dense_params_from_flax(module, js.params, "cpu")
    opt = interop.dense_state_from_optax(module, js.opt_state, "cpu")
    return jpair, (params, opt)


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("which", sorted(BUILDS))
def test_bytes_identical_to_flax(devices8, which):
    jpair, (params, opt) = _trained(devices8, which)
    want = serialization.to_bytes(jpair)
    assert ms.dense_state_to_bytes(params, opt) == want
    # the port restores flax's bytes exactly
    got_p, got_o = ms.dense_state_from_bytes(
        want, ({k: torch.zeros_like(v) for k, v in params.items()},
               {k: torch.zeros_like(v) for k, v in opt.items()}))
    _assert_equal(got_p, params)
    _assert_equal(got_o, opt)
    # flax restores the port's bytes exactly
    back = serialization.from_bytes(jax.tree.map(np.zeros_like, jpair),
                                    ms.dense_state_to_bytes(params, opt))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jpair)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


def test_checkpoints_carry_dense_state_both_ways(devices8, tmp_path):
    """A JAX checkpoint's dense file loads into the port's template, and
    the port's into JAX's, for the hybrid with Adam."""
    jpair, (params, opt) = _trained(devices8, "hybrid-adam")
    jt, module, batches = _hybrid(devices8, optax.adam(1e-2))
    js = jt.init(jax.random.PRNGKey(0), jt.shard_batch(batches[0]))
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jax_ckpt.save_checkpoint(jpath, jt.collection, js.emb, dense_state=jpair)
    tspecs = tm.make_feature_specs(NAMES, list(VOCABS), DIM, optimizer=OPT)
    sparse, _ = thy.split_sparse_dense(tspecs, 16)
    coll = EmbeddingCollection(sparse, device="cpu")
    template = ({k: torch.zeros_like(v) for k, v in params.items()},
                {k: torch.zeros_like(v) for k, v in opt.items()})
    _, (got_p, got_o) = tck.load_checkpoint(jpath, coll,
                                            dense_state_template=template)
    _assert_equal(got_p, params)
    _assert_equal(got_o, opt)
    tck.save_checkpoint(tpath, coll, coll.init(),
                        dense_state=(params, opt))
    _, dense = jax_ckpt.load_checkpoint(
        tpath, jt.collection,
        dense_state_template=jax.tree.map(np.zeros_like, jpair))
    for x, y in zip(jax.tree.leaves(dense), jax.tree.leaves(jpair)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    with open(f"{tpath}/{tck.DENSE_FILE}", "rb") as f:
        assert f.read() == serialization.to_bytes(jpair)


VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
          2**63 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
          -2**31 - 1, -2**63, 0.5, -1e300, True, False, None, "",
          "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000, b"",
          b"x" * 255, b"y" * 256, b"z" * 70000, [], [1] * 15, [2] * 16,
          list(range(70000)), {}, {str(i): i for i in range(15)},
          {str(i): [i] for i in range(16)}, {"k": {"n": [1, "s", b"b"]}}]


def test_msgpack_subset_matches_msgpack():
    for v in VALUES:
        packed = msgpack.packb(v, use_bin_type=True)
        assert ms.pack(v) == packed, repr(v)[:40]
        assert ms.unpack(packed) == msgpack.unpackb(packed, raw=False)
    for n in (0, 1, 2, 3, 4, 5, 7, 8, 12, 16, 40, 300, 70000):
        arr = np.arange(n, dtype=np.uint8)
        want = serialization.msgpack_serialize({"a": arr})
        nd = ms.NDArray.of(arr)
        assert ms.pack({"a": nd}) == want
        got = ms.unpack(want)["a"]
        assert np.array_equal(got.numpy(), arr)
    with pytest.raises(ValueError, match="truncated"):
        ms.unpack(ms.pack({"a": 1})[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ms.unpack(ms.pack(1) + b"\x00")


def test_bfloat16_leaves_match_flax(devices8):
    import ml_dtypes
    rng = np.random.RandomState(0)
    w = rng.randn(3, 5).astype(ml_dtypes.bfloat16)
    want = serialization.to_bytes({"w": w})
    t = interop.tensor_from_numpy(w, "cpu")
    assert t.dtype == torch.bfloat16
    assert ms.pack({"w": ms.NDArray.of(t)}) == want
    back = ms.unpack(want)["w"].tensor("cpu")
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))


def test_refusals():
    params = {"Dense_0.weight": torch.ones(2, 3)}
    with pytest.raises(ValueError, match="none of Adagrad"):
        ms.dense_state_to_bytes(params, {"junk": torch.ones(1)})
    data = ms.dense_state_to_bytes(params, {})
    with pytest.raises(ValueError, match="no Dense_1"):
        ms.dense_state_from_bytes(data, ({"Dense_1.weight":
                                          torch.ones(2, 3)}, {}))
    with pytest.raises(ValueError, match="shape"):
        ms.dense_state_from_bytes(data, ({"Dense_0.weight":
                                          torch.ones(3, 3)}, {}))
