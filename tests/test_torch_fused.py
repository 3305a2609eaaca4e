"""Torch port, fused feature groups and the synthetic Criteo stream,
against the JAX package: both are host-side numpy, so the comparisons
are exact."""

import dataclasses

import numpy as np
import pytest

from openembedding_tpu import fused as jax_fused
from openembedding_tpu.data import criteo as jax_criteo
from openembedding_tpu_torch import fused as tf
from openembedding_tpu_torch.data import criteo as tc


def _batch(vocab, seed=0, b=64):
    rng = np.random.RandomState(seed)
    sparse = {}
    for j, name in enumerate(tc.SPARSE_NAMES):
        v = vocab[j] if isinstance(vocab, (list, tuple)) else vocab
        ids = rng.randint(-3, v + 3, b)
        ids[j % b], ids[(j + 1) % b] = -1 - j, v + j    # out of range
        sparse[name] = ids.astype(np.int32 if j % 2 else np.int64)
    return sparse


@pytest.mark.parametrize("vocab", [
    97, [5 + 3 * j for j in range(26)], 1 << 27])
def test_fuse_matches_jax(vocab):
    """Same fused ids (and dtype) as the JAX mapper, out-of-range ids
    (negative, >= the feature's vocab) mapping to -1; int64 once the
    fused vocab passes 2^31."""
    names = tc.SPARSE_NAMES
    _, jm = jax_fused.make_fused_specs(names, vocab, 9)
    _, tm = tf.make_fused_specs(names, vocab, 9)
    assert tm.offsets.tolist() == jm.offsets.tolist()
    assert tm.total_vocab == jm.total_vocab
    batch = _batch(vocab)
    want = jm.fuse(batch)
    got = tm.fuse(batch)
    assert sorted(got) == sorted(want) == ["fields", "fields:linear"]
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["fields"] == -1).any()
    assert tm.fuse_batch({"label": 1, "sparse": batch})["label"] == 1


def test_fused_specs_match_jax():
    kw = dict(optimizer={"category": "adagrad", "learning_rate": 0.01},
              dtype="bfloat16")
    jspecs, _ = jax_fused.make_fused_specs(tc.SPARSE_NAMES, 1 << 20, 9, **kw)
    tspecs, _ = tf.make_fused_specs(tc.SPARSE_NAMES, 1 << 20, 9, **kw)
    assert len(tspecs) == len(jspecs) == 2
    for t, j in zip(tspecs, jspecs):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.meta().to_json() == j.meta().to_json()
    assert tspecs[0].input_dim == 26 << 20 and tspecs[1].output_dim == 1
    _, no_lin = tf.make_fused_specs(["a", "b"], [3, 4], 2, need_linear=False)
    assert list(no_lin.fuse({"a": np.array([2]), "b": np.array([3])})) == \
        ["fields"]


def test_fused_refusals():
    # hash groups build and fuse, int64 keys too
    specs, mapper = tf.make_fused_specs(["a", "b"], -1, 4)
    assert [s.input_dim for s in specs] == [-1, -1]
    assert [s.key_dtype for s in specs] == ["wide", "wide"]
    assert tf.FusedMapper(("a",), (-1,)).fuse(
        {"a": np.array([1])})["fields"].tolist() == [[[1, 0]]]
    specs64, m64 = tf.make_fused_specs(["a", "b"], -1, 4, key_dtype="int64")
    assert [s.key_dtype for s in specs64] == ["int64", "int64"]
    fused = m64.fuse({"a": np.array([2**40], np.int64),
                      "b": np.array([3], np.int64)})["fields"]
    assert fused.dtype == np.int64
    assert fused.tolist() == [[2**41, 3 * 2 + 1]]
    # the later planes fuse too, their specs JAX's
    grouped_specs, _ = tf.make_fused_specs(["a", "b"], -1, 4,
                                           plane="a2a+grouped+bf16")
    assert [(s.plane, s.exchange_precision) for s in grouped_specs] \
        == [("a2a+grouped", "bf16")] * 2
    with pytest.raises(ValueError, match="cannot fuse"):
        tf.make_fused_specs(["a", "b"], [-1, 4], 4)
    with pytest.raises(ValueError, match="must match"):
        tf.make_fused_specs(["a", "b"], [3], 4)


# an id whose key k * 26 + f wraps into the wide EMPTY band (hi word ==
# INT32_MIN), which the wide encoding remaps one hi step up
_BAND_ID = 2**63 // 26 + 1


@pytest.mark.parametrize("key_dtype", ["wide", "int32"])
@pytest.mark.parametrize("num_buckets", [1 << 22, 1 << 62])
def test_hash_fuse_matches_jax(key_dtype, num_buckets):
    """Hash fusion ``k * F + f`` (int64, wrapping) equals the JAX mapper's
    in both key encodings, on the synthetic Criteo stream and on edge ids
    (negative, wrapping, the EMPTY band), int32 and int64 columns; the
    hash specs equal JAX's field for field."""
    kw = dict(hash_capacity=1 << 23, key_dtype=key_dtype,
              optimizer={"category": "adagrad", "learning_rate": 0.01})
    jspecs, jm = jax_fused.make_fused_specs(tc.SPARSE_NAMES, -1, 9, **kw)
    tspecs, tm = tf.make_fused_specs(tc.SPARSE_NAMES, -1, 9, **kw)
    for t, j in zip(tspecs, jspecs):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.meta().to_json() == j.meta().to_json()
    stream = next(tc.synthetic_criteo(64, num_buckets=num_buckets, seed=2))
    edge = {}
    for j, name in enumerate(tc.SPARSE_NAMES):
        col = stream["sparse"][name].astype(np.int64)
        col[:4] = [-1, -(2**62) - j, _BAND_ID, 2**63 - 1 - j]
        edge[name] = col
    inputs = [stream["sparse"], edge]
    if num_buckets < 2**31:
        inputs.append({k: v.astype(np.int32)
                       for k, v in stream["sparse"].items()})
    for sparse in inputs:
        want = jm.fuse(sparse)
        got = tm.fuse(sparse)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    if key_dtype == "wide":
        band = tm.fuse(edge)["fields"][2]
        assert (band[:, 1] != np.iinfo(np.int32).min).all()


def test_synthetic_criteo_matches_jax():
    want = list(jax_criteo.synthetic_criteo(128, num_buckets=1 << 12,
                                            seed=4, num_batches=2))
    got = list(tc.synthetic_criteo(128, num_buckets=1 << 12, seed=4,
                                   num_batches=2))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["dense"], w["dense"])
        assert list(g["sparse"]) == list(w["sparse"])
        for k in w["sparse"]:
            assert g["sparse"][k].dtype == w["sparse"][k].dtype
            np.testing.assert_array_equal(g["sparse"][k], w["sparse"][k])
    assert tc.SPARSE_NAMES == jax_criteo.SPARSE_NAMES
