"""Torch port, K2 probe gather: ``openembedding_tpu_torch.ops.probe_gather``
against the JAX package's Pallas ``probe_gather`` (interpret mode, narrow
keys, dim 128: what the TPU kernel takes) and against its XLA probe
``hash_table.find_rows`` + take (wide and narrow keys, dims 1, 9 and 128,
float32 and bfloat16), on states copied from JAX through ``interop``.

A probe is integer work and a gather is a copy, so every comparison is
exact (bit-equal, bf16 included). On the CPU the wrapper runs its plain
version because the tensors lie on the CPU; the CUDA kernel itself is held
against the plain version by the GPU-marked ``tests/test_torch_gpu.py``
and by ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import openembedding_tpu as oe
from openembedding_tpu import hash_table as jh
from openembedding_tpu.ops.pallas_hash import probe_gather as jax_probe
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.ops import probe_gather as tp

EMPTY = -2**31


def _keys(rng, n, wide):
    if wide:
        k = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64)
        return np.unique(k.astype(np.int32), axis=0)
    return np.unique(rng.randint(-2**31, 2**31, n, dtype=np.int64)
                     .astype(np.int32))


def _jax_state(capacity, dim, dtype, wide, fill, seed=0):
    """A one-device JAX hash table holding ``fill`` random keys (some
    windows overflow, so some keys are absent), and the keys offered."""
    rng = np.random.RandomState(seed)
    meta = oe.meta.EmbeddingVariableMeta(datatype=dtype, embedding_dim=dim,
                                         vocabulary_size=2**63)
    st = jh.create_hash_table(meta, "default", capacity=capacity,
                              key_width=64 if wide else 32)
    keys = _keys(rng, fill, wide)
    rows = rng.randn(len(keys), dim).astype(np.float32)
    st = jh.insert_rows(st, jnp.asarray(keys),
                        jnp.asarray(rows).astype(st.weights.dtype))
    return st, keys


def _queries(rng, keys, wide):
    """Hits, misses, EMPTY queries and, for pairs, keys with hi != 0."""
    miss = _keys(rng, 20, wide)
    q = np.concatenate([keys[:30], miss, keys[-5:]])
    if wide:
        q = np.concatenate([q, [[EMPTY, EMPTY], [7, EMPTY], [0, 0], [3, -1]]])
    else:
        q = np.concatenate([q, [EMPTY, EMPTY, 0, -1]])
    return q[rng.permutation(len(q))].astype(np.int32)


def _port(st):
    return interop.hash_state_from_numpy(
        np.asarray(st.keys), np.asarray(st.weights), {}, "cpu")


def _bits(a):
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _plain(tstate, q):
    bsz, _nb, chain = th.table_layout(tstate.capacity,
                                      th.DEFAULT_MAX_PROBES)
    rows, hit = tp.probe_gather_reference(
        tstate.keys, tstate.weights, torch.from_numpy(q), chain=chain,
        bucket=bsz, empty=EMPTY)
    return interop.tensor_to_numpy(rows), hit.numpy()


@pytest.mark.parametrize("capacity", [64, 512])
def test_plain_matches_jax_pallas_interpret(capacity):
    """The plain version equals the TPU kernel run in interpret mode, fed
    the JAX ``probe_starts``: narrow keys, dim 128, hits, misses and
    EMPTY queries; a 64-slot table is one whole-table bucket."""
    st, keys = _jax_state(capacity, 128, "float32", False, capacity // 2)
    q = _queries(np.random.RandomState(1), keys, False)[:40]
    bsz, _nb, chain = jh.table_layout(capacity, jh.DEFAULT_MAX_PROBES)
    starts = jh.probe_starts(jnp.asarray(q), capacity, jh.DEFAULT_MAX_PROBES)
    want_rows, want_hit = jax_probe(st.keys, st.weights, starts,
                                    jnp.asarray(q), chain=chain, bucket=bsz,
                                    empty=EMPTY, interpret=True)
    rows, hit = _plain(_port(st), q)
    assert 0 < hit.sum() < len(q)
    np.testing.assert_array_equal(hit, np.asarray(want_hit))
    np.testing.assert_array_equal(rows, np.asarray(want_rows))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("dim,dtype", [(1, "float32"), (9, "float32"),
                                       (128, "float32"), (9, "bfloat16"),
                                       (128, "bfloat16")])
@pytest.mark.parametrize("capacity", [64, 128 * 37])
def test_plain_matches_find_rows_and_take(wide, dim, dtype, capacity):
    """The plain version equals the JAX XLA probe (``find_rows``) and a
    take with zeroing, the function every JAX read-only hash pull
    computes; the tables are filled past what every window holds, so
    absent offered keys are among the misses."""
    st, keys = _jax_state(capacity, dim, dtype, wide,
                          capacity * 5 // 4, seed=dim)
    q = _queries(np.random.RandomState(dim + capacity), keys, wide)
    slot = np.asarray(jh.find_rows(st.keys, jnp.asarray(q)))
    w = _bits(np.asarray(st.weights))
    want = np.where((slot >= 0)[:, None], w[np.maximum(slot, 0)], 0)
    rows, hit = _plain(_port(st), q)
    np.testing.assert_array_equal(hit, slot >= 0)
    np.testing.assert_array_equal(rows, want.astype(w.dtype))
    assert hit.any() and not hit.all()
    assert int(st.insert_failures) > 0


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch; n = 0
    gives empty outputs."""
    st, keys = _jax_state(256, 9, "float32", True, 100)
    tstate = _port(st)
    q = torch.from_numpy(_queries(np.random.RandomState(2), keys, True))
    before = tp.probe_gather.launches
    rows, hit = tp.probe_gather(tstate.keys, tstate.weights, q, chain=2,
                                bucket=128, empty=EMPTY)
    want = tp.probe_gather_reference(tstate.keys, tstate.weights, q,
                                     chain=2, bucket=128, empty=EMPTY)
    assert torch.equal(rows, want[0]) and torch.equal(hit, want[1])
    assert tp.probe_gather.launches == before
    rows, hit = tp.probe_gather(tstate.keys, tstate.weights, q[:0],
                                chain=2, bucket=128, empty=EMPTY)
    assert rows.shape == (0, 9) and hit.shape == (0,)


def test_wrapper_rejects_what_it_does_not_take():
    keys = torch.full((256,), EMPTY, dtype=torch.int32)
    pairs = torch.full((256, 2), EMPTY, dtype=torch.int32)
    w = torch.zeros(256, 4)
    q = torch.zeros(3, dtype=torch.int32)
    kw = dict(chain=2, bucket=128, empty=EMPTY)
    with pytest.raises(ValueError, match="key-shape mismatch"):
        tp.probe_gather(pairs, w, q, **kw)
    with pytest.raises(ValueError, match="\\[C\\] or \\[C, 2\\]"):
        tp.probe_gather(torch.zeros(256, 3, dtype=torch.int32), w,
                        torch.zeros(3, 3, dtype=torch.int32), **kw)
    with pytest.raises(TypeError, match="int32 keys"):
        tp.probe_gather(keys, w, q.long(), **kw)
    with pytest.raises(ValueError, match="weights must be"):
        tp.probe_gather(keys, w[:100], q, **kw)
    with pytest.raises(ValueError, match="probe geometry"):
        tp.probe_gather(keys, w, q, chain=3, bucket=128, empty=EMPTY)
    with pytest.raises(ValueError, match="probe geometry"):
        tp.probe_gather(keys, w, q, chain=1, bucket=100, empty=EMPTY)
    # neither cpu nor cuda: never a silent fallback to the plain version
    with pytest.raises(ValueError, match="cpu or cuda"):
        tp.probe_gather(keys.to("meta"), w.to("meta"), q.to("meta"), **kw)
    with pytest.raises(ValueError, match="several devices"):
        tp.probe_gather(keys, w, q.to("meta"), **kw)
