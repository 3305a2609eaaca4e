"""Torch port, the table invariant K2's early stop relies on.

The CUDA probe-gather kernel (``csrc/probe_gather.cu``) ends a query's
scan at the first slot of its window that holds its key or EMPTY. That is
the full-window answer when no stored key lies after an EMPTY slot of its
own window, which holds because slots are never freed and
``find_or_insert`` gives a key the first free slot of the first bucket of
its window that has one. These tests build tables three ways (the port's
``insert_rows``, the port's ``find_or_insert``, and the JAX package's
``find_or_insert`` copied through ``interop``) at tiny geometries, with
batches that collide on overlapping windows, overflow into a window's
second bucket and fail some inserts, and check:

- no stored key has an EMPTY slot before it in its own window;
- the plain version with every slot after a window's first EMPTY masked
  out answers exactly as the unmasked plain version.

Narrow int32 keys and wide (lo, hi) pairs, seeded numpy inputs; every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu import hash_table as jh
from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.ops import probe_gather as tp

EMPTY = -2**31
DIM = 3


def _pool(rng, n, wide):
    """``n`` distinct keys, none of them EMPTY."""
    if wide:
        k = rng.randint(-2**31, 2**31, (3 * n, 2), dtype=np.int64)
        k = np.unique(k.astype(np.int32), axis=0)
        k = k[k[:, 1] != EMPTY]
    else:
        k = np.unique(rng.randint(-2**31 + 1, 2**31, 3 * n, dtype=np.int64)
                      .astype(np.int32))
    return k[rng.permutation(len(k))[:n]]


def _batches(rng, capacity, wide):
    """Three insert batches from one pool: the second re-offers some keys
    of the first, the third offers more keys than the table holds (its
    windows overflow: failed inserts); each carries two EMPTY keys."""
    pool = _pool(rng, 2 * capacity, wide)
    third = capacity // 3
    empty = np.full((2, 2) if wide else 2, EMPTY, np.int32)
    return [np.concatenate([pool[lo:lo + size], empty])
            for lo, size in ((0, third), (third // 2, third),
                             (capacity // 2, capacity))], pool


def _build(how, capacity, wide, batches):
    """The key array (and weights) of a table filled with ``batches``."""
    shape = (capacity, 2) if wide else (capacity,)
    if how == "jax_find_or_insert":
        keys = jnp.full(shape, EMPTY, jnp.int32)
        for b in batches:
            valid = (b[:, 1] if wide else b) != EMPTY
            keys, _slot, _ins, _fail = jh.find_or_insert(
                keys, jnp.asarray(b), jnp.asarray(valid))
        st = interop.hash_state_from_numpy(
            np.asarray(keys), np.zeros((capacity, DIM), np.float32), {},
            "cpu")
        return st.keys
    if how == "port_find_or_insert":
        keys = torch.full(shape, EMPTY, dtype=torch.int32)
        for b in batches:
            valid = (b[:, 1] if wide else b) != EMPTY
            th.find_or_insert(keys, torch.from_numpy(b),
                              torch.from_numpy(valid))
        return keys
    st = th.create_hash_table(
        EmbeddingVariableMeta("float32", DIM, 2**63), "default",
        capacity=capacity, key_dtype="wide" if wide else "int32",
        device="cpu")
    for b in batches:
        th.insert_rows(st, torch.from_numpy(b), torch.zeros(len(b), DIM))
    assert int(st.insert_failures) > 0
    return st.keys


def _free(keys):
    return (keys[:, 1] if keys.dim() == 2 else keys) == EMPTY


def _masked_plain(keys, weights, query, chain, bucket):
    """The plain version with every slot from a window's first EMPTY on
    masked out (set EMPTY), window by window."""
    nb = keys.shape[0] // bucket
    start = th.window_starts(query, nb, chain, bucket)
    rows = torch.zeros((query.shape[0], weights.shape[1]),
                       dtype=weights.dtype)
    hit = torch.zeros(query.shape[0], dtype=torch.bool)
    for s in start.unique().tolist():
        sel = start == s
        end = s + chain * bucket
        masked = keys.clone()
        free = _free(keys[s:end])
        if bool(free.any()):
            masked[s + int(free.to(torch.uint8).argmax()):end] = EMPTY
        rows[sel], hit[sel] = tp.probe_gather_reference(
            masked, weights, query[sel], chain=chain, bucket=bucket,
            empty=EMPTY)
    return rows, hit


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("how", ["port_insert_rows", "port_find_or_insert",
                                 "jax_find_or_insert"])
@pytest.mark.parametrize("capacity", [128 * 4, 64])
def test_no_stored_key_after_an_empty_slot(capacity, how, wide):
    """Capacity 512 is four 128-slot buckets with 2-bucket windows (three
    overlapping windows); capacity 64 is one whole-table bucket."""
    rng = np.random.RandomState(capacity + len(how) + wide)
    batches, pool = _batches(rng, capacity, wide)
    keys = _build(how, capacity, wide, batches)
    bsz, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    live = ~_free(keys)
    slots = torch.nonzero(live).flatten()
    start = th.probe_starts(keys[slots], capacity, th.DEFAULT_MAX_PROBES)
    assert bool(((slots >= start) & (slots < start + chain * bsz)).all())
    free_before = torch.cat([torch.zeros(1, dtype=torch.int64),
                             torch.cumsum((~live).long(), 0)])
    assert torch.equal(free_before[slots] - free_before[start],
                       torch.zeros_like(slots))
    if chain > 1:
        assert bool(((slots - start) >= bsz).any())   # overflowed keys
    assert int(live.sum()) < len(pool)                # failed inserts

    weights = torch.from_numpy(
        rng.randn(capacity, DIM).astype(np.float32))
    empty = np.full((3, 2) if wide else 3, EMPTY, np.int32)
    query = torch.from_numpy(np.concatenate(
        [pool, _pool(rng, 40, wide), empty]))
    want_rows, want_hit = tp.probe_gather_reference(
        keys, weights, query, chain=chain, bucket=bsz, empty=EMPTY)
    rows, hit = _masked_plain(keys, weights, query, chain, bsz)
    assert torch.equal(hit, want_hit)
    assert torch.equal(rows, want_rows)
    assert 0 < int(hit.sum()) < len(query)


@pytest.mark.parametrize("wide", [False, True])
def test_masked_plain_tells_a_freed_slot(wide):
    """The check above is not vacuous: free one slot in front of a stored
    key (no insert path does that) and the masked plain version misses the
    key, while the full-window plain version still finds it."""
    rng = np.random.RandomState(7)
    capacity = 128 * 4
    batches, _pool_keys = _batches(rng, capacity, wide)
    keys = _build("port_find_or_insert", capacity, wide, batches)
    bsz, _nb, chain = th.table_layout(capacity, th.DEFAULT_MAX_PROBES)
    slots = torch.nonzero(~_free(keys)).flatten()
    start = th.probe_starts(keys[slots], capacity, th.DEFAULT_MAX_PROBES)
    victim = int(torch.nonzero(slots - start > 0).flatten()[0])
    query = keys[slots[victim]][None].clone()
    keys[start[victim]] = EMPTY                 # free a slot before it
    weights = torch.ones(capacity, DIM)
    _rows, full_hit = tp.probe_gather_reference(
        keys, weights, query, chain=chain, bucket=bsz, empty=EMPTY)
    _rows, masked_hit = _masked_plain(keys, weights, query, chain, bsz)
    assert bool(full_hit[0]) and not bool(masked_hit[0])
