"""Torch port, K1 row gather: ``openembedding_tpu_torch.ops.gather`` against
the JAX package's Pallas ``gather_rows`` (interpret mode, on a
``pad_table``-padded table) and its ``table.pull``.

A gather is a copy, so every comparison is exact (bit-equal, bf16
included). On the CPU the wrapper runs its plain version because the
tensors lie on the CPU; the CUDA kernel itself is held against the plain
version by the GPU-marked test here and by ``chip_smoke.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu import table as jax_table
from openembedding_tpu.ops.pallas_gather import gather_rows as jax_gather
from openembedding_tpu.ops.pallas_gather import pad_table
from openembedding_tpu.utils import jaxcompat
from openembedding_tpu_torch import interop
from openembedding_tpu_torch.ops import gather as tg

V = 50


def _table(dim, dtype, seed=0):
    w = np.random.RandomState(seed).randn(V, dim).astype(np.float32)
    return w.astype(jnp.bfloat16) if dtype == "bfloat16" else w


def _ids(kind, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "i32_invalid_n13":
        ids = rng.randint(0, V, 13).astype(np.int32)
        ids[[2, 7, 11]] = [-1, V, np.iinfo(np.int32).max]
        return ids
    if kind == "i64_wide":
        ids = rng.randint(0, V, 21).astype(np.int64)
        ids[[0, 5, 9, 14, 20]] = [2**32 + 3, -(2**40), V, 2**32, -1]
        return ids
    if kind == "i32_dup":
        return rng.randint(0, 4, 16).astype(np.int32)
    return np.zeros(0, np.int32)


CASES = [
    (9, "float32", "i32_invalid_n13"),
    (1, "float32", "i32_invalid_n13"),
    (9, "float32", "i64_wide"),
    (1, "float32", "i64_wide"),
    (9, "bfloat16", "i32_invalid_n13"),
    (9, "bfloat16", "i64_wide"),
    (128, "float32", "i32_dup"),
]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _port(table_np, ids):
    out = tg.gather_rows(interop.tensor_from_numpy(table_np, "cpu"),
                         torch.from_numpy(ids))
    return interop.tensor_to_numpy(out)


@pytest.mark.parametrize("dim,dtype,ids_kind", CASES)
def test_gather_matches_jax_pallas_interpret(devices8, dim, dtype, ids_kind):
    """Exact: the port's gather equals the Pallas kernel's output
    (interpret mode on the padded table, cut back to ``dim``)."""
    table = _table(dim, dtype)
    ids = _ids(ids_kind)
    with jaxcompat.enable_x64(ids.dtype == np.int64):
        want = np.asarray(jax_gather(pad_table(jnp.asarray(table)),
                                     jnp.asarray(ids), interpret=True))
    want = want[:, :dim]
    got = _port(table, ids)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, _bits(np.ascontiguousarray(want)))


@pytest.mark.parametrize("dim,dtype,ids_kind", CASES + [
    (9, "float32", "empty"), (1, "float32", "empty")])
def test_gather_matches_jax_table_pull(devices8, dim, dtype, ids_kind):
    """Exact: the port's gather equals JAX ``table.pull`` (the XLA path
    serving runs), including n = 0."""
    table = _table(dim, dtype)
    ids = _ids(ids_kind)
    state = jax_table.TableState(weights=jnp.asarray(table), slots={})
    with jaxcompat.enable_x64(ids.dtype == np.int64):
        want = np.asarray(jax_table.pull(state, jnp.asarray(ids)))
    got = _port(table, ids)
    assert got.shape == (ids.size, dim)
    np.testing.assert_array_equal(got, _bits(want))


def test_plain_path_counts_no_launch():
    before = tg.gather_rows.launches
    tg.gather_rows(torch.zeros(4, 3), torch.tensor([0, 9], dtype=torch.int32))
    assert tg.gather_rows.launches == before


def test_wrapper_rejects_what_it_does_not_take():
    table = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="\\[V, D\\]"):
        tg.gather_rows(table, torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="\\[V, D\\]"):
        tg.gather_rows(torch.zeros(4), torch.zeros(2, dtype=torch.int64))
    # neither cpu nor cuda: never a silent fallback to the plain version
    with pytest.raises(ValueError, match="cpu or cuda"):
        tg.gather_rows(table.to("meta"),
                       torch.zeros(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="indices on"):
        tg.gather_rows(table, torch.zeros(2, dtype=torch.int64,
                                          device="meta"))
