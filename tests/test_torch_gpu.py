"""Torch port, the CUDA kernels against their plain versions on the card.

Every test here carries the ``gpu`` marker and skips without a card. The
file imports torch, numpy and the port only, never jax, so it runs on a
machine that has the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX's virtual devices.)
Every comparison is exact: the kernels copy rows and compare integers.
"""

import numpy as np
import pytest
import torch

from openembedding_tpu_torch import hash_table as th
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.ops import gather as tg
from openembedding_tpu_torch.ops import probe_gather as tp

EMPTY = -2**31


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


@pytest.mark.gpu
def test_gather_rows_kernel_matches_plain():
    """K1: the CUDA kernel against its plain version, exact, at dims 9 / 1
    / 64, f32 and bf16, int32 and int64 ids (wild ones too)."""
    _need_card()
    rng = np.random.RandomState(0)
    for dim, dtype in ((9, torch.float32), (1, torch.float32),
                       (64, torch.bfloat16)):
        table = torch.randn(1000, dim, device="cuda").to(dtype)
        for ids in (rng.randint(-5, 1005, 3001).astype(np.int32),
                    np.asarray([2**32 + 3, -(2**40), 999, 0, 1000],
                               np.int64)):
            t_ids = torch.from_numpy(ids).cuda()
            before = tg.gather_rows.launches
            got = tg.gather_rows(table, t_ids)
            torch.cuda.synchronize()
            assert tg.gather_rows.launches == before + 1
            assert torch.equal(got, tg.gather_rows_reference(table, t_ids))
    empty = tg.gather_rows(table, torch.zeros(0, dtype=torch.int64,
                                              device="cuda"))
    assert empty.shape == (0, 64)


def _keys(rng, n, wide):
    if wide:
        k = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64)
        return np.unique(k.astype(np.int32), axis=0)
    return np.unique(rng.randint(-2**31 + 1, 2**31, n, dtype=np.int64)
                     .astype(np.int32))


@pytest.mark.gpu
def test_probe_gather_kernel_matches_plain():
    """K2: the CUDA kernel against its plain version, exact, on narrow and
    wide keys, dims 1 / 9 / 128, f32 and bf16, a one-bucket table and an
    odd span, hits, misses and EMPTY queries, one launch per call and
    none for n = 0."""
    _need_card()
    rng = np.random.RandomState(0)
    for capacity in (64, 128 * 37):
        for wide in (False, True):
            keys = _keys(rng, capacity // 2, wide)
            miss = _keys(rng, 40, wide)
            empty = np.full((3, 2) if wide else 3, EMPTY, np.int32)
            q = np.concatenate([keys, miss, empty])
            q = torch.from_numpy(q[rng.permutation(len(q))]).cuda()
            for dim, dtype in ((1, "float32"), (9, "float32"),
                               (128, "bfloat16")):
                st = th.create_hash_table(
                    EmbeddingVariableMeta(dtype, dim, 2**63), "default",
                    capacity=capacity,
                    key_dtype="wide" if wide else "int32", device="cuda")
                th.insert_rows(st, torch.from_numpy(keys).cuda(),
                               torch.randn(len(keys), dim, device="cuda"))
                assert int(st.insert_failures) == 0
                bsz, _nb, chain = th.table_layout(capacity,
                                                  th.DEFAULT_MAX_PROBES)
                kw = dict(chain=chain, bucket=bsz, empty=EMPTY)
                before = tp.probe_gather.launches
                rows, hit = tp.probe_gather(st.keys, st.weights, q, **kw)
                torch.cuda.synchronize()
                assert tp.probe_gather.launches == before + 1
                want_rows, want_hit = tp.probe_gather_reference(
                    st.keys, st.weights, q, **kw)
                assert torch.equal(rows, want_rows)
                assert torch.equal(hit, want_hit)
                assert int(hit.sum()) == len(keys)
                rows, hit = tp.probe_gather(st.keys, st.weights, q[:0], **kw)
                assert rows.shape == (0, dim) and hit.shape == (0,)
                assert tp.probe_gather.launches == before + 1
