"""Torch port, ``ops/dedup.py`` against ``openembedding_tpu/ops/dedup.py``:
``unique_indices``, ``combine_gradients``, ``overflow_count`` and the wide
keys' ``unique_pairs``/``unique_rows`` on the same numpy inputs, compared
exactly (ids, inverse map, validity, summed gradients and counts). On the
CPU both scatter-adds sum in index order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openembedding_tpu.ops import dedup as jd
from openembedding_tpu_torch.ops import dedup as td

INT32_MIN = -2**31


def _cases():
    rng = np.random.RandomState(0)
    dup = rng.randint(0, 50, 300).astype(np.int32)
    return {
        "duplicates": (dup, None),
        "negative": (rng.randint(-20, 20, 200).astype(np.int32), None),
        "int32_min": (np.asarray([5, INT32_MIN, 3, INT32_MIN, 5, -1, 0],
                                 np.int32), None),
        "large_ids": (np.concatenate([dup, [2**31 - 1, 10**9, 10**9]]
                                     ).astype(np.int32), None),
        "int64": (rng.randint(-2**31, 2**31, 400).astype(np.int64), None),
        "overflow": (rng.randint(0, 1000, 300).astype(np.int32), 64),
        "capacity_above_n": (dup, 500),
        "n1": (np.asarray([7], np.int32), None),
        "n1_capacity_4": (np.asarray([-7], np.int32), 4),
        "n0": (np.zeros(0, np.int32), None),
        "n0_capacity_3": (np.zeros(0, np.int32), 3),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_unique_indices_equals_jnp_unique(case):
    ids, capacity = CASES[case]
    ju, jinv, jvalid = jd.unique_indices(jnp.asarray(ids), capacity)
    tu, tinv, tvalid = td.unique_indices(torch.from_numpy(ids), capacity)
    assert tu.dtype == torch.from_numpy(ids).dtype
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    cap = capacity if capacity is not None else ids.size
    assert int(td.overflow_count(tinv, cap)) == \
        int(jd.overflow_count(jinv, cap))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("counted", [False, True])
def test_combine_gradients_equals_jax(case, counted):
    ids, capacity = CASES[case]
    rng = np.random.RandomState(1)
    grads = rng.randn(ids.size, 5).astype(np.float32)
    in_counts = rng.randint(1, 5, ids.size).astype(np.int32) \
        if counted else None
    cap = capacity if capacity is not None else ids.size
    _, jinv, _ = jd.unique_indices(jnp.asarray(ids), capacity)
    _, tinv, _ = td.unique_indices(torch.from_numpy(ids), capacity)
    js, jc = jd.combine_gradients(
        jnp.asarray(grads), jinv, cap,
        None if in_counts is None else jnp.asarray(in_counts))
    ts, tc = td.combine_gradients(
        torch.from_numpy(grads), tinv, cap,
        None if in_counts is None else torch.from_numpy(in_counts))
    assert ts.shape == (cap, 5) and tc.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_overflow_drops_the_largest_ids():
    """With more distinct ids than the capacity, the buffer keeps the
    smallest ones and the rest count as overflow."""
    ids = torch.tensor([9, 1, 5, 9, 3, 7], dtype=torch.int32)
    uniq, inv, valid = td.unique_indices(ids, 3)
    assert uniq.tolist() == [1, 3, 5] and bool(valid.all())
    assert int(td.overflow_count(inv, 3)) == 3
    summed, counts = td.combine_gradients(torch.ones(6, 2), inv, 3)
    assert counts.tolist() == [1, 1, 1] and summed.tolist() == [[1, 1]] * 3


def _pair_cases():
    rng = np.random.RandomState(2)
    small = rng.randint(-3, 3, (300, 2)).astype(np.int32)
    small[:6] = [[INT32_MIN, INT32_MIN], [4, INT32_MIN], [4, INT32_MIN],
                 [-1, -1], [INT32_MIN, 0], [2**31 - 1, INT32_MIN + 1]]
    wide = rng.randint(-2**31, 2**31, (400, 2), dtype=np.int64)
    wide = np.concatenate([wide, wide[:50]]).astype(np.int32)
    return {
        "duplicates_empty_negative": (small, None),
        "full_range": (wide, None),
        "overflow": (wide, 64),
        "capacity_above_n": (small, 500),
        "n1": (np.asarray([[-7, 3]], np.int32), None),
        "n1_empty": (np.asarray([[5, INT32_MIN]], np.int32), 2),
    }


PAIR_CASES = _pair_cases()


@pytest.mark.parametrize("fn", ["unique_pairs", "unique_rows"])
@pytest.mark.parametrize("case", sorted(PAIR_CASES))
def test_unique_pairs_equal_jax(case, fn):
    """Element for element JAX's order (hi major, lo minor, both signed),
    inverse map, validity (no group whose hi word is the fill), overflow."""
    pairs, capacity = PAIR_CASES[case]
    ju, jinv, jvalid = getattr(jd, fn)(jnp.asarray(pairs), capacity)
    tu, tinv, tvalid = getattr(td, fn)(torch.from_numpy(pairs), capacity)
    assert tu.dtype == torch.int32 and tinv.dtype == torch.int64
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_unique_rows_three_columns_equal_jax():
    rng = np.random.RandomState(3)
    rows = rng.randint(-2, 2, (200, 3)).astype(np.int32)
    rows[:2, 2] = INT32_MIN
    for capacity in (None, 8):
        ju, jinv, jvalid = jd.unique_rows(jnp.asarray(rows), capacity)
        tu, tinv, tvalid = td.unique_rows(torch.from_numpy(rows), capacity)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("fn", ["unique_pairs", "unique_rows"])
def test_unique_pairs_empty_input(fn):
    """n = 0 (the JAX functions cannot take it): a buffer of fill rows,
    none valid, an empty inverse map."""
    uniq, inv, valid = getattr(td, fn)(torch.zeros((0, 2), dtype=torch.int32),
                                       3)
    assert uniq.tolist() == [[INT32_MIN, INT32_MIN]] * 3
    assert inv.shape == (0,) and not bool(valid.any())
