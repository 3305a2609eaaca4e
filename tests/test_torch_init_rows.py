"""Torch port, init rows and arrays: threefry-2x32, ``prng_key`` and
``fold_in`` (``optim/initializers.py``) against ``jax.random``; the
keyed draws (``keyed_rows``, the plain version of the init-rows kernel's
per-key mode, ``ops/init_rows.py``) against the JAX package's
``hash_table.init_rows`` on the same keys and base key; and the flat
draws (``flat_rows``, the plain version of its array mode, behind
``Initializer.init``) against ``jax.jit(initializer.init)`` on the same
key, whole and in chunks that split rows.

``uniform`` and ``constant`` rows are bit-identical, float32 and
bfloat16. ``normal`` and truncated ``normal`` rows pass through XLA's
float32 ``erf_inv``, whose polynomial XLA evaluates with its own
contractions and ``log1p``; the port's stays within
``2^-21 * (|want| + stddev)`` of it (measured: at most 3 float32 units,
95 % of draws exact), and bfloat16 rows within one bfloat16 unit more.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openembedding_tpu import hash_table as jh
from openembedding_tpu.optim import initializers as ji
from openembedding_tpu_torch.ops import init_rows as tops
from openembedding_tpu_torch.optim import initializers as ti

EMPTY = -2**31
INITIALIZERS = {
    "default": {"category": "uniform", "minval": -1e-3, "maxval": 1e-3},
    "uniform_wide_offset": {"category": "uniform", "minval": 5.0,
                            "maxval": 5.001},
    "uniform_unit": {"category": "uniform"},
    "constant": {"category": "constant", "value": 0.1},
    "normal": {"category": "normal"},
    "truncated": {"category": "normal", "truncated": True, "stddev": 0.5,
                  "mean": 0.1},
}
EXACT = ("default", "uniform_wide_offset", "uniform_unit", "constant")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _keys(wide: bool, n: int = 3000) -> np.ndarray:
    rng = np.random.RandomState(7)
    k = rng.randint(-2**31, 2**31, (n, 2), dtype=np.int64).astype(np.int32)
    k[:4] = [[0, 0], [-1, -1], [EMPTY + 1, 5], [3, -2**31 + 7]]
    return k if wide else k[:, 0].copy()


@pytest.mark.parametrize("seed", [0, 1, 123, -5, 2**31 - 1])
def test_prng_key_and_fold_in_equal_jax(seed):
    assert ti.prng_key(seed) == tuple(
        np.asarray(jax.random.PRNGKey(seed)).tolist())
    base = jax.random.PRNGKey(seed)
    for data in (0, 7, -1, 2**31 - 1, EMPTY):
        want = np.asarray(jax.random.fold_in(base, jnp.int32(data)))
        assert ti.fold_in(ti.prng_key(seed), data) == tuple(want.tolist())
    data = np.asarray([0, 7, -1, 2**31 - 1, EMPTY], np.int32)
    want = np.stack([np.asarray(jax.random.fold_in(base, d)) for d in data])
    k0, k1 = ti.fold_in(ti.prng_key(seed), torch.from_numpy(data))
    np.testing.assert_array_equal(torch.stack([k0, k1], 1).numpy(), want)


def test_seed_range_and_random_bits_equal_jax():
    with pytest.raises(ValueError, match="int32"):
        ti.prng_key(2**31)
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(5)]
    want = np.stack([np.asarray(jax.random.bits(k, (11,))) for k in keys])
    words = torch.tensor(np.stack([np.asarray(k) for k in keys]),
                         dtype=torch.int64)
    np.testing.assert_array_equal(ti.random_bits(words, 11).numpy(),
                                  want.astype(np.int64))


def test_truncation_constants_equal_xla():
    """The truncated draw's bounds are XLA's float32 ``erf(+-2/sqrt2)``."""
    sqrt2 = np.float32(np.sqrt(2))
    b = np.asarray(jax.lax.erf(jnp.float32(2.0) / sqrt2))
    a = np.asarray(jax.lax.erf(jnp.float32(-2.0) / sqrt2))
    kind, params = ti.keyed_params(
        ti.make_initializer({"category": "normal", "truncated": True}))
    assert kind == ti.TRUNCATED
    assert np.float32(params[0]) == a and np.float32(params[0]) \
        + np.float32(params[1]) == b


def _jax_rows(cfg, base, keys, dim, jdt):
    fn = jax.jit(lambda k: jh.init_rows(ji.make_initializer(cfg), base, k,
                                        dim, jdt))
    return np.asarray(fn(jnp.asarray(keys)).astype(jnp.float32))


def _assert_rows(name, cfg, got, want, torch_dtype):
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
        return
    stddev = cfg.get("stddev", 1.0)
    bound = 2.0**-21 * (np.abs(want) + stddev)
    if torch_dtype == torch.bfloat16:
        bound = bound + 2.0**-7 * np.abs(want)
    assert np.all(np.abs(got - want) <= bound), \
        float(np.max(np.abs(got - want) - bound))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("wide", [True, False], ids=["pairs", "int32"])
@pytest.mark.parametrize("name", sorted(INITIALIZERS))
def test_keyed_rows_match_jax_init_rows(name, wide, dtype):
    cfg = INITIALIZERS[name]
    jdt, tdt = DTYPES[dtype]
    base = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    keys = _keys(wide)
    want = _jax_rows(cfg, base, keys, 9, jdt)
    words = ti.key_words(tuple(np.asarray(base).tolist()),
                         torch.from_numpy(keys))
    got = ti.keyed_rows(*ti.keyed_params(ti.make_initializer(cfg)), words,
                        9, tdt)
    assert got.dtype == tdt and got.shape == (keys.shape[0], 9)
    _assert_rows(name, cfg, got.float().numpy(), want, tdt)


@pytest.mark.parametrize("wide", [True, False], ids=["pairs", "int32"])
def test_init_rows_op_fills_only_unskipped_rows(wide):
    """The kernel's contract on its plain version: rows whose skip flag is
    set keep their value, the others get the key's init row (JAX's)."""
    cfg = INITIALIZERS["default"]
    keys = _keys(wide, 500)
    base = jax.random.PRNGKey(11)
    want = _jax_rows(cfg, base, keys, 5, jnp.float32)
    skip = np.random.RandomState(0).rand(500) < 0.4
    out = torch.full((500, 5), 7.0)
    got = tops.init_rows(out, torch.from_numpy(keys), torch.from_numpy(skip),
                         tuple(np.asarray(base).tolist()),
                         ti.make_initializer(cfg))
    assert got is out
    np.testing.assert_array_equal(got.numpy()[~skip], want[~skip])
    assert bool((got[torch.from_numpy(skip)] == 7.0).all())
    empty = torch.zeros((0, 5))
    tops.init_rows(empty, torch.zeros(0, dtype=torch.int32),
                   torch.zeros(0, dtype=torch.bool), (0, 0),
                   ti.make_initializer(cfg))


def test_init_rows_op_refuses_bad_arguments():
    init = ti.make_initializer("uniform")
    out, skip = torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError, match="int32"):
        tops.init_rows(out, torch.zeros(4, dtype=torch.int64), skip, (0, 0),
                       init)
    with pytest.raises(ValueError, match="skip"):
        tops.init_rows(out, torch.zeros(4, dtype=torch.int32),
                       skip.to(torch.uint8), (0, 0), init)
    with pytest.raises(ValueError, match="uint32"):
        tops.init_rows(out, torch.zeros(4, dtype=torch.int32), skip,
                       (0, 2**32), init)


def _jax_table(cfg, key, shape, jdt):
    fn = jax.jit(lambda k: ji.make_initializer(cfg).init(k, shape, jdt))
    return np.asarray(fn(jnp.asarray(key, jnp.uint32)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(INITIALIZERS))
def test_initializer_init_matches_jax(name, dtype):
    """``Initializer.init(key, shape, dtype)`` on the CPU (the plain flat
    draw) against JAX's jitted ``init`` on the same key: every draw,
    float32 and bfloat16 (bfloat16 uniform and constant exact too)."""
    cfg = INITIALIZERS[name]
    jdt, tdt = DTYPES[dtype]
    key = ti.fold_in(ti.fold_in(ti.prng_key(3), 2), 0)
    want = _jax_table(cfg, key, (300, 9), jdt)
    got = ti.make_initializer(cfg).init(key, (300, 9), tdt, "cpu")
    assert got.dtype == tdt and got.shape == (300, 9)
    _assert_rows(name, cfg, got.float().numpy(), want, tdt)


@pytest.mark.parametrize("name", ["default", "normal", "truncated"])
def test_flat_rows_in_chunks_split_rows(name):
    """A range of rows drawn from its flat offset, in chunks of 1000
    elements (a boundary mid-row at dim 9), equals those rows of JAX's
    whole table."""
    cfg = INITIALIZERS[name]
    key = ti.prng_key(11)
    want = _jax_table(cfg, key, (400, 9), jnp.float32)
    kind, params = ti.keyed_params(ti.make_initializer(cfg))
    got = ti.flat_rows(kind, params, key, 100 * 9, 250 * 9, torch.float32,
                       chunk=1000)
    _assert_rows(name, cfg, got.reshape(250, 9).numpy(), want[100:350],
                 torch.float32)
    whole = ti.flat_rows(kind, params, key, 0, 400 * 9, torch.float32)
    assert torch.equal(whole.reshape(400, 9)[100:350], got.reshape(250, 9))


def test_init_flat_op_contract():
    """The flat kernel's contract on its plain version: ``out`` of any
    shape takes elements ``offset ..`` of the draw; counters past 2^32
    use the block's high word; a negative offset or a bad key raises."""
    init = ti.make_initializer(INITIALIZERS["default"])
    kind, params = ti.keyed_params(init)
    key = ti.prng_key(4)
    out = torch.empty(6, 5)
    assert tops.init_flat(out, key, 7, init) is out
    want = ti.flat_rows(kind, params, key, 7, 30, torch.float32)
    assert torch.equal(out.reshape(-1), want)
    hi = torch.empty(3)
    tops.init_flat(hi, key, 2**32 + 5, init)
    y0, y1 = ti.threefry2x32(key[0], key[1], torch.tensor([1, 1, 1]),
                             torch.tensor([5, 6, 7]))
    assert torch.equal(hi, ti._draw(kind, params, y0 ^ y1))
    with pytest.raises(ValueError, match="outside"):
        tops.init_flat(out, key, -1, init)
    with pytest.raises(ValueError, match="uint32"):
        tops.init_flat(out, (0, 2**32), 0, init)
    tops.init_flat(torch.empty(0, 9), key, 0, init)
