"""Row initializers for embedding tables (``openembedding_tpu/optim/initializers.py``).

``constant``, ``uniform`` (minval/maxval) and ``normal`` (mean/stddev, with
the +/-2 stddev truncated variant), with the JAX package's config dicts,
and JAX's key algebra: threefry-2x32, ``PRNGKey``, ``fold_in``, ``split``
and flax's ``_fold_in_static``, on Python ints and int64 tensors.

Every draw is JAX's, from a threefry key, so it does not depend on the
device. Two forms. ``Initializer.init(key, shape, dtype, device)`` fills
an array as ``jax.random`` fills it from one key
(``jax_threefry_partitionable``): element ``i`` of the flattened array
takes the 32 bits ``x0 ^ x1`` of the block of counter ``(i >> 32, i &
0xffffffff)`` (``flat_draw``, ``flat_rows``). ``keyed_rows`` draws the row
of each hash key from its own key, as ``jax.vmap(initializer.init)`` over
``jax.random.fold_in`` keys does (``hash_table.init_rows``): element
``j`` from the block ``(0, j)``. The float conversions are JAX's, so
``uniform`` and ``constant`` values equal JAX's bit for bit, and
``normal`` ones (XLA's float32 ``erf_inv``, another polynomial
evaluation order) lie within a few float32 units of them. These
functions are the plain versions of the CUDA kernel in
``ops/init_rows.py`` (KI), which ``Initializer.init`` launches for a CUDA
tensor.

torch has no general uint32 arithmetic: threefry runs on int64 tensors
(or Python ints) holding uint32 values, masked to 32 bits after each add.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import coerce_fields
from ..utils.device import DeviceLike, resolve_device

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# the keyed draws' kinds, shared with csrc/init_rows.cu
CONSTANT, UNIFORM, NORMAL, TRUNCATED = range(4)

_F32 = np.float32
_SQRT2 = _F32(np.sqrt(2))
# jax.random.normal draws u on (nextafter(-1, 0), 1)
_NORMAL_LO = np.nextafter(_F32(-1), _F32(0))
# jax.random.truncated_normal(-2, 2): u between erf(-2/sqrt2) and
# erf(2/sqrt2) as XLA's float32 erf gives them (the bits are pinned by
# tests/test_torch_init_rows.py), clipped to the open interval
_ERF_TWO = _F32(np.uint32(1064589848).view(np.float32))   # 0.9544997
_TRUNC_HI = np.nextafter(_F32(2), _F32(0))

# XLA's ErfInv32: Giles' single-precision polynomials in w = -log1p(-x^2)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# --- threefry-2x32 and JAX's key helpers --------------------------------------

def _rotl(v, r: int):
    return ((v << r) & _MASK32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """One threefry-2x32 block (20 rounds) of counter ``(x0, x1)`` under key
    ``(k0, k1)``: int64 tensors or Python ints holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """The two words of ``jax.random.PRNGKey(seed)`` (32-bit seeds, as JAX
    takes them without x64)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside the int32 range")
    return 0, seed & _MASK32


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: one threefry block of
    ``(0, uint32(data))`` under ``key``. ``key`` is a pair of words (ints
    or int64 tensors), ``data`` an int or an integer tensor (negative
    values wrap to uint32). Returns the new pair of words."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64)
    return threefry2x32(key[0], key[1], 0, data & _MASK32)


def threefry_key(rng) -> Tuple[int, int]:
    """A threefry key as two uint32 ints (``None``: ``PRNGKey(0)``); takes
    a pair of ints or any two-word array (a JAX key as numpy)."""
    if rng is None:
        return prng_key(0)
    words = tuple(int(w) for w in rng)
    if len(words) != 2 or not all(0 <= w <= _MASK32 for w in words):
        raise ValueError(f"a threefry key is two uint32 words, got {rng}")
    return words


def split(key, n: int = 2) -> Tuple[Tuple[int, int], ...]:
    """``jax.random.split(key, n)`` with ``jax_threefry_partitionable``:
    key ``i`` is the block of counter ``(0, i)`` under ``key``."""
    k0, k1 = threefry_key(key)
    return tuple(threefry2x32(k0, k1, 0, i) for i in range(n))


def fold_in_static(key, path: Sequence[Any]) -> Tuple[int, int]:
    """flax's ``_fold_in_static`` (``flax/core/scope.py``, with
    ``flax_fix_rng_separator`` off, flax's default): the SHA-1 of the
    path's parts, strings as UTF-8 and ints as their shortest big-endian
    bytes, with no separator; its first 4 bytes, big-endian, folded into
    ``key``. An empty path returns ``key``."""
    key = threefry_key(key)
    if not path:
        return key
    h = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            h.update(x.encode("utf-8"))
        elif isinstance(x, int):
            h.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return fold_in(key, int.from_bytes(h.digest()[:4], "big"))


def flax_param_key(rng, scope: Sequence[str], index: int) -> Tuple[int, int]:
    """The key flax's ``make_rng("params")`` gives the ``index``-th
    parameter (1-based) a module creates in scope ``scope`` under
    ``module.init(rng, ...)``: each child scope appends its name to the
    root key's lazy suffix (``LazyRng.create``), each ``make_rng`` in a
    scope appends that scope's counter, and the suffix is folded in at
    once (``fold_in_static``). A flax ``Dense`` creates its ``kernel``
    first (index 1), then its ``bias`` (index 2)."""
    return fold_in_static(rng, tuple(scope) + (int(index),))


def random_bits(words: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.random.bits(key, (dim,))`` for each row of ``[n, 2]`` key
    words (int64 holding uint32): ``x0 ^ x1`` of the block of counter
    ``(0, i)`` for element ``i`` (``jax_threefry_partitionable``).
    Returns ``[n, dim]`` int64."""
    i = torch.arange(dim, dtype=torch.int64, device=words.device)
    y0, y1 = threefry2x32(words[:, :1], words[:, 1:], 0, i)
    return y0 ^ y1


def key_words(base: Tuple[int, int], keys: torch.Tensor) -> torch.Tensor:
    """Each hash key's threefry key, ``[n, 2]`` int64: wide ``[n, 2]`` pair
    keys fold their lo word into ``base``, then their hi word; ``[n]``
    keys fold once (``hash_table.init_rows``)."""
    if keys.dim() == 2:
        k = fold_in(base, keys[:, 0])
        k = fold_in(k, keys[:, 1])
    else:
        k = fold_in(base, keys)
    k0, k1 = (torch.as_tensor(w, dtype=torch.int64, device=keys.device)
              .expand(keys.shape[0]) for w in k)
    return torch.stack([k0, k1], dim=1)


# --- float conversions, rounded where XLA rounds -------------------------------

def _fma32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` for float32 ``a`` and float32 constants, rounded once to
    float32 (a fused multiply-add). The product is exact in float64; the
    sum is rounded to odd in float64 (its exact error from TwoSum picks the
    odd neighbour), so the final rounding to float32 is correct."""
    p = a.to(torch.float64) * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _uniform(bits: torch.Tensor, lo, span) -> torch.Tensor:
    """``jax.random.uniform``'s float32 draw from 32 random bits: the
    mantissa bits under exponent 0 minus 1, then ``max(lo, u * span + lo)``
    with one rounding, as XLA's CPU code contracts it."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = _fma32(one - 1.0, float(span), float(lo))
    return torch.clamp_min(u, float(lo))


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' polynomials), in float32 steps."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, torch.tensor(c_lt, dtype=torch.float32),
                        torch.tensor(c_ge, dtype=torch.float32)) + p * w
    big = x * float(np.finfo(np.float32).max)
    return torch.where(x.abs() == 1.0, big, p * x)


def keyed_params(initializer: "Initializer"
                 ) -> Tuple[int, Tuple[float, ...]]:
    """The keyed draw of ``initializer`` as ``(kind, (p0, .., p5))``, every
    parameter a float32 value: constant ``(value,)``; uniform ``(lo, span)``;
    normal ``(lo, span, stddev, mean)``; truncated ``(lo, span, stddev,
    mean, clip_lo, clip_hi)``. The CUDA kernel takes the same six."""
    if isinstance(initializer, Constant):
        return CONSTANT, (float(_F32(initializer.value)),) + (0.0,) * 5
    if isinstance(initializer, Uniform):
        lo, hi = _F32(initializer.minval), _F32(initializer.maxval)
        return UNIFORM, (float(lo), float(hi - lo), 0.0, 0.0, 0.0, 0.0)
    if isinstance(initializer, Normal):
        scale = (float(_F32(initializer.stddev)),
                 float(_F32(initializer.mean)))
        if initializer.truncated:
            lo = -_ERF_TWO
            return TRUNCATED, (float(lo), float(_ERF_TWO - lo)) + scale \
                + (float(-_TRUNC_HI), float(_TRUNC_HI))
        return NORMAL, (float(_NORMAL_LO), float(_F32(1) - _NORMAL_LO)) \
            + scale + (0.0, 0.0)
    raise TypeError(f"no keyed draw for {type(initializer).__name__}")


def _draw(kind: int, params, bits: torch.Tensor) -> torch.Tensor:
    """float32 values from 32 random bits each (int64 holding uint32), as
    the initializer's ``jax.random`` call converts them; not for
    ``CONSTANT``."""
    x = _uniform(bits, params[0], params[1])
    if kind == UNIFORM:
        return x
    x = erfinv32(x) * float(_SQRT2)
    if kind == TRUNCATED:
        x = torch.clamp(x, params[4], params[5])
    return x * params[2] + params[3]


def keyed_rows(kind: int, params, words: torch.Tensor, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """``[n, dim]`` rows of ``dtype`` from ``[n, 2]`` key words (int64
    holding uint32), as ``jax.vmap(lambda k: init.init(k, (dim,), dtype))``
    draws them: the plain version of the keyed draw (:func:`keyed_params`
    gives ``kind`` and ``params``)."""
    n = words.shape[0]
    if kind == CONSTANT:
        return torch.full((n, dim), params[0], dtype=torch.float32,
                          device=words.device).to(dtype)
    return _draw(kind, params, random_bits(words, dim)).to(dtype)


def flat_draw(kind: int, params, key, index: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """The elements at flat positions ``index`` (int64, >= 0, any shape)
    of an array that ``init.init(key, shape, dtype)`` fills in JAX:
    element ``i`` from the block of counter ``(i >> 32, i & 0xffffffff)``
    under ``key``. Same shape as ``index``, of ``dtype`` (drawn in
    float32, then rounded)."""
    if kind == CONSTANT:
        return torch.full(index.shape, params[0], dtype=torch.float32,
                          device=index.device).to(dtype)
    k0, k1 = threefry_key(key)
    index = index.to(torch.int64)
    y0, y1 = threefry2x32(k0, k1, index >> 32, index & _MASK32)
    return _draw(kind, params, y0 ^ y1).to(dtype)


FLAT_CHUNK = 1 << 22     # elements a chunk of the plain flat draw


def flat_rows(kind: int, params, key, offset: int, count: int,
              dtype: torch.dtype, device: DeviceLike = "cpu",
              chunk: int = FLAT_CHUNK) -> torch.Tensor:
    """Elements ``offset .. offset + count - 1`` of the flat draw under
    ``key``, ``[count]`` of ``dtype`` on ``device``: the plain version of
    KI's array mode. It draws ``chunk`` elements at a time, so its int64
    work tensors stay at ``chunk`` elements whatever ``count`` is; a chunk
    boundary may fall anywhere, mid-row too."""
    out = torch.empty(count, dtype=dtype, device=device)
    for lo in range(0, count, chunk):
        hi = min(count, lo + chunk)
        idx = torch.arange(offset + lo, offset + hi, dtype=torch.int64,
                           device=out.device)
        out[lo:hi] = flat_draw(kind, params, key, idx, dtype)
    return out


# --- the initializers -----------------------------------------------------------

class Initializer:
    """Base class. ``init(key, shape, dtype, device)`` draws an array from
    a threefry key as JAX's ``init`` does; ``keyed_rows(*keyed_params(
    init), words, dim, dtype)`` draws one row per threefry key."""

    category: str = ""

    def init(self, key, shape, dtype: torch.dtype,
             device: DeviceLike = None) -> torch.Tensor:
        """``jax``'s ``initializer.init(key, shape, dtype)``, the same values
        on any device: through KI's array mode for a CUDA array, its plain
        version on the CPU. Types other than float32 and bfloat16 are
        drawn in float32 and converted, as JAX's ``astype``."""
        from ..ops.init_rows import init_flat
        store = dtype if dtype in (torch.float32, torch.bfloat16) \
            else torch.float32
        out = torch.empty(tuple(shape), dtype=store,
                          device=resolve_device(device))
        init_flat(out, key, 0, self)
        return out if store == dtype else out.to(dtype)

    def to_config(self) -> dict:
        out = {"category": self.category}
        out.update(dataclasses.asdict(self))
        return out


@dataclasses.dataclass(frozen=True)
class Constant(Initializer):
    value: float = 0.0
    category = "constant"


@dataclasses.dataclass(frozen=True)
class Uniform(Initializer):
    minval: float = -1.0
    maxval: float = 1.0
    category = "uniform"


@dataclasses.dataclass(frozen=True)
class Normal(Initializer):
    mean: float = 0.0
    stddev: float = 1.0
    truncated: bool = False
    category = "normal"


_REGISTRY = {
    "constant": Constant,
    "uniform": Uniform,
    "normal": Normal,
}


def make_initializer(config: Any) -> Initializer:
    """Build an initializer from an Initializer, config dict, or name."""
    if isinstance(config, Initializer):
        return config
    if isinstance(config, str):
        config = {"category": config}
    config = dict(config)
    category = config.pop("category")
    if category not in _REGISTRY:
        raise ValueError(f"unknown initializer category {category!r}; "
                         f"known: {sorted(_REGISTRY)}")
    cls = _REGISTRY[category]
    return cls(**coerce_fields(cls, config))
