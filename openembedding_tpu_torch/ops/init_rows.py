"""Threefry init rows and arrays: the wrappers of ``csrc/init_rows.cu``
(KI), in its two modes.

No TPU kernel stands behind it: the JAX package draws these values in XLA.
- Per key (:func:`init_rows`): a hash table's init rows
  (``openembedding_tpu/hash_table.py`` ``init_rows``, a ``jax.vmap`` of
  the initializer over ``jax.random.fold_in`` keys). For each row whose
  ``skip`` flag is clear, the key's threefry key and its row's draws,
  written in place. The pull passes the probe kernel's rows with ``skip =
  hit | EMPTY key``; the push the gathered rows with ``skip =
  ~inserted``.
- Flat (:func:`init_flat`): a whole array from one key, as
  ``initializer.init(key, shape, dtype)`` draws it
  (``openembedding_tpu/optim/initializers.py``, under
  ``parallel/sharded_table.py``'s per-shard key): element ``i`` of the
  flattened array from the block of counter ``offset + i``. Array tables
  and the dense parameters start from it.

In the port each draw would cost its threefry blocks as a few hundred
PyTorch operations, so it is one kernel. Dispatch is by the device the
tensors lie on, nothing else: CPU tensors take the plain versions
(:func:`init_rows_reference`, :func:`init_flat_reference`, on the draws
of ``optim/initializers.py``); CUDA tensors launch the kernel or raise.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..optim.initializers import (Initializer, flat_rows, key_words,
                                  keyed_params, keyed_rows, threefry_key)
from . import launches

_WORD_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_INDEX_LIMIT = 2**31        # the per-key kernel's 32-bit element indices
FLAT_LAUNCH = 1 << 30       # elements one flat launch fills at most
_fns = {}                   # the C entries, once built and loaded


def base_words(base) -> Tuple[int, int]:
    """A base key as two host ints: ``base`` as it is, or the two uint32
    words of an int32 key tensor (read back: a plain version's or a
    host caller's use, never a kernel launch's)."""
    if isinstance(base, torch.Tensor):
        w = base.tolist()
        return int(w[0]) & 0xFFFFFFFF, int(w[1]) & 0xFFFFFFFF
    return int(base[0]), int(base[1])


def _check(out: torch.Tensor, keys: torch.Tensor, skip: torch.Tensor,
           base) -> None:
    n = out.shape[0] if out.dim() == 2 else -1
    if keys.dim() not in (1, 2) or (keys.dim() == 2 and keys.shape[1] != 2):
        raise ValueError(f"keys must be [n] or [n, 2], got "
                         f"{tuple(keys.shape)}")
    if keys.dtype != torch.int32:
        raise TypeError(f"init_rows takes int32 keys (pairs for wide "
                        f"tables), got {keys.dtype}")
    if keys.shape[0] != n or tuple(skip.shape) != (n,) \
            or skip.dtype != torch.bool:
        raise ValueError(
            f"out [n, dim], keys [n(, 2)] and a bool skip [n] expected, got "
            f"{tuple(out.shape)}, {tuple(keys.shape)}, {tuple(skip.shape)} "
            f"{skip.dtype}")
    if isinstance(base, torch.Tensor):
        if tuple(base.shape) != (2,) or base.dtype != torch.int32:
            raise ValueError(f"a base key tensor must be [2] int32 (the "
                             f"uint32 words), got {tuple(base.shape)} "
                             f"{base.dtype}")
    elif len(base) != 2 or not all(0 <= int(w) < 2**32 for w in base):
        raise ValueError(f"base key must be two uint32 words, got {base}")
    devices = {out.device, keys.device, skip.device} | (
        {base.device} if isinstance(base, torch.Tensor) else set())
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def init_rows_reference(out: torch.Tensor, keys: torch.Tensor,
                        skip: torch.Tensor, base: Sequence[int],
                        kind: int, params: Tuple[float, ...]
                        ) -> torch.Tensor:
    """Plain PyTorch version of the per-key kernel, on any device."""
    _check(out, keys, skip, base)
    words = key_words(base_words(base), keys)
    fresh = keyed_rows(kind, params, words, out.shape[1], out.dtype)
    out.copy_(torch.where(skip[:, None], out, fresh))
    return out


def init_flat_reference(out: torch.Tensor, key, offset: int, kind: int,
                        params: Tuple[float, ...]) -> torch.Tensor:
    """Plain PyTorch version of the flat kernel, on any device: ``out``
    (contiguous, any shape) takes elements ``offset ..`` of the flat draw
    under ``key``, drawn in chunks (``flat_rows``)."""
    out.view(-1).copy_(flat_rows(kind, params, threefry_key(key),
                                 int(offset), out.numel(), out.dtype,
                                 out.device))
    return out


def _entry(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("init_rows"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


_DRAW_ARGS = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int] \
    + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
_ROWS_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_uint32,
                                      ctypes.c_uint32, ctypes.c_void_p] \
    + _DRAW_ARGS[2:]
_FLAT_ARGS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64] + _DRAW_ARGS


def _launch(fn, device: torch.device, args) -> None:
    """Call a C entry on the current stream of ``device``; raise if the
    launch failed."""
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"init_rows kernel launch failed: CUDA error "
                           f"{rc}")


def _cuda_out(out: torch.Tensor, what: str) -> None:
    if out.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {out.device}")
    if out.dtype not in _WORD_BYTES:
        raise TypeError(f"{what} kernel writes float32 or bfloat16 values, "
                        f"not {out.dtype}")
    if not out.is_contiguous():
        raise ValueError(f"{what} kernel needs contiguous tensors")


def init_rows(out: torch.Tensor, keys: torch.Tensor, skip: torch.Tensor,
              base: Sequence[int], initializer: Initializer
              ) -> torch.Tensor:
    """Write ``initializer``'s row for ``keys[i]`` into ``out[i]`` wherever
    ``skip[i]`` is False, in place; returns ``out``.

    ``out`` is ``[n, dim]`` float32 or bfloat16 (any float dtype on the
    CPU); ``keys`` ``[n]`` int32 or ``[n, 2]`` int32 (lo, hi) pairs;
    ``skip`` ``[n]`` bool; ``base`` the table's two threefry key words
    (``HashTableState.init_rng``): two ints, or a ``[2]`` int32 tensor of
    their bits on ``out``'s device, which the kernel reads at each launch
    (a captured graph then follows a key rewritten in place). On CUDA all
    tensors must be contiguous
    and ``n * dim < 2^31``; the kernel launches on the current stream and
    ``init_rows.launches`` counts each launch.
    """
    _check(out, keys, skip, base)
    kind, params = keyed_params(initializer)
    if out.device.type == "cpu":
        return init_rows_reference(out, keys, skip, base, kind, params)
    _cuda_out(out, "init_rows")
    if not (keys.is_contiguous() and skip.is_contiguous()):
        raise ValueError("init_rows kernel needs contiguous tensors")
    n, dim = out.shape
    if n * dim >= _INDEX_LIMIT:
        raise ValueError(f"init_rows kernel indexes in 32 bits: n * dim = "
                         f"{n * dim} must stay below 2^31")
    if n == 0 or dim == 0:
        return out          # a grid of zero blocks is a launch error
    if isinstance(base, torch.Tensor):
        words, key_ptr = (0, 0), base.data_ptr()
    else:
        words, key_ptr = (int(base[0]), int(base[1])), None
    fn = _fns.get("oe_init_rows") or _entry("oe_init_rows", _ROWS_ARGS)
    _launch(fn, out.device, (
        keys.data_ptr(), skip.data_ptr(), out.data_ptr(), n, dim,
        int(keys.dim() == 2), words[0], words[1], key_ptr, kind, *params,
        _WORD_BYTES[out.dtype]))
    launches.count(init_rows)
    return out


def init_flat(out: torch.Tensor, key, offset: int,
              initializer: Initializer) -> torch.Tensor:
    """Fill ``out`` (contiguous, any shape) in place with elements
    ``offset .. offset + out.numel() - 1`` of ``initializer``'s flat draw
    under the threefry ``key``: with ``offset = 0``, JAX's
    ``initializer.init(key, out.shape, dtype)``. Returns ``out``.

    ``out`` is float32 or bfloat16 on CUDA (any float dtype on the CPU);
    bfloat16 values are drawn in float32 and rounded to nearest even. On
    CUDA one launch fills up to ``FLAT_LAUNCH`` elements on the current
    stream; ``init_flat.launches`` counts each launch.
    """
    k0, k1 = threefry_key(key)
    offset = int(offset)
    if offset < 0 or offset + out.numel() > 2**64:
        raise ValueError(f"flat counter range from {offset} outside "
                         "[0, 2^64)")
    kind, params = keyed_params(initializer)
    if out.device.type == "cpu":
        return init_flat_reference(out, (k0, k1), offset, kind, params)
    _cuda_out(out, "init_flat")
    fn = _fns.get("oe_init_flat") or _entry("oe_init_flat", _FLAT_ARGS)
    flat, step = out.view(-1), out.element_size()
    for lo in range(0, flat.numel(), FLAT_LAUNCH):
        count = min(FLAT_LAUNCH, flat.numel() - lo)
        _launch(fn, out.device, (
            flat.data_ptr() + lo * step, count, offset + lo, k0, k1, kind,
            *params, _WORD_BYTES[out.dtype]))
        launches.count(init_flat)
    return out


init_rows.launches = 0
init_flat.launches = 0
