"""Per-key init rows of a hash table: the wrapper of ``csrc/init_rows.cu``
(KI).

No TPU kernel stands behind it: the JAX package draws these rows in XLA
(``openembedding_tpu/hash_table.py`` ``init_rows``, a ``jax.vmap`` of the
initializer over ``jax.random.fold_in`` keys). In the port a missing key
would cost its 2 + dim threefry blocks as several hundred PyTorch
operations a call, so the draw is one kernel: for each row whose ``skip``
flag is clear, the key's threefry key and its row's draws, written in
place. The pull passes the probe kernel's rows with ``skip = hit | EMPTY
key``; the push passes the gathered rows with ``skip = ~inserted``.

Dispatch is by the device the tensors lie on, nothing else: CPU tensors
take the plain version :func:`init_rows_reference` (the keyed draws of
``optim/initializers.py``); CUDA tensors launch the kernel or raise.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..optim.initializers import (Initializer, key_words, keyed_params,
                                  keyed_rows)

_WORD_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_fn = None              # the C entry, once built and loaded


def _check(out: torch.Tensor, keys: torch.Tensor, skip: torch.Tensor,
           base: Sequence[int]) -> None:
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
    if len(base) != 2 or not all(0 <= int(w) < 2**32 for w in base):
        raise ValueError(f"base key must be two uint32 words, got {base}")
    devices = {out.device, keys.device, skip.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def init_rows_reference(out: torch.Tensor, keys: torch.Tensor,
                        skip: torch.Tensor, base: Sequence[int],
                        kind: int, params: Tuple[float, ...]
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    _check(out, keys, skip, base)
    words = key_words((int(base[0]), int(base[1])), keys)
    fresh = keyed_rows(kind, params, words, out.shape[1], out.dtype)
    out.copy_(torch.where(skip[:, None], out, fresh))
    return out


def _entry():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("init_rows").oe_init_rows
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int]
                       + [ctypes.c_float] * 6
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def init_rows(out: torch.Tensor, keys: torch.Tensor, skip: torch.Tensor,
              base: Sequence[int], initializer: Initializer
              ) -> torch.Tensor:
    """Write ``initializer``'s row for ``keys[i]`` into ``out[i]`` wherever
    ``skip[i]`` is False, in place; returns ``out``.

    ``out`` is ``[n, dim]`` float32 or bfloat16 (any float dtype on the
    CPU); ``keys`` ``[n]`` int32 or ``[n, 2]`` int32 (lo, hi) pairs;
    ``skip`` ``[n]`` bool; ``base`` the table's two threefry key words
    (``HashTableState.init_rng``). On CUDA all tensors must be contiguous;
    the kernel launches on the current stream and ``init_rows.launches``
    counts each launch.
    """
    _check(out, keys, skip, base)
    kind, params = keyed_params(initializer)
    device = out.device
    if device.type == "cpu":
        return init_rows_reference(out, keys, skip, base, kind, params)
    if device.type != "cuda":
        raise ValueError(f"init_rows runs on cpu or cuda, not {device}")
    if out.dtype not in _WORD_BYTES:
        raise TypeError(f"init_rows kernel writes float32 or bfloat16 "
                        f"rows, not {out.dtype}")
    if not (out.is_contiguous() and keys.is_contiguous()
            and skip.is_contiguous()):
        raise ValueError("init_rows kernel needs contiguous tensors")
    n, dim = out.shape
    if n == 0 or dim == 0:
        return out          # a grid of zero blocks is a launch error
    args = (keys.data_ptr(), skip.data_ptr(), out.data_ptr(), n, dim,
            int(keys.dim() == 2), int(base[0]), int(base[1]), kind,
            *params, _WORD_BYTES[out.dtype])
    fn = _fn or _entry()
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"init_rows kernel launch failed: CUDA error "
                           f"{rc}")
    init_rows.launches += 1
    return out


init_rows.launches = 0
