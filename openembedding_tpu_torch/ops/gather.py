"""Sparse row gather (embedding pull): the wrapper of ``csrc/gather_rows.cu``.

Counterpart of ``openembedding_tpu/ops/pallas_gather.py``; the CUDA kernel
replaces the TPU kernel ``_gather_kernel`` there. Same contract:
``rows[i] = table[indices[i]]``, a zero row where ``indices[i] < 0`` or
``>= V``, output ``[n, D]`` in the table dtype. Unlike the TPU kernel it
takes any row width directly (no 128-lane ``pad_table``).

Dispatch is by the device the tensors lie on, nothing else: CPU tensors
take the plain version :func:`gather_rows_reference`; CUDA tensors launch
the kernel or raise. There is no fallback from one to the other. The C
entry is resolved once per process (the first call builds it), and a call
enters a ``torch.cuda.device`` context only when the tensors lie on
another device than the current one. The stream handle comes from the raw
current-stream query PyTorch's own kernel launchers use, not from a
``torch.cuda.Stream`` object built per call.
"""

from __future__ import annotations

import ctypes

import torch

from . import launches

_WORD_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_INDEX_BYTES = {torch.int32: 4, torch.int64: 8}
_fn = None              # the C entry, once built and loaded


def gather_rows_reference(table: torch.Tensor,
                          indices: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    vocab, dim = table.shape
    ids = indices.to(torch.int64)
    valid = (ids >= 0) & (ids < vocab)
    if vocab == 0:
        return torch.zeros((ids.shape[0], dim), dtype=table.dtype,
                           device=table.device)
    rows = table.index_select(0, torch.where(valid, ids, 0))
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


def _entry():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("gather_rows").oe_gather_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``rows[i] = table[indices[i]]`` with zero rows for invalid ids.

    ``table`` is ``[V, D]`` float32 or bfloat16, ``indices`` is ``[n]``
    int32 or int64 on the same device. On CUDA both must be contiguous;
    the kernel launches on the current stream and ``gather_rows.launches``
    counts each launch.
    """
    if table.dim() != 2 or indices.dim() != 1:
        raise ValueError(
            f"gather_rows takes a [V, D] table and [n] indices, got "
            f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if table.device != indices.device:
        raise ValueError(f"table on {table.device}, indices on "
                         f"{indices.device}")
    if table.device.type == "cpu":
        return gather_rows_reference(table, indices)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not "
                         f"{table.device}")
    if table.dtype not in _WORD_BYTES:
        raise TypeError(f"gather_rows kernel takes float32 or bfloat16 "
                        f"tables, not {table.dtype}")
    if indices.dtype not in _INDEX_BYTES:
        raise TypeError(f"gather_rows kernel takes int32 or int64 ids, "
                        f"not {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("gather_rows kernel needs contiguous tensors")
    vocab, dim = table.shape
    n = indices.shape[0]
    device = table.device
    out = torch.empty((n, dim), dtype=table.dtype, device=device)
    if n == 0 or dim == 0:
        return out          # a grid of zero blocks is a launch error
    args = (table.data_ptr(), indices.data_ptr(), out.data_ptr(), n, vocab,
            dim, _WORD_BYTES[table.dtype], _INDEX_BYTES[indices.dtype])
    fn = _fn or _entry()
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{rc}")
    launches.count(gather_rows)
    return out


gather_rows.launches = 0
