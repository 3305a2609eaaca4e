"""Fused hash probe + row gather (hash-table pull): the wrapper of
``csrc/probe_gather.cu``.

Counterpart of ``openembedding_tpu/ops/pallas_hash.py``; the CUDA kernel
replaces the TPU kernel ``_probe_gather_kernel`` there. Same function: for
each query key, compare the ``chain * bucket`` keys of its bucket-aligned
probe window, take the first matching slot and copy that weight row; a
miss or an EMPTY query gives a zero row and ``hit = False``. Unlike the
TPU kernel it takes wide ``[n, 2]`` pair keys as well as int32 keys, any
row width, and computes each query's window start itself (the TPU kernel
is handed ``starts``): the same mixing as ``hash_table.probe_starts``.

The kernel ends a query's scan at the first slot, in slot order, that
holds its key or EMPTY. That is the full-window answer on every table the
port or the JAX package builds: slots are never freed and
``find_or_insert`` gives a key the first free slot of the first bucket of
its window that has one, so no stored key lies after an EMPTY slot of its
own window. The plain version compares the whole window.

Dispatch is by the device the tensors lie on, nothing else: CPU tensors
take the plain version :func:`probe_gather_reference`; CUDA tensors launch
the kernel or raise. There is no fallback from one to the other. The C
entry is resolved once per process (the first call builds it), and a call
enters a ``torch.cuda.device`` context only when the tensors lie on
another device than the current one. The stream handle comes from the raw
current-stream query PyTorch's own kernel launchers use, not from a
``torch.cuda.Stream`` object built per call.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import launches

_WORD_BYTES = {torch.float32: 4, torch.bfloat16: 2}
_fn = None              # the C entry, once built and loaded


def _check(table_keys: torch.Tensor, weights: torch.Tensor,
           query: torch.Tensor, chain: int, bucket: int) -> bool:
    """Validate shapes and geometry; returns whether keys are wide."""
    wide = table_keys.dim() == 2
    if table_keys.dim() not in (1, 2) or (wide and table_keys.shape[1] != 2):
        raise ValueError(f"table keys must be [C] or [C, 2], got "
                         f"{tuple(table_keys.shape)}")
    if query.dim() != table_keys.dim() or (wide and query.shape[1] != 2):
        raise ValueError(
            f"key-shape mismatch: table keys {tuple(table_keys.shape)} vs "
            f"query {tuple(query.shape)}")
    if table_keys.dtype != torch.int32 or query.dtype != torch.int32:
        raise TypeError(f"probe_gather takes int32 keys (pairs for wide "
                        f"tables), got {table_keys.dtype} and {query.dtype}")
    capacity = table_keys.shape[0]
    if weights.dim() != 2 or weights.shape[0] != capacity:
        raise ValueError(f"weights must be [{capacity}, D], got "
                         f"{tuple(weights.shape)}")
    if bucket < 1 or chain < 1 or capacity % bucket \
            or chain * bucket > capacity:
        raise ValueError(f"bad probe geometry: capacity {capacity}, "
                         f"bucket {bucket}, chain {chain}")
    devices = {table_keys.device, weights.device, query.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return wide


def probe_gather_reference(table_keys: torch.Tensor, weights: torch.Tensor,
                           query: torch.Tensor, *, chain: int, bucket: int,
                           empty: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: the window
    gather, the first match, and the take with zeroing."""
    from ..hash_table import window_starts
    wide = _check(table_keys, weights, query, chain, bucket)
    nb = table_keys.shape[0] // bucket
    start = window_starts(query, nb, chain, bucket)
    window = start[:, None] + torch.arange(chain * bucket,
                                           device=start.device)
    cand = table_keys[window]                       # [n, W] or [n, W, 2]
    if wide:
        match = (cand[..., 0] == query[:, None, 0]) \
            & (cand[..., 1] == query[:, None, 1])
        valid = query[:, 1] != empty
    else:
        match = cand == query[:, None]
        valid = query != empty
    hit = match.any(dim=1) & valid
    first = torch.argmax(match.to(torch.uint8), dim=1)
    slot = torch.where(hit, start + first, 0)
    rows = weights.index_select(0, slot)
    rows = torch.where(hit[:, None], rows, torch.zeros_like(rows))
    return rows, hit


def _entry():
    global _fn
    if _fn is None:
        from . import _build
        fn = _build.load("probe_gather").oe_probe_gather
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def probe_gather(table_keys: torch.Tensor, weights: torch.Tensor,
                 query: torch.Tensor, *, chain: int, bucket: int,
                 empty: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused lookup: ``rows[i] = weights[slot(query[i])]``, zeros on a miss
    or an EMPTY query; returns ``(rows [n, D], hit [n] bool)``.

    ``table_keys`` is ``[C]`` int32 with ``[n]`` int32 queries, or ``[C, 2]``
    int32 pairs with ``[n, 2]`` pair queries; ``weights`` is ``[C, D]``
    float32 or bfloat16. ``bucket`` divides ``C`` and ``chain * bucket``
    slots from each query's start are compared (``hash_table.table_layout``).
    On CUDA all tensors must be contiguous, pair keys 8-byte aligned; the
    kernel launches on the current stream and ``probe_gather.launches``
    counts each launch. Precondition of the kernel: no stored key lies
    after an EMPTY slot of its own window (true of every table
    ``find_or_insert`` and ``insert_rows`` fill; see the module note).
    """
    wide = _check(table_keys, weights, query, chain, bucket)
    device = table_keys.device
    if device.type == "cpu":
        return probe_gather_reference(table_keys, weights, query,
                                      chain=chain, bucket=bucket,
                                      empty=empty)
    if device.type != "cuda":
        raise ValueError(f"probe_gather runs on cpu or cuda, not {device}")
    if weights.dtype not in _WORD_BYTES:
        raise TypeError(f"probe_gather kernel takes float32 or bfloat16 "
                        f"weights, not {weights.dtype}")
    if not (table_keys.is_contiguous() and weights.is_contiguous()
            and query.is_contiguous()):
        raise ValueError("probe_gather kernel needs contiguous tensors")
    if wide and table_keys.data_ptr() % 8:
        raise ValueError("probe_gather kernel reads pair keys as 8-byte "
                         "words: the keys tensor must be 8-byte aligned")
    capacity, dim = weights.shape
    n = query.shape[0]
    rows = torch.empty((n, dim), dtype=weights.dtype, device=device)
    hit = torch.empty((n,), dtype=torch.bool, device=device)
    if n == 0:
        return rows, hit    # a grid of zero blocks is a launch error
    args = (table_keys.data_ptr(), weights.data_ptr(), query.data_ptr(),
            rows.data_ptr(), hit.data_ptr(), n, capacity, dim, bucket, chain,
            int(empty), int(wide), _WORD_BYTES[weights.dtype])
    fn = _fn or _entry()
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"probe_gather kernel launch failed: CUDA error "
                           f"{rc}")
    launches.count(probe_gather)
    return rows, hit


probe_gather.launches = 0
