"""Find-or-insert of a hash table's keys (K3): the wrapper of
``csrc/find_or_insert.cu``.

No TPU kernel stands behind it: the JAX package's ``find_or_insert``
(``openembedding_tpu/hash_table.py``) is XLA code, and the plain version
here, ``hash_table.find_or_insert_reference``, is the same algorithm step
for step in PyTorch operations. For each valid (unique) key: its slot,
found or newly taken, in place in ``table_keys``; the kernels place every
key in the slot the plain version gives it. They first resolve every key
by scanning its window as K2 does (``ops/probe_gather.py``, whose
precondition they share: no stored key lies after an EMPTY slot of its
own window), then run the ranked insert of each chain level over the keys
that missed alone; with no misses those launches exit at once.

Dispatch is by the device the tensors lie on, nothing else: CPU tensors
take the plain version; CUDA tensors launch the kernels or raise. There
is no fallback from one to the other. A call launches ``3 + chain``
kernels and one memset on the current stream, with no device-to-host
read and static shapes, so it can be captured; ``find_or_insert.launches``
counts the kernels (``ops/launches.py``). Scratch comes from PyTorch's
allocator: 4 bytes a bucket and 24 bytes an entry.

:func:`key_counts` reads how many keys the kernels found, inserted and
failed to place (never on the step path); ``/metrics``
shows them as ``oe_hash_find_keys_total{outcome=...}``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from . import launches

OUTCOMES = ("found", "inserted", "failed")
_KEY_DTYPES = (torch.int32, torch.int64)
_fns: Dict[str, Callable] = {}     # the C entries, once loaded
_ran_on = set()                    # device indices K3 launched on


def _entry(name: str, argtypes, restype):
    fn = _fns.get(name)
    if fn is None:
        from . import _build
        fn = getattr(_build.load("find_or_insert"), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _fns[name] = fn
    return fn


def _check(table_keys: torch.Tensor, new_keys: torch.Tensor,
           valid: torch.Tensor) -> bool:
    """Validate shapes, dtypes and devices; returns whether keys are
    wide (``[C, 2]`` int32 pairs)."""
    wide = table_keys.dim() == 2
    if table_keys.dim() not in (1, 2) or (wide and table_keys.shape[1] != 2):
        raise ValueError(f"table keys must be [C] or [C, 2], got "
                         f"{tuple(table_keys.shape)}")
    if new_keys.dim() != table_keys.dim() or (wide
                                              and new_keys.shape[1] != 2):
        raise ValueError(
            f"key-shape mismatch: table keys {tuple(table_keys.shape)} vs "
            f"new keys {tuple(new_keys.shape)}")
    if table_keys.dtype != new_keys.dtype or table_keys.dtype not in \
            _KEY_DTYPES or (wide and table_keys.dtype != torch.int32):
        raise TypeError(f"find_or_insert takes int32 keys (pairs for wide "
                        f"tables) or int64 keys of one dtype, got "
                        f"{table_keys.dtype} and {new_keys.dtype}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (
            new_keys.shape[0],):
        raise ValueError(f"valid must be [{new_keys.shape[0]}] bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    devices = {table_keys.device, new_keys.device, valid.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    return wide


def find_or_insert(table_keys: torch.Tensor, new_keys: torch.Tensor,
                   valid: torch.Tensor, max_probes: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Find each valid key's slot, inserting missing keys into
    ``table_keys`` IN PLACE; returns ``(table_keys, slot [n] int64 (-1:
    not valid or failed), inserted [n] bool, failed [n] bool)``, as
    ``hash_table.find_or_insert_reference``.

    ``table_keys`` is ``[C]`` int32, ``[C]`` int64 or ``[C, 2]`` int32
    pairs, ``new_keys`` ``[n]`` or ``[n, 2]`` of the same dtype, ``valid``
    ``[n]`` bool; the valid keys are distinct. The geometry is
    ``hash_table.table_layout(C, max_probes)``. On CUDA ``table_keys`` must
    be contiguous, 8-byte keys 8-byte aligned, and the table must meet
    the probe precondition (module note), as every table ``find_or_insert``
    and ``insert_rows`` fill does.
    """
    from .. import hash_table
    wide = _check(table_keys, new_keys, valid)
    device = table_keys.device
    if device.type == "cpu":
        return hash_table.find_or_insert_reference(table_keys, new_keys,
                                                   valid, max_probes)
    if device.type != "cuda":
        raise ValueError(f"find_or_insert runs on cpu or cuda, not {device}")
    if not table_keys.is_contiguous():
        raise ValueError("find_or_insert kernel writes a contiguous keys "
                         "tensor")
    mode = 1 if wide else (2 if table_keys.dtype == torch.int64 else 0)
    if mode and table_keys.data_ptr() % 8:
        raise ValueError("find_or_insert kernel reads pair and int64 keys "
                         "as 8-byte words: the keys tensor must be 8-byte "
                         "aligned")
    capacity = table_keys.shape[0]
    bucket, buckets, chain = hash_table.table_layout(capacity, max_probes)
    n = new_keys.shape[0]
    slot = torch.empty(n, dtype=torch.int64, device=device)
    inserted = torch.empty(n, dtype=torch.bool, device=device)
    failed = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return table_keys, slot, inserted, failed
    if n >= 2**31:
        raise ValueError(f"find_or_insert kernel indexes entries in 32 bits, "
                         f"got {n}")
    new_keys, valid = new_keys.contiguous(), valid.contiguous()
    words = _entry("oe_find_or_insert_scratch",
                   [ctypes.c_int64, ctypes.c_int64], ctypes.c_int64)(
                       n, buckets)
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    fn = _fns.get("oe_find_or_insert") or _entry(
        "oe_find_or_insert",
        [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int)
    empty = hash_table.empty_key(table_keys.dtype) if mode < 2 else 0
    args = (table_keys.data_ptr(), new_keys.data_ptr(), valid.data_ptr(),
            slot.data_ptr(), inserted.data_ptr(), failed.data_ptr(),
            scratch.data_ptr(), n, capacity, bucket, chain, empty, mode)
    raw_stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, raw_stream(device.index))
    else:
        with torch.cuda.device(device):
            rc = fn(*args, raw_stream(device.index))
    if rc != 0:
        raise RuntimeError(f"find_or_insert kernel launch failed: CUDA "
                           f"error {rc}")
    _ran_on.add(device.index)
    launches.count(find_or_insert, 3 + chain)
    return table_keys, slot, inserted, failed


find_or_insert.launches = 0


def key_counts() -> Dict[str, int]:
    """Keys the kernels found, inserted and failed to place
    (:data:`OUTCOMES`), summed over the devices they ran on since the
    process started; replays of a captured step count each time. The
    plain version counts nothing: zeros where no kernel ran. Reads each
    device's counters on its current stream and waits for it, so never
    call it while that stream captures.
    """
    out = dict.fromkeys(OUTCOMES, 0)
    if not _ran_on:
        return out
    fn = _entry("oe_find_or_insert_counts",
                [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int)
    got = (ctypes.c_int64 * 3)()
    for index in sorted(_ran_on):
        with torch.cuda.device(index):
            rc = fn(got, torch._C._cuda_getCurrentRawStream(index))
        if rc != 0:
            raise RuntimeError(f"find_or_insert counters: CUDA error {rc}")
        for k, name in enumerate(OUTCOMES):
            out[name] += int(got[k])
    return out
