"""Hand table state between the JAX package and the port as numpy arrays.

The JAX package's ``TableState`` and ``HashTableState`` arrays, turned
into numpy (``np.asarray(jax_array)``), become the port's ``TableState``
and ``HashTableState`` on a device, and back; tests use this so that both
packages compute on the same weights (and, for hash tables, the same key
placement). bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes, or
numpy's opaque ``V2``) cross as their raw 16-bit words: the port never
imports ml_dtypes, and ``table_state_to_numpy`` returns bfloat16 fields as
``uint16`` words (compare with ``jax_array_as_numpy.view(np.uint16)``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .hash_table import HashTableState
from .table import TableState
from .utils.device import DeviceLike, resolve_device


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                           and arr.dtype.itemsize == 2)


def tensor_from_numpy(arr: np.ndarray, device: DeviceLike = None
                      ) -> torch.Tensor:
    device = resolve_device(device)
    arr = np.ascontiguousarray(arr)
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def table_state_from_numpy(weights: np.ndarray,
                           slots: Dict[str, np.ndarray],
                           device: DeviceLike = None) -> TableState:
    return TableState(
        weights=tensor_from_numpy(weights, device),
        slots={k: tensor_from_numpy(v, device) for k, v in slots.items()})


def table_state_to_numpy(state: TableState
                         ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    return (tensor_to_numpy(state.weights),
            {k: tensor_to_numpy(v) for k, v in state.slots.items()})


def hash_state_from_numpy(keys: np.ndarray, weights: np.ndarray,
                          slots: Dict[str, np.ndarray],
                          device: DeviceLike = None) -> HashTableState:
    """A hash table from its keys (``[C]`` or ``[C, 2]`` int32), weights
    and slots, slot for slot (no insert failures counted)."""
    device = resolve_device(device)
    return HashTableState(
        keys=tensor_from_numpy(np.asarray(keys, np.int32), device),
        weights=tensor_from_numpy(weights, device),
        slots={k: tensor_from_numpy(v, device) for k, v in slots.items()},
        insert_failures=torch.zeros((), dtype=torch.int64, device=device))


def hash_state_to_numpy(state: HashTableState
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Dict[str, np.ndarray]]:
    """``(keys, weights, slots)`` of a hash table, slot for slot."""
    weights, slots = table_state_to_numpy(state)
    return tensor_to_numpy(state.keys), weights, slots
