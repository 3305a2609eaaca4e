"""Hand table state between the JAX package and the port as numpy arrays.

The JAX package's ``TableState`` and ``HashTableState`` arrays, turned
into numpy (``np.asarray(jax_array)``), become the port's ``TableState``
and ``HashTableState`` on a device, and back; tests use this so that both
packages compute on the same weights (and, for hash tables, the same key
placement). A sharded state crosses as JAX's global physical arrays (a
table's ``[S * rows_per_shard, dim]`` after ``device_get``, a hash
table's ``[S * capacity_per_shard(, 2)]`` keys and their rows), which are
the port's stacked shards (``parallel/sharded_table.py``,
``parallel/sharded_hash.py``). A plane's derived state crosses too: an
int8_ef residual (JAX's ``precision.EFState``: its global ``keys`` and
``resid`` arrays, each sender's block in mesh order) and a hot-row
replica (``hot_cache.CachedState``: the replica's keys, rows and slots),
beside their table. bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes, or
numpy's opaque ``V2``) cross as their raw 16-bit words: the port never
imports ml_dtypes, and ``table_state_to_numpy`` returns bfloat16 fields as
``uint16`` words (compare with ``jax_array_as_numpy.view(np.uint16)``).

Dense state crosses too: flax parameter trees (nested dicts of arrays,
a ``HybridModel``'s ``{"inner": ..., "sparse_as_dense": ...}`` among
them) become the port's parameter dicts keyed by module name and back, a
flax ``Dense`` ``kernel`` ``[in, out]`` as the torch ``weight`` ``[out,
in]``; optax's Adagrad state (``ScaleByRssState.sum_of_squares``, the
same tree) and Adam state (``ScaleByAdamState``: ``count``, ``mu``,
``nu``) become ``optim/dense.py``'s state and back.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from .hash_table import HashTableState, threefry_key
from .ops.init_rows import base_words
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
    """A numpy copy of ``t`` (bfloat16 as uint16 words): memory of its
    own, so a CPU tensor updated in place later leaves it unchanged."""
    t = t.detach().to("cpu", copy=True).contiguous()
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
                          device: DeviceLike = None,
                          init_rng: Optional[np.ndarray] = None,
                          insert_failures: int = 0) -> HashTableState:
    """A hash table from its keys (``[C]`` int32 or int64, or ``[C, 2]``
    int32), weights and slots, slot for slot. ``init_rng``: the two
    uint32 words of its init key (``np.asarray(jax_state.init_rng)``;
    default ``PRNGKey(0)``'s)."""
    device = resolve_device(device)
    keys = np.asarray(keys)
    keys = keys.astype(np.int64 if keys.dtype == np.int64 else np.int32)
    return HashTableState(
        keys=tensor_from_numpy(keys, device),
        weights=tensor_from_numpy(weights, device),
        slots={k: tensor_from_numpy(v, device) for k, v in slots.items()},
        init_rng=threefry_key(init_rng),
        insert_failures=torch.full((), int(insert_failures),
                                   dtype=torch.int64, device=device))


def hash_state_to_numpy(state: HashTableState
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Dict[str, np.ndarray], np.ndarray]:
    """``(keys, weights, slots, init_rng)`` of a hash table, slot for slot;
    ``init_rng`` as ``[2]`` uint32, the form of a JAX key (read back when
    the table holds it on the device, as an offload cache does)."""
    weights, slots = table_state_to_numpy(state)
    return (tensor_to_numpy(state.keys), weights, slots,
            np.asarray(base_words(state.init_rng), np.uint32))


def sharded_table_state_from_numpy(weights: np.ndarray,
                                   slots: Dict[str, np.ndarray],
                                   num_shards: int,
                                   device: DeviceLike = None):
    """A sharded array table from JAX's global physical arrays
    (``[S * rows_per_shard, dim]`` weights and slots, shard-major)."""
    from .parallel.sharded_table import ShardedTableState
    one = table_state_from_numpy(weights, slots, device)
    return ShardedTableState(weights=one.weights, slots=one.slots,
                             num_shards=int(num_shards))


def sharded_hash_state_from_numpy(keys: np.ndarray, weights: np.ndarray,
                                  slots: Dict[str, np.ndarray],
                                  num_shards: int,
                                  device: DeviceLike = None,
                                  init_rng: Optional[np.ndarray] = None,
                                  insert_failures: Any = 0):
    """A sharded hash table from JAX's global physical arrays (keys
    ``[S * capacity_per_shard(, 2)]``, rows and slots likewise) and init
    key. ``insert_failures``: per shard (``[S]``), or JAX's replicated
    total, which lands on shard 0."""
    from .parallel.sharded_hash import ShardedHashState
    one = hash_state_from_numpy(keys, weights, slots, device, init_rng)
    fails = np.zeros(int(num_shards), np.int64)
    counts = np.asarray(insert_failures, np.int64)
    if counts.ndim:
        fails[:] = counts
    else:
        fails[0] = counts
    return ShardedHashState(
        keys=one.keys, weights=one.weights, slots=one.slots,
        init_rng=one.init_rng,
        shard_failures=torch.from_numpy(fails).to(one.keys.device),
        num_shards=int(num_shards))


def ef_state_from_numpy(table_state, keys: np.ndarray, resid: np.ndarray,
                        device: DeviceLike = None):
    """An ``EFState`` of the port around ``table_state`` from JAX's
    residual arrays (``np.asarray(ef.keys)``, ``np.asarray(ef.resid)``)."""
    from .parallel.precision import EFState
    keys = np.asarray(keys)
    keys = keys.astype(np.int64 if keys.dtype == np.int64 else np.int32)
    return EFState(table=table_state,
                   keys=tensor_from_numpy(keys, device),
                   resid=tensor_from_numpy(
                       np.asarray(resid, np.float32), device))


def ef_state_to_numpy(state) -> Tuple[np.ndarray, np.ndarray]:
    """``(keys, resid)`` of an ``EFState``, JAX's global arrays."""
    return tensor_to_numpy(state.keys), tensor_to_numpy(state.resid)


def cached_state_from_numpy(table_state, keys: np.ndarray,
                            rows: np.ndarray, slots: Dict[str, np.ndarray],
                            device: DeviceLike = None):
    """A ``CachedState`` of the port around ``table_state`` from JAX's
    replica (``cache.keys``, ``cache.rows``, ``cache.slots``)."""
    from .parallel.hot_cache import CachedState, HotCacheState
    keys = np.asarray(keys)
    keys = keys.astype(np.int64 if keys.dtype == np.int64 else np.int32)
    return CachedState(
        table=table_state,
        cache=HotCacheState(
            keys=tensor_from_numpy(keys, device),
            rows=tensor_from_numpy(rows, device),
            slots={k: tensor_from_numpy(v, device)
                   for k, v in slots.items()}))


def cache_state_to_numpy(state) -> Tuple[np.ndarray, np.ndarray,
                                         Dict[str, np.ndarray]]:
    """``(keys, rows, slots)`` of a ``CachedState``'s replica."""
    c = state.cache
    return (tensor_to_numpy(c.keys), tensor_to_numpy(c.rows),
            {k: tensor_to_numpy(v) for k, v in c.slots.items()})


def _flax_leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def dense_params_from_flax(module: torch.nn.Module, params: Mapping,
                           device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """A flax parameter tree as ``{module parameter name: tensor}`` on
    ``device``; the tree must hold exactly ``module``'s parameters, at
    their shapes, but for dense-kept tables, which flax creates only for
    the columns its init batch held."""
    from .hybrid import DenseEmbeddings
    want = {k: tuple(v.shape) for k, v in module.named_parameters()}
    lazy = {f"{scope}.{s.name}" for scope, m in module.named_modules()
            if isinstance(m, DenseEmbeddings) for s in m.specs}
    out = {}
    for path, leaf in _flax_leaves(params):
        arr = np.asarray(leaf)
        if path[-1] == "kernel":
            path, arr = path[:-1] + ("weight",), arr.T
        name = ".".join(path)
        if want.get(name) != arr.shape:
            raise ValueError(f"flax parameter {name} {arr.shape} does not "
                             f"match the module's {want.get(name)}")
        out[name] = tensor_from_numpy(arr, device)
    missing = set(want) - set(out) - lazy
    if missing:
        raise ValueError(f"module parameters {sorted(missing)} are not in "
                         "the flax tree")
    return out


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax path of the port's parameter ``name``: the module names,
    then the leaf, a torch ``weight`` as flax's ``kernel``
    (``"MLP_0.Dense_1.weight"`` -> ``("MLP_0", "Dense_1", "kernel")``), for
    ``DeepFM``, ``WideDeep`` and ``LogisticRegression``, whose modules keep
    flax's auto-names."""
    path = tuple(name.split("."))
    return path[:-1] + ("kernel",) if path[-1] == "weight" else path


def dense_params_to_flax(params: Mapping[str, torch.Tensor]) -> Dict:
    """The port's parameter dict as a flax tree of numpy arrays."""
    tree: Dict = {}
    for name, t in params.items():
        path = flax_path(name)
        arr = tensor_to_numpy(t)
        if path[-1] == "kernel":
            arr = np.ascontiguousarray(arr.T)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def dense_state_from_optax(module: torch.nn.Module, opt_state,
                           device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """``optim/dense.py``'s state from an optax state: Adagrad's
    ``sum_of_squares`` tree, Adam's ``count``, ``mu`` and ``nu`` (as
    ``count``, ``mu/<name>`` and ``nu/<name>``), or nothing for a
    stateless transform (SGD)."""
    for part in opt_state:
        if hasattr(part, "sum_of_squares"):
            return dense_params_from_flax(module, part.sum_of_squares,
                                          device)
        if hasattr(part, "mu") and hasattr(part, "nu"):
            out = {"count": torch.tensor(int(part.count), dtype=torch.int32,
                                         device=resolve_device(device))}
            for slot in ("mu", "nu"):
                tree = dense_params_from_flax(module, getattr(part, slot),
                                              device)
                out.update({f"{slot}/{k}": v for k, v in tree.items()})
            return out
    return {}


def dense_state_to_optax(state: Mapping[str, torch.Tensor], template):
    """An optax state shaped like ``template`` (``tx.init(params)`` of the
    same transform) holding the port's values, as numpy leaves."""
    def slot(prefix):
        return dense_params_to_flax({k[len(prefix):]: v
                                     for k, v in state.items()
                                     if k.startswith(prefix)})

    def convert(part):
        if hasattr(part, "sum_of_squares"):
            return part._replace(sum_of_squares=dense_params_to_flax(state))
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return part._replace(count=tensor_to_numpy(state["count"]),
                                 mu=slot("mu/"), nu=slot("nu/"))
        return part
    return tuple(convert(part) for part in template)
