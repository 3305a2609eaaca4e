"""Checkpoint save/load in the JAX package's on-disk layout
(``openembedding_tpu/checkpoint.py``).

This slice reads and writes the local, uncompressed, single-process,
``mode="full"`` layout:

* ``<path>/model_meta`` — the ``ModelMeta`` JSON, with ``extra`` keys
  ``include_optimizer``, ``storage_dtypes`` (per-field numpy dtype names),
  ``delta_last_seq`` (the hot-swap burn counter, carried over from a
  previous save in the same directory), ``variable_num_shards`` and, for
  hash variables, ``hash_variables`` (``hash_capacity`` and ``key_dtype``,
  so a loader that has only the dump, the serving registry, sizes tables
  that hold every row);
* ``<path>/var_<id>_<name>.d/{weights,slot_*}.npy`` — for an array
  variable exactly ``input_dim`` rows in logical id order; for a hash
  variable ``keys.npy`` (``[n]`` int32 or ``[n, 2]`` int32 pairs) beside
  them, holding the live rows only, in slot order. bfloat16 fields are
  stored as numpy's opaque ``'<V2'`` descr, as the JAX package stores
  them, and decoded through the recorded storage dtype.

Loads validate the meta before touching a table. Array fields stream in
bounded blocks into a tensor on the collection's device, so host memory
stays at one block whatever the table size; hash variables load by
inserting chunks of ``_LOAD_CHUNK`` rows into an empty table on the device
(``hash_table.insert_rows``) that carries the collection's init key for
the variable, and a load that cannot place every row fails. An int32-key dump loads into a wide table as (lo, hi) pairs, and
a wide dump into an int32 table when every key fits int32. Slot
files are skipped when the collection's optimizer has no slots (serving's
``default``). What the JAX package also writes or reads — delta chains,
multi-host part files, compressed streams, legacy ``.npz`` files, remote
URIs, hash<->array conversion on load — is refused with
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import hash_table as hash_lib
from .embedding import EmbeddingCollection, not_ported
from .meta import UNBOUNDED_VOCAB, ModelMeta
from .utils import fs

MODEL_META_FILE = "model_meta"
DELTA_MANIFEST_FILE = "delta_manifest"
# rows move between disk and device in windows of about this many bytes
_BLOCK_BYTES = 32 << 20
# hash rows load in chunks of this many keys (the JAX loader's chunk, so
# keys land in the same slots as a JAX load of the same dump)
_LOAD_CHUNK = 1 << 16

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.bfloat16: "bfloat16", torch.int32: "int32"}


def _var_dir(variable_id: int, name: str) -> str:
    safe = name.replace("/", "_").replace(":", "__")
    return f"var_{variable_id}_{safe}.d"


def _block_rows(t: torch.Tensor) -> int:
    row_bytes = max(1, t[0].numel() * t.element_size()) if len(t) else 1
    return max(1, _BLOCK_BYTES // row_bytes)


# --- save --------------------------------------------------------------------

def _open_npy_for_write(path: str, dtype: torch.dtype, shape) -> np.memmap:
    """A writable memmap behind a ``.npy`` header. bfloat16 has no numpy
    dtype: its header says ``'<V2'`` (what numpy writes for ml_dtypes'
    bfloat16) and the memmap holds the raw 16-bit words."""
    if dtype == torch.bfloat16:
        descr, word = "<V2", np.dtype(np.uint16)
    else:
        word = np.dtype(_NP_NAMES[dtype])
        descr = np.lib.format.dtype_to_descr(word)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False,
                "shape": tuple(int(s) for s in shape)})
        offset = f.tell()
        f.truncate(offset + word.itemsize * int(np.prod(shape,
                                                        dtype=np.int64)))
    return np.memmap(path, dtype=word, mode="r+", offset=offset,
                     shape=tuple(shape))


def _host_words(block: torch.Tensor) -> np.ndarray:
    block = block.detach().cpu().contiguous()
    if block.dtype == torch.bfloat16:
        return block.view(torch.int16).numpy().view(np.uint16)
    return block.numpy()


def _write_field(npy: str, t: torch.Tensor, mask: Optional[torch.Tensor],
                 rows: Optional[int]) -> int:
    """Write ``t`` (only its rows where ``mask`` holds, ``rows`` of them,
    in order) to ``npy`` block by block; returns the bytes written."""
    if mask is None:
        rows = t.shape[0]
    mm = _open_npy_for_write(npy, t.dtype, (rows,) + tuple(t.shape[1:]))
    step = _block_rows(t)
    o = 0
    for lo in range(0, t.shape[0], step):
        block = t[lo:lo + step]
        if mask is not None:
            block = block[mask[lo:lo + step]]
        mm[o:o + block.shape[0]] = _host_words(block)
        o += block.shape[0]
    mm.flush()
    del mm
    return rows * (t[0].numel() if len(t) else 0) * t.element_size()


def _prev_meta_last_seq(path: str) -> int:
    """Burn counter a previous save recorded in this directory (0 when
    the dir is fresh or its meta unreadable)."""
    mpath = fs.join(path, MODEL_META_FILE)
    if not fs.exists(mpath):
        return 0
    try:
        with fs.open_file(mpath, "rb") as f:
            meta = ModelMeta.loads(f.read().decode("utf-8"))
    except ValueError:
        return 0    # a corrupt old meta never blocks a full save
    return int(meta.extra.get("delta_last_seq", 0))


def save_checkpoint(path: str, collection: EmbeddingCollection,
                    states: Dict[str, Any], *,
                    dense_state: Any = None,
                    include_optimizer: bool = True,
                    model_sign: str = "",
                    mode: str = "full") -> Dict[str, Any]:
    """Dump every variable under ``path``; returns
    ``{"mode", "bytes", "seconds", "seq"}`` like the JAX package.
    ``dense_state`` (the JAX package's flax-msgpack dense file) is not
    written yet."""
    if dense_state is not None:
        raise not_ported("save_checkpoint(dense_state=)",
                         "delta checkpoints and other layouts")
    if mode == "delta":
        raise not_ported("delta checkpoints (mode='delta')",
                         "delta checkpoints and other layouts")
    if mode != "full":
        raise ValueError(f"unknown checkpoint mode {mode!r}; use 'full'")
    t0 = time.perf_counter()
    fs.makedirs(path)
    if fs.exists(fs.join(path, DELTA_MANIFEST_FILE)):
        raise not_ported(f"{path!r} holds a delta chain",
                         "delta checkpoints and other layouts")
    meta = collection.model_meta(model_sign=model_sign, model_uri=path)
    meta.extra["include_optimizer"] = bool(include_optimizer)
    meta.extra["delta_last_seq"] = _prev_meta_last_seq(path)
    hash_info = {name: {"hash_capacity": spec.hash_capacity,
                        "key_dtype": spec.key_dtype}
                 for name, spec in collection.specs.items() if spec.use_hash}
    if hash_info:
        meta.extra["hash_variables"] = hash_info
    targets, live = {}, {}
    for name, spec in collection.specs.items():
        state = states[name]
        fields = {"weights": state.weights}
        if include_optimizer:
            fields.update({f"slot_{s}": v for s, v in state.slots.items()})
        if spec.use_hash:
            targets[name] = {"keys": state.keys, **fields}
            live[name] = state.live()
        else:
            targets[name] = {f: t[:spec.input_dim]
                             for f, t in fields.items()}
    meta.extra["storage_dtypes"] = {
        name: {f: _NP_NAMES[t.dtype] for f, t in fields.items()}
        for name, fields in targets.items()}
    with fs.open_file(fs.join(path, MODEL_META_FILE), "wb") as f:
        f.write(meta.dumps().encode("utf-8"))
    nbytes = 0
    for name, fields in targets.items():
        vdir = fs.join(path, _var_dir(collection.variable_id(name), name))
        if fs.isdir(vdir):
            # a previous save under another optimizer could leave slot
            # files a later load would mistake for state
            fs.rmtree(vdir)
        fs.makedirs(vdir)
        mask = live.get(name)
        rows = int(mask.sum()) if mask is not None else None
        for fname, t in fields.items():
            nbytes += _write_field(os.path.join(vdir, fname + ".npy"), t,
                                   mask, rows)
    return {"mode": "full", "bytes": int(nbytes),
            "seconds": time.perf_counter() - t0, "seq": 0}


# --- load --------------------------------------------------------------------

def _is_hash(m) -> bool:
    return m.vocabulary_size >= UNBOUNDED_VOCAB


def _check_meta(path: str, collection: EmbeddingCollection) -> ModelMeta:
    """Validate the dump's variable metas against the collection's: dim
    and vocab must match, the datatype may differ within {float32,
    bfloat16} (rows are cast on load), as in the JAX package."""
    with fs.open_file(fs.join(path, MODEL_META_FILE), "rb") as f:
        meta = ModelMeta.loads(f.read().decode("utf-8"))
    got_vars = {v.name: v for v in meta.variables}
    for v in collection.model_meta().variables:
        if v.name not in got_vars:
            raise ValueError(f"checkpoint at {path!r} has no variable "
                             f"{v.name!r}")
        g = got_vars[v.name].meta
        if _is_hash(g) != _is_hash(v.meta):
            raise not_ported(
                f"loading the {'hash' if _is_hash(g) else 'array'} dump of "
                f"{v.name!r} in {path!r} into an "
                f"{'array' if _is_hash(g) else 'hash'} variable "
                "(hash<->array conversion)",
                "delta checkpoints and other layouts")
        if g == v.meta:
            continue
        dtype_ok = (g.datatype == v.meta.datatype
                    or {g.datatype, v.meta.datatype}
                    <= {"float32", "bfloat16"})
        if not (dtype_ok and g.embedding_dim == v.meta.embedding_dim
                and g.vocabulary_size == v.meta.vocabulary_size):
            raise ValueError(f"variable {v.name!r} meta mismatch: "
                             f"checkpoint {g} vs model {v.meta}")
    return meta


def _check_layout(path: str, collection: EmbeddingCollection) -> None:
    """Refuse the layouts this slice does not read."""
    if fs.exists(fs.join(path, DELTA_MANIFEST_FILE)):
        raise not_ported(f"{path!r} holds a delta chain",
                         "delta checkpoints and other layouts")
    for name in collection.specs:
        vdir = fs.join(path, _var_dir(collection.variable_id(name), name))
        if not fs.isdir(vdir):
            raise not_ported(f"variable {name!r} has no var_<id>_<name>.d "
                             f"directory in {path!r} (a legacy .npz dump?)",
                             "delta checkpoints and other layouts")
        for f in fs.listdir(vdir):
            if f.startswith("part"):
                raise not_ported(f"multi-host part file {f!r} in {vdir!r}",
                                 "multi-shard exchange planes")
            if f.endswith(".npyz"):
                raise not_ported(f"compressed file {f!r} in {vdir!r}",
                                 "delta checkpoints and other layouts")


def _decode(block: np.ndarray, true_dtype: Optional[str],
            target: torch.dtype, legacy_dtype: Optional[str]) -> torch.Tensor:
    """One stored block as a CPU tensor castable to ``target``. Opaque
    ``V2`` blocks are bfloat16 words when the recorded storage dtype (or,
    for "tpu-1" dumps without one, the target or the dump's table dtype)
    says so."""
    if block.dtype.kind == "V":
        for cand in (true_dtype, _NP_NAMES.get(target), legacy_dtype):
            if cand == "bfloat16" and block.dtype.itemsize == 2:
                return torch.from_numpy(
                    np.array(block).view(np.int16)).view(torch.bfloat16)
        raise ValueError(
            f"stored void block of itemsize {block.dtype.itemsize} "
            f"matches none of (recorded={true_dtype!r}, target={target}, "
            f"dump table dtype={legacy_dtype!r})")
    return torch.from_numpy(np.array(block))


def _load_field(npy: str, target: torch.Tensor, true_dtype: Optional[str],
                legacy_dtype: Optional[str]) -> None:
    """Stream ``npy`` into ``target`` block by block (rows past the end of
    the file keep their fill)."""
    arr = np.load(npy, mmap_mode="r")
    if tuple(arr.shape[1:]) != tuple(target.shape[1:]):
        raise ValueError(f"{npy}: rows of shape {arr.shape[1:]}, expected "
                         f"{tuple(target.shape[1:])}")
    rows = min(target.shape[0], arr.shape[0])
    step = _block_rows(target)
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        target[lo:hi].copy_(_decode(arr[lo:hi], true_dtype, target.dtype,
                                    legacy_dtype))


def _load_hash_var(vdir: str, name: str, spec, collection, with_opt: bool,
                   stored: Dict[str, str], legacy: Optional[str], rng):
    """An empty hash table on the collection's device, filled by inserting
    the dump's live rows chunk by chunk; refuses a dump whose rows do not
    all fit. The fresh table takes the collection's init key for the
    variable under ``rng`` (``EmbeddingCollection.hash_init_rng``), as
    JAX's loader takes ``collection.init(rng)``'s, so a loaded model that
    trains on draws JAX's init rows for keys the dump lacks."""
    state = collection.init(rng, only=[name])[name]
    empty = hash_lib.empty_key(torch.int32)
    keys = np.load(fs.join(vdir, "keys.npy"), mmap_mode="r")
    fields = {"weights": state.weights}
    if with_opt:
        fields.update({s: t for s, t in state.slots.items()
                       if fs.exists(fs.join(vdir, f"slot_{s}.npy"))})
    stores = {f: np.load(fs.join(vdir, ("weights" if f == "weights"
                                        else f"slot_{f}") + ".npy"),
                         mmap_mode="r") for f in fields}
    for f, arr in stores.items():
        if arr.shape[0] != keys.shape[0] \
                or tuple(arr.shape[1:]) != tuple(fields[f].shape[1:]):
            raise ValueError(f"{vdir}: {f} of shape {arr.shape} does not "
                             f"match keys {keys.shape}")
    n = keys.shape[0]
    for lo in range(0, n, _LOAD_CHUNK):
        hi = min(n, lo + _LOAD_CHUNK)
        ck = np.array(keys[lo:hi])
        if state.wide and ck.ndim == 1:
            # an int32 (or int64) dump into a wide table: narrow keys
            # become the pairs of the same 64-bit values; keys in the
            # wide EMPTY band (hi == INT32_MIN) would read as free slots
            ck = hash_lib.split64(ck.astype(np.int64))
            banded = ck[:, 1] == empty
            if banded.any():
                raise ValueError(
                    f"{int(banded.sum())} dump keys of {name!r} fall in "
                    "the wide-key EMPTY band (hi word == INT32_MIN, keys "
                    "in [-2^63, -2^63+2^32)); the wide pair encoding "
                    "excludes that range")
        elif not state.wide and ck.ndim == 2:
            # a wide dump into an int32 table: join, refuse truncation
            joined = hash_lib.join64(ck)
            if joined.size and (joined.max() > np.iinfo(np.int32).max
                                or joined.min() < np.iinfo(np.int32).min):
                raise ValueError(
                    f"wide-key dump of {name!r} holds keys outside the "
                    "table's int32 range; load into a key_dtype='wide' "
                    "variable instead")
            ck = joined.astype(np.int32)
        rows = {f: _decode(arr[lo:hi], stored.get(
                    "weights" if f == "weights" else f"slot_{f}"),
                    fields[f].dtype, legacy).to(collection.device)
                for f, arr in stores.items()}
        weights = rows.pop("weights")
        hash_lib.insert_rows(state, torch.from_numpy(ck).to(
            collection.device), weights, rows)
    failed = int(state.insert_failures)
    if failed:
        raise RuntimeError(
            f"hash variable {name!r}: {failed} of {n} checkpoint rows did "
            f"not fit (hash_capacity={spec.hash_capacity}); increase "
            "hash_capacity — a load must deliver every row or fail")
    return state


def load_checkpoint(path: str, collection: EmbeddingCollection, *,
                    rng=None, info: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Rebuild every variable's ``TableState`` from ``path`` on the
    collection's device. ``rng``: the collection key whose hash init keys
    the loaded hash tables take (``collection.init(rng)``'s, as JAX's
    ``load_checkpoint(rng=)``; None: ``prng_key(collection.seed)``).
    ``info`` (a caller's dict) receives ``applied_seq`` — always 0 here,
    since delta chains are refused."""
    from .table import TableState, resolve_dtype
    meta = _check_meta(path, collection)
    _check_layout(path, collection)
    with_opt = bool(meta.extra.get("include_optimizer", True))
    stored_all = meta.extra.get("storage_dtypes", {})
    dump_meta = {v.name: v.meta for v in meta.variables}
    device = collection.device
    out = {}
    for name, spec in collection.specs.items():
        vdir = fs.join(path, _var_dir(collection.variable_id(name), name))
        stored = stored_all.get(name, {})
        legacy = dump_meta[name].datatype
        if spec.use_hash:
            out[name] = _load_hash_var(vdir, name, spec, collection,
                                       with_opt, stored, legacy, rng)
            continue
        dtype = resolve_dtype(spec.meta())
        weights = torch.zeros((spec.input_dim, spec.output_dim),
                              dtype=dtype, device=device)
        _load_field(fs.join(vdir, "weights.npy"), weights,
                    stored.get("weights"), legacy)
        optimizer = collection.optimizer(name)
        slots = optimizer.init_slots(spec.input_dim, spec.output_dim, dtype,
                                     device)
        for sname, tensor in slots.items():
            npy = fs.join(vdir, f"slot_{sname}.npy")
            # absent from the dump (saved without optimizer state, or
            # under another optimizer): the slot keeps its fresh init
            if with_opt and fs.exists(npy):
                _load_field(npy, tensor, stored.get(f"slot_{sname}"),
                            legacy)
        out[name] = TableState(weights=weights, slots=slots)
    if info is not None:
        info["applied_seq"] = 0
    return out
