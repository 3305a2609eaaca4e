"""Delta checkpoints: a base snapshot and a chain of dirty-chunk deltas
(``openembedding_tpu/checkpoint_delta.py``), in the JAX package's files.

* a FULL save (``checkpoint.save_checkpoint``) is the base; with the
  collection's dirty tracking armed it arms a chain by writing a fresh
  manifest (:func:`init_manifest`);
* a DELTA save (:func:`save_delta`) writes, for each variable with dirty
  chunks (``dirty.py``), one ``delta_<seq>_<vid>.npz``: an array
  variable's dirty chunks as contiguous row runs with a crc32 per chunk,
  a hash variable's live rows whose key chunk is dirty, in slot order;
  written by the checkpoint's writer pool;
* the MANIFEST (``delta_manifest``, committed by an atomic rename) is the
  single commit point: a kill at any instant leaves the previous chain or
  the new one. A torn or corrupt FINAL entry is discarded whole at load;
  a torn MIDDLE entry fails the load (:func:`verify_chain`);
* the COMPACTOR (:func:`compact`) folds a chain past its budget into a
  new base on disk, with no device involved, crash-safe by idempotence;
* the same deltas feed serving hot-swap: :class:`Delta` payloads
  (:func:`read_delta`, :func:`encode_delta`/:func:`decode_delta`) are
  applied by ``ModelRegistry.apply_delta``.

The device half is the payload gather (device to host: an array
variable's row runs; a hash variable's rows selected on the device by
its live mask and dirty key chunks, compacted in slot order, so only the
selected rows cross) and :func:`apply_delta_to_states` (host to device:
an ``index_copy_`` of array rows; a hash insert of given rows,
``hash_table.insert_rows``, which draws no init rows and counts keys it
cannot place in ``insert_failures``). bfloat16 payload fields are numpy
``V2`` arrays of 16-bit words, written under the descr ``'<V2'`` that
numpy gives ml_dtypes' bfloat16, so the files and wire frames are the
JAX package's.

Delta mode is local, one process (one device or a one-process mesh;
across processes it raises, as JAX's does) and over an uncompressed base
(the delta files themselves may be zlib-compressed). A sharded
variable's payload holds logical rows and keys, gathered from its
stacked shards, so a chain written from a mesh is byte for byte the chain
one shard writes with the same rows, and any layout, one shard or a
mesh or a serving shard slice, applies it. A dump written with dirty
tracking off has no manifest and loads as before.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
import uuid
import warnings
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import hash_table as hash_lib
from .analysis.concurrency import make_lock, sync_point
from .embedding import EmbeddingCollection
from .parallel import hot_cache
from .parallel import sharded_hash as sh
from .parallel import sharded_table as st
from .utils import fs

DELTA_MANIFEST_FILE = "delta_manifest"
DELTA_FORMAT = 1
# compaction budget: fold the chain into a new base past either bound
COMPACT_CHAIN_LEN = 8
COMPACT_BYTES_RATIO = 0.5
_APPLY_CHUNK = 1 << 16        # payload rows a delta apply moves at a time
_BF16_DESCR = "<V2"          # numpy's descr of ml_dtypes' bfloat16


def _delta_fname(seq: int, vid: int) -> str:
    return f"delta_{seq:06d}_{vid}.npz"


def _seq_ok(seq: Any) -> bool:
    """True when ``seq`` is an integral number within the int64 range
    (no bools, no NaN/inf), the native reader's rule too."""
    if isinstance(seq, bool) or not isinstance(seq, (int, float)):
        return False
    try:
        return (seq == int(seq)
                and -(2 ** 63) < int(seq) < 2 ** 63)
    except (OverflowError, ValueError):       # inf / nan
        return False


class DeltaDecodeError(ValueError):
    """Typed refusal of corrupt or garbage delta bytes (wire frames,
    manifest records, crc-valid but unparseable payloads). A
    ``ValueError``, so the REST delta route answers 400."""


# --- manifest ----------------------------------------------------------------

def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The committed manifest, or None (a plain full checkpoint)."""
    mpath = fs.join(path, DELTA_MANIFEST_FILE)
    if not fs.exists(mpath):
        return None
    manifest = fs.read_json(mpath)
    if not isinstance(manifest, dict):
        raise DeltaDecodeError(
            f"delta manifest at {path!r} is JSON "
            f"{type(manifest).__name__}, not an object")
    if manifest.get("format") != DELTA_FORMAT:
        raise ValueError(
            f"unknown delta manifest format {manifest.get('format')!r} "
            f"at {path!r} (this build reads format {DELTA_FORMAT})")
    return manifest


def _write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    fs.write_json_atomic(fs.join(path, DELTA_MANIFEST_FILE), manifest)


def init_manifest(path: str, *, step: int, include_optimizer: bool,
                  last_seq: int = 0,
                  content_seq: Optional[int] = None,
                  extra: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Arm a fresh chain over a just-written full base. ``last_seq``
    carries the version counter across a compaction and across a full
    save over an armed dir (seqs are burned, never reused: serving
    replicas would ack a reused seq as stale). ``content_seq``: the seq
    the base bytes reflect (default ``last_seq``). ``extra``: caller
    bookkeeping committed with the base (``Trainer.fit``'s resume
    cursor)."""
    manifest = {"format": DELTA_FORMAT,
                "base_id": uuid.uuid4().hex,
                "base_step": int(step),
                "include_optimizer": bool(include_optimizer),
                "last_seq": int(last_seq),
                "content_seq": int(last_seq if content_seq is None
                                   else content_seq),
                "extra": dict(extra) if extra else {},
                "chain": []}
    _write_manifest(path, manifest)
    return manifest


def reset_chain(path: str) -> None:
    """Remove the manifest (first: the commit point) and every delta
    file. A full save calls it before it touches base files."""
    mpath = fs.join(path, DELTA_MANIFEST_FILE)
    if fs.exists(mpath):
        fs.remove(mpath)
    _gc_orphans(path, chain=())


def chain_state(path: str) -> Dict[str, Any]:
    """Chain summary for version bookkeeping."""
    manifest = read_manifest(path)
    if manifest is None:
        return {"base_id": "", "base_step": 0, "last_seq": 0,
                "content_seq": 0, "chain_len": 0, "chain_bytes": 0}
    return {"base_id": manifest["base_id"],
            "base_step": manifest["base_step"],
            "last_seq": manifest["last_seq"],
            "content_seq": int(manifest.get("content_seq", 0)),
            "chain_len": len(manifest["chain"]),
            "chain_bytes": sum(int(e.get("bytes", 0))
                               for e in manifest["chain"])}


def _gc_orphans(path: str, chain) -> int:
    """Remove delta files the committed manifest does not reference,
    leftover atomic-write tmps and compaction tmps (the debris of a kill
    between a file's rename and the manifest's commit). Write path only."""
    live = set()
    for entry in chain:
        for info in entry.get("vars", {}).values():
            live.add(info["file"])
    n = 0
    try:
        names = fs.listdir(path)
    except OSError:  # pragma: no cover — listing is best-effort
        return 0
    for fname in names:
        orphan = (fname.startswith("delta_") and fname.endswith(".npz")
                  and fname not in live)
        if orphan or fs.is_tmp_orphan(fname):
            try:
                fs.remove(fs.join(path, fname))
                n += 1
            except OSError:  # pragma: no cover
                pass
        elif fname.startswith("var_") and fname.endswith(".d"):
            vdir = fs.join(path, fname)
            try:
                subnames = fs.listdir(vdir)
            except OSError:  # pragma: no cover
                continue
            for sub in subnames:
                if sub.endswith(".compact.tmp") or fs.is_tmp_orphan(sub):
                    try:
                        fs.remove(fs.join(vdir, sub))
                        n += 1
                    except OSError:  # pragma: no cover
                        pass
    return n


# --- host arrays of device tensors -----------------------------------------------

def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bfloat16 as ``V2`` words."""
    from .checkpoint import _host_words
    arr = _host_words(t)
    return arr.view(np.dtype("V2")) if t.dtype == torch.bfloat16 else arr


def _to_tensor(arr: np.ndarray, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Payload rows as a tensor of ``dtype`` on ``device``; ``V2`` rows are
    bfloat16 words."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise DeltaDecodeError(
                f"payload field of void itemsize {arr.dtype.itemsize} is "
                "not bfloat16")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=device, dtype=dtype)


# --- delta payloads ----------------------------------------------------------

def _field_order(payload: Dict[str, Any]) -> List[str]:
    """Field order of checksums and wire frames: the id column, weights,
    then slots by name."""
    fields = []
    for f in ("keys", "weights"):
        if f in payload:
            fields.append(f)
    fields += sorted(k for k in payload if k.startswith("slot_"))
    return fields


def _payload_fields(state, include_optimizer: bool,
                    keys: bool = False) -> Dict[str, torch.Tensor]:
    fields = {"keys": state.keys} if keys else {}
    fields["weights"] = state.weights
    if include_optimizer:
        for sname, sval in state.slots.items():
            fields[f"slot_{sname}"] = sval
    return fields


def _array_delta_payload(state, sspec, vocab: int, rows_per_chunk: int,
                         chunks: np.ndarray, include_optimizer: bool
                         ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """One array variable's dirty chunks as a payload dict and a crc32 per
    chunk (over the chunk's weights and slots bytes, in field order). The
    chunks' logical rows, in chunk order, copy to the host in one gather a
    field (of the stacked shards of a sharded table, ``sspec`` its
    ``ShardingSpec``; None for one shard), so a chain written from a mesh
    is the chain one shard writes, and the payload owns its memory: a
    later in-place step changes no committed delta."""
    fields = _payload_fields(state, include_optimizer)
    chunks = np.asarray(chunks, np.int64)
    R = int(rows_per_chunk)
    lo = chunks * R
    n = np.maximum(np.minimum(lo + R, vocab) - lo, 0)
    total = int(n.sum())
    ends = np.cumsum(n)
    ids = np.arange(total, dtype=np.int64) + np.repeat(lo - (ends - n), n)
    idx = torch.from_numpy(ids).to(state.weights.device)
    if sspec is not None:
        idx = sspec.physical_rows(idx)
    bufs = {f: _host_array(t.index_select(0, idx))
            for f, t in fields.items()}
    views = [bufs[f].reshape(total, -1).view(np.uint8)
             for f in _field_order(fields)] if total else []
    chunk_crcs = []
    for i in np.nonzero(n)[0]:
        a, b = int(ends[i] - n[i]), int(ends[i])
        crc = 0
        for v in views:
            crc = zlib.crc32(v[a:b], crc)
        chunk_crcs.append(crc)
    payload = dict(bufs)
    payload["chunks"] = chunks
    payload["rows_per_chunk"] = np.int64(R)
    payload["vocab"] = np.int64(vocab)
    return payload, chunk_crcs


def _sharding(collection: EmbeddingCollection, name: str, state):
    """Variable ``name``'s sharding spec when ``state`` is a sharded
    table (stacked shards), else None (the one-device table)."""
    if isinstance(state, (st.ShardedTableState, sh.ShardedHashState)):
        return collection.sharding_spec(name)
    return None


def _keys64(keys: torch.Tensor) -> torch.Tensor:
    """A hash table's keys as int64 on their device: wide (lo, hi) pairs
    joined (``hash_table.join64``'s rule), int32 keys widened."""
    if hash_lib.is_wide(keys):
        lo = keys[:, 0].to(torch.int64) & 0xFFFFFFFF
        return (keys[:, 1].to(torch.int64) << 32) | lo
    return keys.to(torch.int64)


def _hash_delta_payload(state, tracker, chunks: np.ndarray,
                        include_optimizer: bool
                        ) -> Dict[str, np.ndarray]:
    """One hash variable's live rows whose key chunk (``key %
    num_chunks``) is dirty, in slot order: selected on the device, only
    those rows copied to the host. Every live row of a dirty chunk ships
    (replay is newest-wins, so over-collection is safe). A sharded
    table's stacked shards are JAX's global physical array, so their slot
    order is the order JAX collects its shards in."""
    fields = _payload_fields(state, include_optimizer, keys=True)
    dev = state.keys.device
    dirty = torch.zeros(tracker.num_chunks, dtype=torch.bool, device=dev)
    dirty[torch.from_numpy(np.asarray(chunks, np.int64)).to(dev)] = True
    chunk = torch.remainder(_keys64(state.keys), tracker.num_chunks)
    sel = torch.nonzero(state.live() & dirty[chunk]).squeeze(1)
    payload = {f: _host_array(t.index_select(0, sel))
               for f, t in fields.items()}
    payload["chunks"] = np.asarray(chunks, np.int64)
    payload["num_chunks"] = np.int64(tracker.num_chunks)
    return payload


def _write_npy(fid, arr: np.ndarray) -> None:
    """``np.lib.format.write_array`` of ``arr``, a 2-byte void array
    under bfloat16's descr ``'<V2'``."""
    header = np.lib.format.header_data_from_array_1_0(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        header["descr"] = _BF16_DESCR
    np.lib.format.write_array_header_1_0(fid, header)
    fid.write(np.ascontiguousarray(arr).tobytes())


def _savez(payload: Dict[str, np.ndarray], compressed: bool) -> bytes:
    """The bytes ``np.savez`` (``np.savez_compressed``) writes for
    ``payload``, bfloat16 fields under their ``'<V2'`` descr."""
    bio = io.BytesIO()
    mode = zipfile.ZIP_DEFLATED if compressed else zipfile.ZIP_STORED
    with zipfile.ZipFile(bio, mode="w", compression=mode,
                         allowZip64=True) as zipf:
        for key, val in payload.items():
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, np.asanyarray(val))
    # a view of the buffer, not a copy of it (a delta of a whole table is
    # gigabytes)
    return bio.getbuffer()


def _serialize_payload(payload: Dict[str, np.ndarray],
                       compress: str) -> Tuple[bytes, int]:
    """npz bytes and their crc32 (the whole-file checksum the manifest
    records, verified before any byte of the delta is applied)."""
    from .utils import compress as compress_lib
    raw = _savez(payload,
                 bool(compress_lib.check_persist_codec(compress)))
    return raw, zlib.crc32(raw)


def _parse_payload(raw: bytes) -> Dict[str, np.ndarray]:
    # the whole-file crc was checked first: a parse failure here is
    # crc-preserving corruption, refused typed
    try:
        data = np.load(io.BytesIO(raw))
        return {k: data[k] for k in data.files}
    except DeltaDecodeError:
        raise
    except Exception as e:  # noqa: BLE001 — parser surface, see above
        raise DeltaDecodeError(
            f"delta payload npz is unparseable ({len(raw)} bytes, "
            f"crc-verified): {type(e).__name__}: {e}") from e


def _verify_array_chunks(payload: Dict[str, np.ndarray],
                         chunk_crc: List[int]) -> bool:
    """Recompute the per-chunk crcs of a parsed array payload. Never
    raises: ill-formed geometry reads as a mismatch."""
    try:
        chunks = np.asarray(payload["chunks"], np.int64)
        R = int(payload["rows_per_chunk"])
        vocab = int(payload["vocab"])
        order = _field_order(payload)
        if R <= 0 or vocab < 0 or chunks.ndim != 1:
            return False
        nchunks = -(-vocab // R)
        if len(chunk_crc) != chunks.size:
            return False
        off = 0
        for i, c in enumerate(chunks):
            c = int(c)
            if c < 0 or c >= nchunks:
                return False
            n = min((c + 1) * R, vocab) - c * R
            crc = 0
            for f in order:
                crc = zlib.crc32(payload[f][off:off + n].tobytes(), crc)
            if crc != int(chunk_crc[i]):
                return False
            off += n
        return all(payload[f].shape[0] == off for f in order)
    except (KeyError, TypeError, ValueError, OverflowError):
        return False


# --- delta save --------------------------------------------------------------

def save_delta(path: str, collection: EmbeddingCollection,
               states: Dict[str, Any], *, step: int,
               dense_state: Any = None,
               include_optimizer: bool = True,
               compress: str = "",
               model_sign: str = "",
               max_workers: Optional[int] = None,
               compact_chain_len: int = COMPACT_CHAIN_LEN,
               compact_bytes_ratio: float = COMPACT_BYTES_RATIO,
               background_compact: bool = True,
               return_payload: bool = False,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One incremental save: the dirty chunks since the last save as one
    new chain entry. A full save (``forced_full``) when no armed base
    exists. ``dense_state`` (a ``(params, opt_state)`` pair) is rewritten
    whole and atomically on every save, a skipped one too.
    ``return_payload=True`` puts the committed :class:`Delta` in
    ``info["delta"]`` from memory (the hot-swap publish path). ``extra``
    is committed with the entry (the elastic-resume channel). Past the
    compaction budget the chain is folded (on a thread when
    ``background_compact``)."""
    from . import checkpoint as ckpt
    from .utils import compress as compress_lib
    from .utils import observability
    compress = compress_lib.check_persist_codec(compress)
    if fs.is_remote(path):
        raise ValueError(
            "mode='delta' needs a local path (the compactor folds chain "
            "files into the base in place); dump remote checkpoints full")
    trackers = collection.dirty_trackers
    if not trackers:
        raise ValueError(
            "mode='delta' needs dirty tracking: call "
            "collection.enable_dirty_tracking() before training")
    join_compactor(path)
    manifest = read_manifest(path)
    t0 = time.perf_counter()
    if manifest is None:
        nbytes = ckpt._save_checkpoint_impl(
            path, collection, states, dense_state=dense_state,
            include_optimizer=include_optimizer, model_sign=model_sign,
            step=step, max_workers=max_workers, extra=extra)
        dt = time.perf_counter() - t0
        observability.record_ckpt_save("full", nbytes, dt, chain_len=0)
        return {"mode": "full", "forced_full": True, "bytes": int(nbytes),
                "seconds": dt, "seq": 0}
    if bool(manifest.get("include_optimizer", True)) \
            != bool(include_optimizer):
        raise ValueError(
            "delta save include_optimizer does not match the base "
            f"(base={manifest.get('include_optimizer')}); re-save full")
    _gc_orphans(path, manifest["chain"])
    if dense_state is not None:
        with fs.open_atomic(fs.join(path, ckpt.DENSE_FILE)) as f:
            f.write(ckpt._dense_bytes(dense_state))

    snaps = {name: trackers[name].snapshot_clear() for name in trackers}
    total_dirty = sum(s.size for s in snaps.values())
    if total_dirty == 0:
        return {"mode": "delta", "seq": int(manifest["last_seq"]),
                "skipped": True, "bytes": 0, "rows": 0,
                "chain_len": len(manifest["chain"])}
    seq = int(manifest["last_seq"]) + 1
    results: Dict[str, Dict[str, Any]] = {}
    kept_payloads: Dict[str, Dict[str, np.ndarray]] = {}
    ckpt._sync_device(collection)

    def _write_var(name: str) -> None:
        sync_point("ckpt.delta.write")
        spec = collection.specs[name]
        tracker = trackers[name]
        state = hot_cache.unwrap(states[name])
        chunks = snaps[name]
        if spec.use_hash:
            payload = _hash_delta_payload(state, tracker, chunks,
                                          include_optimizer)
            chunk_crc = None
        else:
            payload, chunk_crc = _array_delta_payload(
                state, _sharding(collection, name, state), spec.input_dim,
                tracker.rows_per_chunk, chunks, include_optimizer)
        rows = int(payload["weights"].shape[0])
        raw, crc = _serialize_payload(payload, compress)
        fname = _delta_fname(seq, collection.variable_id(name))
        with fs.open_atomic(fs.join(path, fname)) as f:
            f.write(raw)
        info = {"file": fname, "bytes": len(raw), "crc32": int(crc),
                "kind": "hash" if spec.use_hash else "array",
                "rows": rows, "dirty_chunks": int(chunks.size)}
        if chunk_crc is not None:
            info["chunk_crc"] = [int(c) for c in chunk_crc]
        results[name] = info
        if return_payload:
            kept_payloads[name] = payload

    tasks = [lambda n=name: _write_var(n) for name in trackers
             if snaps[name].size]
    try:
        ckpt._run_writers(tasks, max_workers=max_workers)
        entry = {"seq": seq, "step": int(step),
                 "bytes": sum(i["bytes"] for i in results.values()),
                 "rows": sum(i["rows"] for i in results.values()),
                 "vars": {n: results[n] for n in trackers if n in results}}
        if extra:
            entry["extra"] = dict(extra)
        manifest["chain"].append(entry)
        manifest["last_seq"] = seq
        # the commit point: before this rename readers replay the old
        # chain
        sync_point("ckpt.delta.commit")
        _write_manifest(path, manifest)
    except BaseException:
        # a failed write or commit gives every claim back, so the next
        # save re-covers it; written but uncommitted files are orphans
        for name, chunks in snaps.items():
            trackers[name].restore(chunks)
        raise
    dt = time.perf_counter() - t0
    observability.record_ckpt_save("delta", entry["bytes"], dt,
                                   chain_len=len(manifest["chain"]))
    info = {"mode": "delta", "seq": seq, "step": int(step),
            "bytes": int(entry["bytes"]), "rows": int(entry["rows"]),
            "seconds": dt, "chain_len": len(manifest["chain"]),
            "skipped": False}
    if return_payload:
        info["delta"] = Delta(seq=seq, step=int(step),
                              vars={n: kept_payloads[n] for n in trackers
                                    if n in kept_payloads})
    if compact_due(manifest, _base_bytes(path),
                   chain_len=compact_chain_len,
                   bytes_ratio=compact_bytes_ratio):
        compact(path, background=background_compact,
                max_workers=max_workers)
        info["compaction"] = "background" if background_compact \
            else "done"
    return info


def _base_bytes(path: str) -> int:
    total = 0
    for d in os.listdir(path):
        if d.startswith("var_") and d.endswith(".d"):
            vd = os.path.join(path, d)
            for f in os.listdir(vd):
                if f.endswith(".npy"):
                    total += os.path.getsize(os.path.join(vd, f))
    return total


def compact_due(manifest: Dict[str, Any], base_bytes: int, *,
                chain_len: int = COMPACT_CHAIN_LEN,
                bytes_ratio: float = COMPACT_BYTES_RATIO) -> bool:
    """Chain budget: ``chain_len`` entries, or chain bytes past
    ``bytes_ratio`` of the base."""
    chain = manifest.get("chain", [])
    if len(chain) >= chain_len:
        return True
    cb = sum(int(e.get("bytes", 0)) for e in chain)
    return base_bytes > 0 and cb >= bytes_ratio * base_bytes


# --- chain verification + replay ---------------------------------------------

def verify_chain(path: str, manifest: Dict[str, Any],
                 keep_payloads: bool = True
                 ) -> Tuple[List[Tuple[Dict[str, Any],
                                       Dict[str, Dict[str, np.ndarray]]]],
                            bool]:
    """Read and checksum every committed entry; returns ``(list of (entry,
    {var: payload}), dropped_last)``. A torn, corrupt or missing FINAL
    entry is discarded whole (with a ``RuntimeWarning``); the same damage
    mid-chain raises ``RuntimeError``. ``keep_payloads=False`` verifies
    without holding the parsed arrays."""
    entries = manifest.get("chain", [])
    if not isinstance(entries, list):
        raise DeltaDecodeError(
            f"delta chain at {path!r} is not a list (manifest corrupt)")
    out = []
    for i, entry in enumerate(entries):
        if (not isinstance(entry, dict) or "seq" not in entry
                or not isinstance(entry.get("vars"), dict)
                or not _seq_ok(entry.get("seq"))):
            raise DeltaDecodeError(
                f"corrupt delta chain entry #{i} at {path!r}")
        payloads: Dict[str, Dict[str, np.ndarray]] = {}
        bad = None
        for name, info in entry["vars"].items():
            try:
                fname = info["file"]
                want_crc = int(info["crc32"])
                if not isinstance(fname, str):
                    raise TypeError(
                        f"file field is {type(fname).__name__}")
            except (TypeError, KeyError, ValueError) as e:
                bad = f"var {name!r}: malformed manifest record ({e})"
                break
            fpath = fs.join(path, fname)
            try:
                with fs.open_file(fpath, "rb") as f:
                    raw = f.read()
            except (OSError, FileNotFoundError):
                bad = f"{fname}: missing/unreadable"
                break
            if zlib.crc32(raw) != want_crc:
                bad = f"{fname}: crc mismatch"
                break
            payload = _parse_payload(raw)
            if info.get("chunk_crc") is not None \
                    and not _verify_array_chunks(payload,
                                                 info["chunk_crc"]):
                bad = f"{info['file']}: chunk checksum mismatch"
                break
            if keep_payloads:
                payloads[name] = payload
            del payload
        if bad is None:
            out.append((entry, payloads))
            continue
        if i == len(entries) - 1:
            warnings.warn(
                f"delta chain at {path!r}: final entry seq="
                f"{entry['seq']} is torn ({bad}); discarded — "
                "recovering to the last complete delta", RuntimeWarning)
            return out, True
        raise RuntimeError(
            f"delta chain at {path!r} is torn mid-chain at seq="
            f"{entry['seq']} ({bad}); later deltas build on it — "
            "restore the file or fall back to an older full checkpoint")
    return out, False


def _entry_payload(path: str, entry: Dict[str, Any],
                   name: str) -> Optional[Dict[str, np.ndarray]]:
    """Re-read one verified entry's payload for one variable."""
    info = entry["vars"].get(name)
    if info is None:
        return None
    with fs.open_file(fs.join(path, info["file"]), "rb") as f:
        return _parse_payload(f.read())


def replay_chain(path: str, collection: EmbeddingCollection,
                 states: Dict[str, Any], *, manifest: Dict[str, Any],
                 with_opt: bool,
                 shard_slice: Optional[tuple] = None,
                 info: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Apply the committed chain over freshly loaded base states, in
    order, one entry in memory at a time, in place. ``info`` gets
    ``applied_seq`` and ``resume_extra`` from the same verify pass.
    ``shard_slice``: as in :func:`apply_delta_to_states`."""
    verified, _dropped = verify_chain(path, manifest, keep_payloads=False)
    if info is not None:
        info["applied_seq"] = verified_seq(manifest, verified)
        info["resume_extra"] = resume_extra(manifest, verified)
    for entry, _ in verified:
        payloads = {name: _entry_payload(path, entry, name)
                    for name in entry["vars"]}
        states = apply_delta_to_states(collection, states, payloads,
                                       with_opt=with_opt, donate=True,
                                       shard_slice=shard_slice)
        del payloads
    return states


def verified_seq(manifest: Optional[Dict[str, Any]], verified) -> int:
    """Version of an already-verified chain view: the last verified
    entry's seq, else the manifest's ``content_seq``."""
    if manifest is None:
        return 0
    if verified:
        return int(verified[-1][0]["seq"])
    return int(manifest.get("content_seq", 0))


def resume_extra(manifest: Optional[Dict[str, Any]],
                 verified) -> Dict[str, Any]:
    """The ``extra`` of an already-verified chain view: the last verified
    entry's, else the manifest base's (never a dropped tail's)."""
    if manifest is None:
        return {}
    if verified:
        return dict(verified[-1][0].get("extra") or {})
    return dict(manifest.get("extra") or {})


def applied_seq(path: str) -> int:
    """Chain seq a load of ``path`` replays up to (torn tail excluded).
    Against a directory a trainer is saving into, prefer the version a
    load reports itself (``load_checkpoint(info=)``)."""
    manifest = read_manifest(path)
    if manifest is None:
        return 0
    verified, _ = verify_chain(path, manifest, keep_payloads=False)
    return verified_seq(manifest, verified)


def apply_delta_to_states(collection: EmbeddingCollection,
                          states: Dict[str, Any],
                          payloads: Dict[str, Dict[str, np.ndarray]],
                          *, with_opt: bool = True,
                          donate: bool = True,
                          shard_slice: Optional[tuple] = None
                          ) -> Dict[str, Any]:
    """Patch variable states with delta payloads; returns a new states
    dict. ``donate=True`` patches the given tensors in place (the load
    path's replay); ``donate=False`` builds each patched variable from
    copies of its tensors and leaves ``states`` as it was (serving
    hot-swap: in-flight lookups keep the pre-swap tensors).
    ``shard_slice=(k, G)``: states of a serving shard group's member,
    which keeps the payload rows it owns (array ids ≡ k (mod G) at row
    ``id // G``, hash keys whose joined value is ≡ k (mod G)), the rule
    of ``checkpoint.load_checkpoint(shard_slice=)``. Payloads hold
    logical rows and keys: a sharded state takes them through its layout
    (array rows at their stacked positions, ``sharded_table.
    deliver_rows_sharded``; hash rows inserted by their owner shards,
    ``sharded_hash.insert_rows_sharded``), as JAX's does on any mesh. A
    plane's derived state (a hot-row replica, an int8 residual) comes
    back empty around the patched table."""
    out = dict(states)
    for name, payload in payloads.items():
        if name not in collection.specs:
            continue
        spec = collection.specs[name]
        state = hot_cache.unwrap(out[name])
        if "keys" in payload:
            if not spec.use_hash:
                raise ValueError(
                    f"delta for {name!r} is a hash payload but the "
                    "variable is bounded — delta chains cannot "
                    "category-swap; load the base full or re-save")
            state = _apply_hash_payload(name, state, payload,
                                        _sharding(collection, name, state),
                                        mesh=collection.mesh,
                                        with_opt=with_opt, donate=donate,
                                        shard_slice=shard_slice)
        else:
            if spec.use_hash:
                raise ValueError(
                    f"delta for {name!r} is an array payload but the "
                    "variable is hash — delta chains cannot "
                    "category-swap; load the base full or re-save")
            state = _apply_array_payload(state, payload,
                                         _sharding(collection, name, state),
                                         with_opt=with_opt, donate=donate,
                                         shard_slice=shard_slice)
        # a plane's derived state comes back empty, as JAX's
        # wrap_hot_cache leaves it
        out[name] = collection.attach_derived(name, state)
    return out


def _payload_ids(payload: Dict[str, np.ndarray]) -> np.ndarray:
    """Logical row ids of an array payload's rows (chunk ranges expanded
    in order); ill-formed headers refused typed."""
    try:
        chunks = np.asarray(payload["chunks"], np.int64)
        R = int(payload["rows_per_chunk"])
        vocab = int(payload["vocab"])
    except (KeyError, TypeError, ValueError, OverflowError) as e:
        raise DeltaDecodeError(
            f"corrupt array delta header: {type(e).__name__}: {e}"
        ) from e
    if R <= 0 or vocab < 0:
        raise DeltaDecodeError(
            f"corrupt array delta header (rows_per_chunk={R}, "
            f"vocab={vocab})")
    if not chunks.size:
        return np.zeros(0, np.int64)
    nchunks = -(-vocab // R)
    lo, hi = int(chunks.min()), int(chunks.max())
    if lo < 0 or hi >= nchunks:
        raise DeltaDecodeError(
            f"array delta chunk id out of range: [{lo}, {hi}] outside "
            f"[0, {nchunks})")
    lo = chunks * R
    n = np.maximum(np.minimum(lo + R, vocab) - lo, 0)
    return np.arange(int(n.sum()), dtype=np.int64) \
        + np.repeat(lo - (np.cumsum(n) - n), n)


def _owned(ids: np.ndarray, shard_slice: Optional[tuple]):
    """The payload rows a shard slice keeps (None: all)."""
    if shard_slice is None:
        return None
    k, g = shard_slice
    return (ids % g) == k


def _apply_array_payload(state, payload, sspec, *, with_opt: bool,
                         donate: bool, shard_slice: Optional[tuple] = None):
    ids = _payload_ids(payload)
    names = ["weights"] + [f"slot_{s}" for s in state.slots
                           if with_opt and f"slot_{s}" in payload]
    if ids.size:
        for f in names:
            if np.asarray(payload[f]).shape[0] != ids.size:
                raise DeltaDecodeError(
                    f"array delta field {f!r} holds "
                    f"{np.asarray(payload[f]).shape[0]} rows for "
                    f"{ids.size} ids")
    # the payload rows applied (a shard slice's own; None: all, in order)
    rows_at = None
    sel = _owned(ids, shard_slice)
    if sel is not None:
        rows_at = np.nonzero(sel)[0]
        ids = ids[sel] // shard_slice[1]
    weights = state.weights if donate else state.weights.clone()
    slots = dict(state.slots)
    targets = {"weights": weights}
    for f in names[1:]:
        s = f[len("slot_"):]
        if not donate:
            slots[s] = slots[s].clone()
        targets[f] = slots[s]
    dev = weights.device
    for lo in range(0, ids.size, _APPLY_CHUNK):
        hi = lo + _APPLY_CHUNK
        idx = torch.from_numpy(ids[lo:hi]).to(dev)
        if sspec is not None:
            # logical ids to the stacked shards' rows
            idx = sspec.physical_rows(idx)
        for f, target in targets.items():
            rows = payload[f][lo:hi] if rows_at is None \
                else np.asarray(payload[f])[rows_at[lo:hi]]
            target.index_copy_(0, idx, _to_tensor(rows, target.dtype, dev))
    return dataclasses.replace(state, weights=weights, slots=slots)


def _apply_hash_payload(name: str, state, payload, sspec, *, mesh,
                        with_opt: bool, donate: bool,
                        shard_slice: Optional[tuple] = None):
    keys = np.asarray(payload["keys"])
    sel = _owned(hash_lib.join64(keys) if keys.ndim == 2
                 else keys.astype(np.int64), shard_slice)
    if sel is not None:
        payload = {f: np.asarray(v)[sel] if f in ("keys", "weights")
                   or f.startswith("slot_") else v
                   for f, v in payload.items()}
        keys = np.asarray(payload["keys"])
    payload_wide = keys.ndim == 2
    if state.wide != payload_wide:
        raise ValueError(
            f"delta for {name!r}: key width mismatch (payload "
            f"{'wide' if payload_wide else 'narrow'}, table "
            f"{'wide' if state.wide else 'narrow'}) — delta chains "
            "cannot key-migrate; load the base full instead")
    slot_names = [s for s in state.slots if f"slot_{s}" in payload] \
        if with_opt else []
    if not donate:
        counter = "insert_failures" if sspec is None else "shard_failures"
        state = dataclasses.replace(
            state, keys=state.keys.clone(), weights=state.weights.clone(),
            slots={k: v.clone() for k, v in state.slots.items()},
            **{counter: getattr(state, counter).clone()})
    before = int(state.insert_failures)
    dev = state.keys.device
    kdt = np.int64 if state.keys.dtype == torch.int64 else np.int32
    for lo in range(0, keys.shape[0], _APPLY_CHUNK):
        hi = lo + _APPLY_CHUNK
        ck = torch.from_numpy(np.array(keys[lo:hi], dtype=kdt)).to(dev)
        cw = _to_tensor(payload["weights"][lo:hi], state.weights.dtype, dev)
        srows = {s: _to_tensor(payload[f"slot_{s}"][lo:hi],
                               state.slots[s].dtype, dev)
                 for s in slot_names}
        if sspec is None:
            hash_lib.insert_rows(state, ck, cw, srows)
        else:
            sh.insert_rows_sharded(state, ck, cw, srows or None, mesh=mesh,
                                   spec=sspec)
    grew = int(state.insert_failures) - before
    if grew > 0:
        raise RuntimeError(
            f"hash variable {name!r}: {grew} delta rows did not fit "
            "(hash_capacity too small); a delta apply must deliver "
            "every row or fail")
    return state


# --- hot-swap payloads (the train->serve stream) -----------------------------

@dataclasses.dataclass
class Delta:
    """One committed delta as an in-memory payload: the unit a trainer
    publishes and ``ModelRegistry.apply_delta`` patches in. ``vars`` holds
    the per-variable dicts the chain files store."""

    seq: int
    step: int
    vars: Dict[str, Dict[str, np.ndarray]]

    @property
    def rows(self) -> int:
        return sum(int(p["weights"].shape[0]) for p in self.vars.values())


def read_delta(path: str, seq: Optional[int] = None) -> Delta:
    """Load one committed delta (default: the newest) for publishing."""
    manifest = read_manifest(path)
    if manifest is None or not manifest.get("chain"):
        raise ValueError(f"no committed deltas at {path!r}")
    entries = manifest["chain"]
    if not isinstance(entries, list):
        raise DeltaDecodeError(
            f"delta chain at {path!r} is not a list (manifest corrupt)")
    if seq is None:
        entry = entries[-1]
    else:
        match = [e for e in entries
                 if isinstance(e, dict) and e.get("seq") == seq]
        if not match:
            raise KeyError(
                f"no delta seq={seq} at {path!r} (chain has "
                f"{[e.get('seq') for e in entries if isinstance(e, dict)]})")
        entry = match[0]
    try:
        eseq = int(entry["seq"])
        estep = int(entry["step"])
        var_items = list(entry["vars"].items())
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        raise DeltaDecodeError(
            f"corrupt delta chain entry at {path!r}: "
            f"{type(e).__name__}: {e}") from e
    payloads = {}
    for name, info in var_items:
        try:
            fname = info["file"]
            want_crc = int(info["crc32"])
            if not isinstance(fname, str):
                raise TypeError(f"file field is {type(fname).__name__}")
        except (TypeError, KeyError, ValueError) as e:
            raise DeltaDecodeError(
                f"corrupt delta manifest record for {name!r} at "
                f"{path!r}: {type(e).__name__}: {e}") from e
        with fs.open_file(fs.join(path, fname), "rb") as f:
            raw = f.read()
        if zlib.crc32(raw) != want_crc:
            raise RuntimeError(
                f"delta seq={eseq} file {fname} fails "
                "its checksum; refusing to publish a corrupt delta")
        payloads[name] = _parse_payload(raw)
    return Delta(seq=eseq, step=estep, vars=payloads)


def read_deltas_since(path: str, after_seq: int) -> List[Delta]:
    """Committed deltas with ``seq > after_seq``, in order: the catch-up
    stream of a replica that fell behind."""
    manifest = read_manifest(path)
    if manifest is None:
        return []
    chain = manifest.get("chain") or []
    try:
        seqs = [int(e["seq"]) for e in chain]
        if not all(_seq_ok(s) for s in seqs):
            raise ValueError("seq outside the int64 range")
    except (TypeError, ValueError, KeyError) as e:
        raise DeltaDecodeError(
            f"corrupt delta chain at {path!r}: "
            f"{type(e).__name__}: {e}") from e
    return [read_delta(path, s) for s in seqs if s > int(after_seq)]


def _descr(arr: np.ndarray) -> str:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return _BF16_DESCR
    return np.lib.format.dtype_to_descr(arr.dtype)


def encode_delta(delta: Delta, compress: str = "") -> bytes:
    """Wire frame of a delta: one JSON header line (seq, step, each
    field's name, descr and shape) and the arrays' raw bytes, optionally
    compressed."""
    from .utils import compress as compress_lib
    compress = compress_lib.check(compress)
    head: Dict[str, Any] = {"seq": delta.seq, "step": delta.step,
                            "vars": {}}
    body = bytearray()
    for name in sorted(delta.vars):
        payload = delta.vars[name]
        specs = []
        for f in sorted(payload):
            arr = np.ascontiguousarray(np.asarray(payload[f]))
            specs.append([f, _descr(arr), list(arr.shape)])
            body += arr.tobytes()
        head["vars"][name] = specs
    raw = bytes(body)
    if compress:
        head["compress"] = compress
        raw = compress_lib.compress(compress, raw)
    return json.dumps(head).encode() + b"\n" + raw


def decode_delta(data: bytes) -> Delta:
    """Decode one :func:`encode_delta` wire frame. The frame is untrusted
    bytes (the REST delta route's body): every malformed shape refuses
    with :class:`DeltaDecodeError`."""
    from .utils import compress as compress_lib
    data = bytes(data)
    nl = data.find(b"\n")
    if nl < 0:
        raise DeltaDecodeError(
            f"delta wire frame has no header line ({len(data)} bytes, "
            "no newline)")
    try:
        head = json.loads(data[:nl])
    except ValueError as e:
        raise DeltaDecodeError(
            f"delta wire header (bytes 0..{nl}) is not valid JSON: {e}"
        ) from e
    if not isinstance(head, dict):
        raise DeltaDecodeError(
            f"delta wire header is JSON {type(head).__name__}, "
            "not an object")
    raw = data[nl + 1:]
    codec = head.get("compress", "")
    if codec:
        try:
            raw = compress_lib.decompress(codec, raw)
        except DeltaDecodeError:
            raise
        except Exception as e:  # noqa: BLE001 — zlib.error/bad codec
            raise DeltaDecodeError(
                f"delta wire body (offset {nl + 1}) fails {codec!r} "
                f"decompression: {type(e).__name__}: {e}") from e
    try:
        seq = int(head["seq"])
        step = int(head["step"])
        var_specs = head["vars"]
    except (KeyError, TypeError, ValueError) as e:
        raise DeltaDecodeError(
            f"delta wire header missing/corrupt field: "
            f"{type(e).__name__}: {e}") from e
    if not isinstance(var_specs, dict):
        raise DeltaDecodeError(
            f"delta wire header 'vars' is JSON "
            f"{type(var_specs).__name__}, not an object")
    off = 0
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, specs in var_specs.items():
        if not isinstance(specs, list):
            raise DeltaDecodeError(
                f"delta wire specs for {name!r} are not a list")
        payload = {}
        for spec in specs:
            try:
                f, descr, shape = spec
                dtype = np.dtype(np.lib.format.descr_to_dtype(descr))
                dims = [int(d) for d in shape]
            except (TypeError, ValueError, KeyError) as e:
                raise DeltaDecodeError(
                    f"corrupt field spec {spec!r} for {name!r}: "
                    f"{type(e).__name__}: {e}") from e
            if any(d < 0 for d in dims):
                raise DeltaDecodeError(
                    f"negative dim in field spec {spec!r} for {name!r}")
            count = 1
            for d in dims:
                count *= d
            nb = (count if dims else 1) * dtype.itemsize
            if off + nb > len(raw):
                raise DeltaDecodeError(
                    f"delta wire body truncated: field {f!r} of "
                    f"{name!r} needs body bytes [{off}, {off + nb}) "
                    f"but the body holds {len(raw)}")
            try:
                arr = np.frombuffer(raw[off:off + nb], dtype=dtype)
                payload[f] = arr.reshape(dims) if dims else arr[0]
            except (ValueError, IndexError) as e:
                raise DeltaDecodeError(
                    f"field {f!r} of {name!r} does not decode as "
                    f"{descr!r} x {dims}: {type(e).__name__}: {e}"
                ) from e
            off += nb
        out[name] = payload
    return Delta(seq=seq, step=step, vars=out)


# --- the compactor -----------------------------------------------------------

class _Compactor:
    def __init__(self, thread: threading.Thread):
        self.thread = thread
        self.err: Optional[BaseException] = None


_COMPACT_LOCK = make_lock("ckpt.compactors")
_COMPACTORS: Dict[str, _Compactor] = {}


def join_compactor(path: str) -> None:
    """Join (and surface the error of) any background compaction of
    ``path``: the compactor and the saver never run at once."""
    key = os.path.realpath(path)
    with _COMPACT_LOCK:
        holder = _COMPACTORS.pop(key, None)
    if holder is None:
        return
    holder.thread.join()
    if holder.err is not None:
        raise RuntimeError("background chain compaction failed") \
            from holder.err


def compact(path: str, *, background: bool = False,
            max_workers: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Fold the committed chain into a new base on disk (file work only,
    so it can run on a thread while training goes on). Crash-safe by
    idempotence: folding performs the newest-wins assignments a replay
    would, each base file commits by an atomic rename, and the new
    manifest (empty chain, new ``base_id``, ``last_seq`` kept) is the
    commit point. A chain that does not verify is left untouched."""
    if background:
        key = os.path.realpath(path)
        join_compactor(path)
        holder_ref: List[_Compactor] = []

        def _run():
            sync_point("ckpt.compact.run")
            try:
                _compact_impl(path, max_workers=max_workers)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                holder_ref[0].err = e

        t = threading.Thread(target=_run, daemon=False,
                             name="oe-ckpt-compact")
        holder = _Compactor(t)
        holder_ref.append(holder)
        with _COMPACT_LOCK:
            _COMPACTORS[key] = holder
        t.start()
        return None
    return _compact_impl(path, max_workers=max_workers)


def _compact_impl(path: str, *,
                  max_workers: Optional[int] = None) -> Dict[str, Any]:
    from . import checkpoint as ckpt
    from .meta import ModelMeta, UNBOUNDED_VOCAB
    manifest = read_manifest(path)
    if manifest is None or not manifest["chain"]:
        return {"compacted": False}
    try:
        verified, dropped = verify_chain(path, manifest,
                                         keep_payloads=False)
    except RuntimeError as e:
        warnings.warn(
            f"delta chain at {path!r}: refusing to compact a chain that "
            f"does not verify ({e}); re-save full to restore durability",
            RuntimeWarning)
        return {"compacted": False, "error": str(e)}
    entries = [e for e, _p in verified]
    if dropped:
        # a torn committed entry must not be folded away: its chunks
        # were claimed at its save and nothing would re-cover them
        torn = manifest["chain"][len(entries)]["seq"]
        warnings.warn(
            f"delta chain at {path!r}: refusing to compact across torn "
            f"entry seq={torn}; re-save full to restore durability",
            RuntimeWarning)
        return {"compacted": False, "torn_seq": int(torn)}
    with fs.open_file(fs.join(path, ckpt.MODEL_META_FILE), "rb") as f:
        meta = ModelMeta.loads(f.read().decode("utf-8"))
    folded_steps = [e["step"] for e in entries]
    for v in meta.variables:
        name = v.name
        has = [e for e in entries if name in e["vars"]]
        if not has:
            continue
        vdir = os.path.join(path, ckpt._var_dir(v.variable_id, name))
        if v.meta.vocabulary_size >= UNBOUNDED_VOCAB:
            _fold_hash_var(vdir, [_entry_payload(path, e, name)
                                  for e in has])
        else:
            _fold_array_var(vdir, path, has, name,
                            max_workers=max_workers)
    new_manifest = {"format": DELTA_FORMAT,
                    "base_id": uuid.uuid4().hex,
                    "base_step": int(folded_steps[-1]) if folded_steps
                    else manifest["base_step"],
                    "include_optimizer":
                        bool(manifest.get("include_optimizer", True)),
                    "last_seq": int(manifest["last_seq"]),
                    "content_seq": int(entries[-1]["seq"]) if entries
                    else int(manifest.get("content_seq", 0)),
                    # the newest folded entry's resume extra, never an
                    # older one's
                    "extra": dict(entries[-1].get("extra") or {}),
                    "chain": []}
    sync_point("ckpt.compact.commit")
    _write_manifest(path, new_manifest)
    _gc_orphans(path, chain=())
    return {"compacted": True, "folded": len(verified),
            "last_seq": new_manifest["last_seq"]}


def _as_stored(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """Payload rows in a base file's stored dtype (bfloat16 words are
    ``V2`` in both)."""
    arr = np.asarray(arr)
    if arr.dtype == dtype:
        return arr
    if arr.dtype.kind == "V" or dtype.kind == "V":
        if arr.dtype.itemsize != dtype.itemsize:
            raise ValueError(f"payload rows of {arr.dtype} cannot fold "
                             f"into a {dtype} base field")
        return arr.view(dtype)
    return arr.astype(dtype)


def _fold_array_var(vdir: str, path: str, entries: List[Dict[str, Any]],
                    name: str,
                    max_workers: Optional[int] = None) -> None:
    """New base field files: the old base with every payload's chunk rows
    written over it in chain order, one payload in memory at a time."""
    from . import checkpoint as ckpt
    fields = sorted(f[:-4] for f in os.listdir(vdir)
                    if f.endswith(".npy"))
    srcs, dsts = {}, {}
    tasks = []
    for field in fields:
        src_path = os.path.join(vdir, field + ".npy")
        src = np.load(src_path, mmap_mode="r")
        dst = np.lib.format.open_memmap(
            src_path + ".compact.tmp", mode="w+", dtype=src.dtype,
            shape=src.shape)
        srcs[field], dsts[field] = src, dst
        row_bytes = max(1, src.nbytes // max(1, src.shape[0]))
        win = max(1, ckpt._BLOCK_BYTES // row_bytes)
        for lo in range(0, src.shape[0], win):
            hi = min(src.shape[0], lo + win)
            tasks.append(lambda lo=lo, hi=hi, src=src, dst=dst:
                         dst.__setitem__(slice(lo, hi), src[lo:hi]))
    ckpt._run_writers(tasks, max_workers=max_workers)
    for entry in entries:
        payload = _entry_payload(path, entry, name)
        if payload is None:
            continue
        ids = _payload_ids(payload)
        for field in fields:
            if field not in payload:
                continue
            dsts[field][ids] = _as_stored(payload[field],
                                          srcs[field].dtype)
        del payload
    for field in fields:
        dsts[field].flush()
        del dsts[field], srcs[field]
        os.replace(os.path.join(vdir, field + ".npy.compact.tmp"),
                   os.path.join(vdir, field + ".npy"))


def _fold_hash_var(vdir: str, payloads: List[Dict[str, np.ndarray]]
                   ) -> None:
    """New base: the old live rows with payload rows merged newest-wins
    by 64-bit key; keys absent from the base append at the end in the
    order they first appear in the chain (payload by payload, each in
    slot order). JAX appends them sorted by key; this order is the one
    they were inserted in, so a load of the folded base places every key
    in the slot the trained table holds it in (at loads where no bucket
    overflows), and a resumed table equals an uninterrupted one slot for
    slot."""
    key_path = os.path.join(vdir, "keys.npy")
    base_keys = np.load(key_path, mmap_mode="r")
    wide = base_keys.ndim == 2
    k64_base = hash_lib.join64(np.asarray(base_keys)) if wide \
        else np.asarray(base_keys).astype(np.int64)
    order = np.argsort(k64_base, kind="stable")
    sorted_base = k64_base[order]
    all_k, all_src = [], []
    for pi, payload in enumerate(payloads):
        pk = np.asarray(payload["keys"])
        k64 = hash_lib.join64(pk) if pk.ndim == 2 \
            else pk.astype(np.int64)
        all_k.append(k64)
        all_src.append(np.stack(
            [np.full(k64.shape, pi, np.int64),
             np.arange(k64.shape[0], dtype=np.int64)], axis=1))
    cat_k = np.concatenate(all_k) if all_k else np.zeros(0, np.int64)
    cat_src = np.concatenate(all_src) if all_src \
        else np.zeros((0, 2), np.int64)
    rev_k = cat_k[::-1]
    uniq, ridx = np.unique(rev_k, return_index=True)
    take = cat_k.shape[0] - 1 - ridx          # last occurrence, keys sorted
    src = cat_src[take]
    _, first = np.unique(cat_k, return_index=True)   # first occurrence
    pos = np.searchsorted(sorted_base, uniq)
    pos_c = np.minimum(pos, max(0, sorted_base.shape[0] - 1))
    hit = (pos < sorted_base.shape[0]) & (sorted_base[pos_c] == uniq) \
        if sorted_base.size else np.zeros(uniq.shape, bool)
    exist_rows = order[pos_c[hit]] if sorted_base.size \
        else np.zeros(0, np.int64)
    new_src = src[~hit][np.argsort(first[~hit], kind="stable")]
    n_base = int(base_keys.shape[0])
    total = n_base + int(new_src.shape[0])
    fields = sorted(f[:-4] for f in os.listdir(vdir)
                    if f.endswith(".npy"))
    del base_keys
    for field in fields:
        src_path = os.path.join(vdir, field + ".npy")
        base = np.load(src_path, mmap_mode="r")
        tmp_path = src_path + ".compact.tmp"
        dst = np.lib.format.open_memmap(
            tmp_path, mode="w+", dtype=base.dtype,
            shape=(total,) + base.shape[1:])
        chunk = max(1, (32 << 20) // max(1, base.nbytes
                                         // max(1, n_base or 1)))
        for lo in range(0, n_base, chunk):
            hi = min(n_base, lo + chunk)
            dst[lo:hi] = base[lo:hi]

        def rows_for(sel_src):
            out = None
            for pi, payload in enumerate(payloads):
                mask = sel_src[:, 0] == pi
                if not mask.any():
                    continue
                rows = payload[field][sel_src[mask, 1]]
                if out is None:
                    out = np.zeros((sel_src.shape[0],) + rows.shape[1:],
                                   base.dtype)
                out[mask] = _as_stored(rows, base.dtype)
            return out

        if exist_rows.size:
            upd = rows_for(src[hit])
            if upd is not None:
                dst[exist_rows] = upd
        if new_src.size:
            app = rows_for(new_src)
            if app is not None:
                dst[n_base:] = app
        dst.flush()
        del dst, base
        os.replace(tmp_path, src_path)
