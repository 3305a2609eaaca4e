"""Checkpoint save/load in the JAX package's on-disk layouts
(``openembedding_tpu/checkpoint.py``), at one process.

* ``<path>/model_meta`` — the ``ModelMeta`` JSON, with ``extra`` keys
  ``include_optimizer``, ``storage_dtypes`` (per-field numpy dtype names),
  ``delta_last_seq`` (the hot-swap burn counter, carried over from a
  previous save in the same directory), ``variable_num_shards`` and, for
  hash variables, ``hash_variables`` (``hash_capacity`` and ``key_dtype``,
  so a loader that has only the dump, the serving registry, sizes tables
  that hold every row);
* ``<path>/var_<id>_<name>.d/{weights,slot_*}.npy`` — the local layout:
  for an array variable exactly ``input_dim`` rows in logical id order;
  for a hash variable ``keys.npy`` (``[n]`` int32 or ``[n, 2]`` int32
  pairs) beside them, holding the live rows only, in slot order. bfloat16
  fields are stored as numpy's opaque ``'<V2'`` descr, as the JAX package
  stores them, and decoded through the recorded storage dtype;
* ``part<k>_{ids,keys,weights,slot_*}.npy[z]`` in the same directories —
  the part layout, keyed rows written as sequential streams: what
  ``save_checkpoint(compress=)`` writes (``.npyz`` framed, compressed
  streams, ``fs.NpyzWriter``), and every save to a ``scheme://`` URI
  (fsspec; ``memory://`` among them). An array variable's part carries
  its logical ids (``ids``), a hash variable's its keys. One process
  writes ``part0_``; a dump written by several JAX hosts has one part
  per host, and the port loads them all;
* ``<path>/var_<id>_<name>.npz`` — the legacy single-file dump, read only;
* ``<path>/dense_state.msgpack`` — ``save_checkpoint(dense_state=(params,
  opt_state))``: the bytes ``flax.serialization.to_bytes`` writes for the
  JAX ``Trainer``'s pair (``utils/msgpack_state.py``);
* ``<path>/delta_manifest`` and ``delta_<seq>_<vid>.npz`` — a delta chain
  (``checkpoint_delta.py``): a local uncompressed full save with the
  collection's dirty tracking armed writes a fresh manifest over its
  base, ``mode="delta"`` appends the dirty chunks, and
  ``load_checkpoint`` replays the committed chain over the base. A part
  base (compressed or remote) arms no chain, as in JAX: the compactor
  folds into raw ``.npy`` files, and a delta save into such a directory
  stays a forced full save.

A local full save snapshots the trackers, resets any chain (manifest
first), then writes every field through a pool of writer threads
(``_run_writers``, ``OE_CKPT_WRITERS`` or ``max_workers``), each task
owning a disjoint file region: a window of rows of an array field, or a
whole field of a hash variable; a part save gives each field's stream a
task of its own. The device is synchronized once before the writers copy
anything, so no copy can read a table before the step that writes it has
finished. Part streams frame their rows in JAX's 4 MiB blocks, so a
compressed dump of a one-device table is byte-identical to JAX's.

Loads validate the meta before touching a table. A local array dump
streams from its memmap in bounded blocks into a tensor on the
collection's device; keyed, compressed, remote and legacy dumps stream in
chunks of ``_LOAD_CHUNK`` rows through the same delivery
(``_deliver_rows``: a copy into a row window, or an ``index_copy_`` at
the chunk's ids), so no whole table is held on the host. Hash variables
load by inserting chunks of ``_LOAD_CHUNK`` rows into an empty table on
the device (``hash_table.insert_rows``) that carries the collection's init
key for the variable, and a load that cannot place every row fails. An
int32-key dump loads into a wide table as (lo, hi) pairs, and a wide dump
into an int32 table when every key fits int32. A hash dump loads into an
array variable (keys become row ids; a key outside the vocabulary fails
the load) and an array dump into a hash variable (row ids become keys),
the JAX package's ``copy_from`` conversions. Slot files are skipped when
the collection's optimizer has no slots (serving's ``default``).

Sharded variables (``parallel/``) are saved in JAX's logical layout: an
array table's rows in logical id order (the ``mod`` permutation undone,
``sharded_table.to_logical``; JAX's ``gather_logical_window``), a hash
table's live rows in the order of its stacked shards (JAX's global
array); the meta records each variable's ``variable_num_shards``. Loads
work across topologies: array rows are laid out on the collection's own
shards (``sharded_table.from_logical``), hash rows re-inserted at their
owners by key (``sharded_hash.insert_rows_sharded``).

On a mesh across processes (``distributed.py``) every process streams
its own shards into ``part<rank>_*`` (array ids and rows of the shards
it holds, a hash table's live rows), and rank 0 commits the dump by
writing the meta, with ``num_parts``, after a barrier every part has
passed; ``mode="delta"`` raises there, as in JAX. A load on such a mesh
reads any layout and keeps only the rows its own shards hold. A serving
shard group's member loads its slice (``load_checkpoint(shard_slice=
(k, G))``).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import hash_table as hash_lib
from .analysis import scope
from .analysis.concurrency import sync_point
from .embedding import EmbeddingCollection
from .meta import UNBOUNDED_VOCAB, ModelMeta
from .parallel import sharded_hash as sh
from .parallel import sharded_table as st
from .parallel import hot_cache
from .utils import fs

MODEL_META_FILE = "model_meta"
DENSE_FILE = "dense_state.msgpack"
DELTA_MANIFEST_FILE = "delta_manifest"
# rows move between disk and device in windows of about this many bytes
_BLOCK_BYTES = 32 << 20
# rows load in chunks of this many keys (the JAX loader's chunk, so hash
# keys land in the same slots as a JAX load of the same dump)
_LOAD_CHUNK = 1 << 16
# the block of a part stream (JAX's _BLOCK_BYTES): each block one .npyz
# frame, so a compressed dump frames its rows as JAX's does
_PART_BLOCK_BYTES = 4 << 20

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.bfloat16: "bfloat16", torch.int32: "int32",
             torch.int64: "int64"}


def _var_file(variable_id: int, name: str) -> str:
    """The legacy single-file dump of one variable."""
    safe = name.replace("/", "_").replace(":", "__")
    return f"var_{variable_id}_{safe}.npz"


def _var_dir(variable_id: int, name: str) -> str:
    safe = name.replace("/", "_").replace(":", "__")
    return f"var_{variable_id}_{safe}.d"


def _block_rows(t: torch.Tensor) -> int:
    row_bytes = max(1, t[0].numel() * t.element_size()) if len(t) else 1
    return max(1, _BLOCK_BYTES // row_bytes)


def _sync_device(collection: EmbeddingCollection) -> None:
    """Wait for the collection's device: the writer threads then copy
    tables whose last update has finished, whatever stream wrote it."""
    if collection.device.type == "cuda":
        torch.cuda.synchronize(collection.device)


# --- parallel writers --------------------------------------------------------

def _default_writers() -> int:
    """Writer-thread pool width (``OE_CKPT_WRITERS`` overrides; 1 runs
    the tasks in order on the caller's thread)."""
    env = os.environ.get("OE_CKPT_WRITERS", "")
    if env:
        return max(1, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def _run_writers(tasks, *, max_workers: Optional[int] = None) -> None:
    """Run writer callables on a bounded pool of named, joined threads.

    Every task owns a disjoint file region, so tasks contend only on the
    device-to-host copies and the disk. The first task error is re-raised
    after the join; queued tasks are abandoned (their files are debris a
    later save overwrites or collects)."""
    tasks = deque(tasks)
    if not tasks:
        return
    n = min(len(tasks), max_workers or _default_writers())
    if n <= 1:
        while tasks:
            sync_point("ckpt.writer.run")
            tasks.popleft()()
        return
    errs: list = []

    def _drain():
        while not errs:
            try:
                task = tasks.popleft()   # deque.popleft is atomic
            except IndexError:
                return
            try:
                sync_point("ckpt.writer.run")
                task()
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                errs.append(e)
                return

    threads = [threading.Thread(target=_drain, daemon=False,
                                name=f"oe-ckpt-writer-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]


# --- save --------------------------------------------------------------------

def _word_descr(dtype) -> tuple:
    """``(numpy word dtype, .npy descr)`` a field of ``dtype`` (a torch
    or numpy dtype) is stored under. bfloat16 has no numpy dtype: its
    header says ``'<V2'`` (what numpy writes for ml_dtypes' bfloat16) over
    the raw 16-bit words."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16), "<V2"
    word = np.dtype(_NP_NAMES[dtype]) if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype)
    return word, np.lib.format.dtype_to_descr(word)


def _open_npy_for_write(path: str, dtype: torch.dtype, shape) -> np.memmap:
    """A writable memmap behind a ``.npy`` header (``_word_descr``)."""
    word, descr = _word_descr(dtype)
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


def _row_bytes(t: torch.Tensor) -> int:
    return (t[0].numel() if len(t) else 0) * t.element_size()


def _array_field_tasks(npy: str, t: torch.Tensor):
    """Tasks writing ``t`` to ``npy``, one a window of rows; returns
    ``(tasks, finish, bytes)``."""
    mm = _open_npy_for_write(npy, t.dtype, tuple(t.shape))
    step = _block_rows(t)

    def _write(lo: int, hi: int) -> None:
        mm[lo:hi] = _host_words(t[lo:hi])

    tasks = [partial(_write, lo, min(t.shape[0], lo + step))
             for lo in range(0, t.shape[0], step)]
    return tasks, mm.flush, t.shape[0] * _row_bytes(t)


def _hash_field_task(npy: str, t: torch.Tensor, mask: torch.Tensor,
                     rows: int):
    """A task writing ``t``'s rows where ``mask`` holds (``rows`` of
    them), in slot order, to ``npy``; returns ``(task, bytes)``."""
    mm = _open_npy_for_write(npy, t.dtype, (rows,) + tuple(t.shape[1:]))
    step = _block_rows(t)

    def _write() -> None:
        o = 0
        for lo in range(0, t.shape[0], step):
            block = t[lo:lo + step][mask[lo:lo + step]]
            mm[o:o + block.shape[0]] = _host_words(block)
            o += block.shape[0]
        if o != rows:
            raise RuntimeError(f"{npy}: wrote {o} rows, expected {rows}")
        mm.flush()

    return _write, rows * _row_bytes(t)


def _seq_writer(path_npy: str, dtype, shape, compress: str, pool):
    """Sequential block writer: raw ``.npy`` or, with a codec, the framed
    compressed ``.npyz`` container (``fs.NpyzWriter``, its blocks
    compressed on ``pool``'s threads; ``pool`` is None without one)."""
    word, descr = _word_descr(dtype)
    if compress:
        return fs.NpyzWriter(path_npy + "z", word, shape, compress,
                             descr=descr, pool=pool)
    return fs.NpyWriter(path_npy, word, shape, descr=descr)


def _part_block(row_bytes: int) -> int:
    return max(1, _PART_BLOCK_BYTES // max(1, row_bytes))


def _array_part_tasks(vdir: str, part: str, fields: Dict[str, torch.Tensor],
                      compress: str, pool,
                      ids: Optional[np.ndarray] = None):
    """Tasks streaming one array variable's rows (``fields``, each
    ``[n, ...]``) to ``<part>{ids,weights,slot_*}.npy[z]``, one task a
    file; returns ``(tasks, bytes)``. ``ids``: the rows' logical ids
    (None: ``0 .. n - 1``, the whole vocabulary). Each field is framed in
    blocks of its own row size, the ids in the weights' blocks (JAX's
    ``_save_array_var_part`` over a one-device table)."""
    vocab = int(fields["weights"].shape[0])

    def _field(fname: str, t: torch.Tensor, step: int) -> None:
        with _seq_writer(fs.join(vdir, f"{part}{fname}.npy"), t.dtype,
                         tuple(t.shape), compress, pool) as w:
            for lo in range(0, vocab, step):
                w.write(_host_words(t[lo:lo + step]))

    def _ids(step: int) -> None:
        with _seq_writer(fs.join(vdir, f"{part}ids.npy"), np.int64,
                         (vocab,), compress, pool) as w:
            for lo in range(0, vocab, step):
                w.write(np.arange(lo, min(vocab, lo + step), dtype=np.int64)
                        if ids is None else ids[lo:lo + step])

    tasks = [partial(_ids, _part_block(_row_bytes(fields["weights"])))]
    nbytes = 0
    for fname, t in fields.items():
        tasks.append(partial(_field, fname, t, _part_block(_row_bytes(t))))
        nbytes += vocab * _row_bytes(t)
    return tasks, nbytes


def _hash_part_tasks(vdir: str, part: str, fields: Dict[str, torch.Tensor],
                     mask: torch.Tensor, rows: int, compress: str,
                     pool):
    """Tasks streaming one hash variable's live rows (``mask``, ``rows``
    of them, in slot order) of every field (``keys`` among them) to
    ``<part><field>.npy[z]``, one task a file; returns ``(tasks,
    bytes)``. The slots are walked in blocks sized by all the fields'
    row bytes together and each block's live rows are one frame (JAX's
    ``_save_hash_var`` over a one-device table)."""
    cap = int(mask.shape[0])
    step = _part_block(sum(_row_bytes(t) for t in fields.values()))

    def _field(fname: str, t: torch.Tensor) -> None:
        with _seq_writer(fs.join(vdir, f"{part}{fname}.npy"), t.dtype,
                         (rows,) + tuple(t.shape[1:]), compress,
                         pool) as w:
            for lo in range(0, cap, step):
                block = t[lo:lo + step][mask[lo:lo + step]]
                if block.shape[0]:
                    w.write(_host_words(block))

    return ([partial(_field, f, t) for f, t in fields.items()],
            rows * sum(_row_bytes(t) for t in fields.values()))


def _prev_meta_last_seq(path: str) -> int:
    """Burn counter a previous save recorded in this directory (0 when
    the dir is fresh or its meta unreadable)."""
    mpath = fs.join(path, MODEL_META_FILE)
    try:
        if not fs.exists(mpath):
            return 0
        with fs.open_file(mpath, "rb") as f:
            meta = ModelMeta.loads(f.read().decode("utf-8"))
        return int(meta.extra.get("delta_last_seq", 0))
    except Exception:  # noqa: BLE001 — a corrupt old meta never blocks
        return 0       # a full save, which rewrites it


def _dense_bytes(dense_state) -> bytes:
    """The dense-state file's bytes of a ``(params, opt_state)`` pair."""
    from .utils.msgpack_state import dense_state_to_bytes
    try:
        params, opt_state = dense_state
    except (TypeError, ValueError) as e:
        raise TypeError("dense_state must be the (params, opt_state) "
                        "pair of a TrainState") from e
    return dense_state_to_bytes(params, opt_state)


def save_checkpoint(path: str, collection: EmbeddingCollection,
                    states: Dict[str, Any], *,
                    dense_state: Any = None,
                    include_optimizer: bool = True,
                    model_sign: str = "",
                    compress: str = "",
                    mode: str = "full",
                    step: int = 0,
                    max_workers: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Dump every variable (and ``dense_state``, a ``(params,
    opt_state)`` pair, when given) under ``path``; returns an info dict
    (``mode``, ``bytes``, ``seconds``, ``seq``; a delta's also ``rows``,
    ``chain_len``, ``skipped``) like the JAX package.

    ``mode="delta"`` writes only the chunks dirtied since the last save
    (``collection.enable_dirty_tracking()`` must be armed) as one entry of
    the checkpoint's chain (``checkpoint_delta.save_delta``), or a full
    save recorded as ``forced_full`` when no armed base exists yet. A full
    save with tracking armed arms a chain over its base. ``step`` stamps
    the save; ``extra`` (JSON) is committed with it and comes back from
    ``load_checkpoint(info=)`` as ``resume_extra``.

    ``compress`` (``""``, ``"zlib"``, ``"zstd"`` where a zstd binding is
    installed, else a ``ValueError`` before anything is written) and any
    ``scheme://`` path write the part layout (module note), which arms
    no delta chain. The bytes reported are the rows' own, before
    compression."""
    if mode not in ("full", "delta"):
        raise ValueError(f"unknown checkpoint mode {mode!r}; "
                         "use 'full' or 'delta'")
    if mode == "delta" and collection.mesh.spans_processes:
        raise ValueError("mode='delta' is single-process; dumps across "
                         "processes use the full part format")
    from .utils import observability
    with scope.span("checkpoint.save", detail={"mode": mode}):
        if mode == "delta":
            from . import checkpoint_delta as cd
            return cd.save_delta(
                path, collection, states, step=step,
                dense_state=dense_state,
                include_optimizer=include_optimizer, compress=compress,
                model_sign=model_sign, max_workers=max_workers,
                extra=extra)
        t0 = time.perf_counter()
        nbytes = _save_checkpoint_impl(
            path, collection, states, dense_state=dense_state,
            include_optimizer=include_optimizer, model_sign=model_sign,
            compress=compress, step=step, max_workers=max_workers,
            extra=extra)
        dt = time.perf_counter() - t0
        observability.record_ckpt_save("full", nbytes, dt, chain_len=0)
        return {"mode": "full", "bytes": int(nbytes), "seconds": dt,
                "seq": 0}


def _save_checkpoint_impl(path: str, collection: EmbeddingCollection,
                          states: Dict[str, Any], *, dense_state: Any,
                          include_optimizer: bool, model_sign: str,
                          compress: str = "",
                          step: int = 0,
                          max_workers: Optional[int] = None,
                          extra: Optional[Dict[str, Any]] = None) -> int:
    """Full dump; returns the bytes of the fields written (keys, rows and
    slots, before compression) by this process.

    Rank 0 prepares the directory (the delta chain reset, the old meta
    removed, the variable directories emptied), every process writes its
    parts, and after a barrier rank 0 writes the dense state and the meta
    last: a directory with a meta holds a whole dump. On a mesh across
    processes every process writes its own shards to ``part<rank>_*``
    (a ``psum`` table's replica by rank 0, which holds data row 0, as
    JAX writes replica 0) and the meta records ``num_parts``; in one
    process the barriers are no-ops."""
    from . import checkpoint_delta as cd
    from .utils import compress as compress_lib
    compress = compress_lib.check(compress)
    remote = fs.is_remote(path)
    mesh = collection.mesh
    nproc, rank = mesh.process_count, mesh.process_index
    # the part layout: compressed streams, remote paths, several processes
    part = f"part{rank}_" if (remote or compress or nproc > 1) else ""
    carried_seq = 0
    if rank == 0:
        fs.makedirs(path)
        if not remote:
            # a background compactor owns this directory's base files:
            # join it before touching anything
            cd.join_compactor(path)
            # the chain is reset FIRST (manifest removed before any base
            # file changes); its burned seqs are carried into the
            # re-armed manifest, or into the meta of a base that arms none
            try:
                prev_manifest = cd.read_manifest(path)
            except ValueError:
                prev_manifest = None  # unknown-format manifest: reset anyway
            carried_seq = int(prev_manifest.get("last_seq", 0)) \
                if prev_manifest else _prev_meta_last_seq(path)
        sync_point("ckpt.full.reset")
        cd.reset_chain(path)
        # the old meta goes next: until the new one is written the
        # directory holds no dump
        mpath = fs.join(path, MODEL_META_FILE)
        if fs.exists(mpath):
            fs.remove(mpath)
        for name in collection.specs:
            vdir = fs.join(path, _var_dir(collection.variable_id(name), name))
            if fs.isdir(vdir):
                # a previous save under another optimizer could leave slot
                # files a later load would mistake for state
                fs.rmtree(vdir)
            fs.makedirs(vdir)
    _barrier(mesh, "ckpt.dirs")
    # trackers snapshot at the START: marks landing during the save refer
    # to later pushes and must survive for the next delta
    for tracker in collection.dirty_trackers.values():
        tracker.snapshot_clear()
    meta = collection.model_meta(model_sign=model_sign, model_uri=path)
    meta.extra["include_optimizer"] = bool(include_optimizer)
    hash_info = {name: {"hash_capacity": spec.hash_capacity,
                        "key_dtype": spec.key_dtype}
                 for name, spec in collection.specs.items() if spec.use_hash}
    if hash_info:
        meta.extra["hash_variables"] = hash_info
    meta.extra["delta_last_seq"] = int(carried_seq)
    if nproc > 1:
        meta.extra["num_parts"] = nproc
    targets, live, part_ids = {}, {}, {}
    for name, spec in collection.specs.items():
        # a plane's replica or residual is derived: only the table is saved
        state = hot_cache.unwrap(states[name])
        sspec = collection.sharding_spec(name)
        if collection.sharded(name) and not spec.use_hash:
            # the logical rows: the mod permutation undone, padding dropped
            if nproc > 1:
                ids = st.held_ids(sspec, spec.input_dim, state.held,
                                  state.weights.device)
                part_ids[name] = ids.cpu().numpy()
            state = st.to_logical(state, sspec, spec.input_dim)
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
    # a replicated (psum) table is written by rank 0 alone
    targets = {n: f for n, f in targets.items() if rank == 0
               or collection.sharding_spec(n).plane != "psum"}
    _sync_device(collection)
    tasks, finals = [], []
    nbytes = 0
    # the compression of every .npyz stream, spread over one pool
    pool = ThreadPoolExecutor(max_workers or _default_writers(),
                              thread_name_prefix="oe-ckpt-zlib") \
        if compress else None
    for name, fields in targets.items():
        vdir = fs.join(path, _var_dir(collection.variable_id(name), name))
        mask = live.get(name)
        rows = int(mask.sum()) if mask is not None else None
        if part:
            ts, b = (_array_part_tasks(vdir, part, fields, compress, pool,
                                       part_ids.get(name))
                     if mask is None else
                     _hash_part_tasks(vdir, part, fields, mask, rows,
                                      compress, pool))
            tasks += ts
            nbytes += b
            continue
        for fname, t in fields.items():
            npy = os.path.join(vdir, fname + ".npy")
            if mask is None:
                ts, fin, b = _array_field_tasks(npy, t)
                tasks += ts
                finals.append(fin)
            else:
                task, b = _hash_field_task(npy, t, mask, rows)
                tasks.append(task)
            nbytes += b
    try:
        _run_writers(tasks, max_workers=max_workers)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    for fin in finals:
        fin()
    # the meta commits the dump: written after every part
    _barrier(mesh, "ckpt.parts")
    if rank == 0:
        if dense_state is not None:
            with fs.open_file(fs.join(path, DENSE_FILE), "wb") as f:
                f.write(_dense_bytes(dense_state))
        with fs.open_file(fs.join(path, MODEL_META_FILE), "wb") as f:
            f.write(meta.dumps().encode("utf-8"))
        if collection.dirty_trackers and not part:
            # arm the delta chain over this base (the manifest is the
            # single commit point of the chain); a part base has no raw
            # .npy files for the compactor to fold, so it arms none
            sync_point("ckpt.full.arm")
            cd.init_manifest(path, step=step,
                             include_optimizer=include_optimizer,
                             last_seq=carried_seq, extra=extra)
    _barrier(mesh, "ckpt.meta")
    return nbytes


def _barrier(mesh, name: str) -> None:
    """Every process of ``mesh`` waits for every other; a no-op in one
    process."""
    if mesh.spans_processes:
        from . import distributed
        distributed.barrier(name)


# --- load --------------------------------------------------------------------

def _is_hash(m) -> bool:
    return m.vocabulary_size >= UNBOUNDED_VOCAB


def shard_slice_vocab(full_vocab: int, shard_index: int,
                      shard_count: int) -> int:
    """Rows owned by serving shard ``k`` of ``G``: ids ≡ k (mod G)."""
    return max(0, -(-(full_vocab - shard_index) // shard_count))


def _check_meta(path: str, collection: EmbeddingCollection,
                shard_slice: Optional[tuple] = None) -> ModelMeta:
    """Validate the dump's variable metas against the collection's, as in
    the JAX package: dim must match, the datatype may differ within
    {float32, bfloat16} (rows are cast on load), and the vocabulary may
    differ only when the table category does (a hash dump into an array
    variable or the reverse, converted on load), or, under
    ``shard_slice=(k, G)``, when an array variable holds the slice's
    :func:`shard_slice_vocab` rows."""
    with fs.open_file(fs.join(path, MODEL_META_FILE), "rb") as f:
        meta = ModelMeta.loads(f.read().decode("utf-8"))
    got_vars = {v.name: v for v in meta.variables}
    for v in collection.model_meta().variables:
        if v.name not in got_vars:
            raise ValueError(f"checkpoint at {path!r} has no variable "
                             f"{v.name!r}")
        g = got_vars[v.name].meta
        if g == v.meta:
            continue
        dtype_ok = (g.datatype == v.meta.datatype
                    or {g.datatype, v.meta.datatype}
                    <= {"float32", "bfloat16"})
        same_shape = g.embedding_dim == v.meta.embedding_dim and dtype_ok
        category_swap = _is_hash(g) != _is_hash(v.meta)
        slice_ok = (shard_slice is not None and same_shape
                    and not _is_hash(g) and not _is_hash(v.meta)
                    and v.meta.vocabulary_size == shard_slice_vocab(
                        g.vocabulary_size, *shard_slice))
        if not ((same_shape and (category_swap or g.vocabulary_size
                                 == v.meta.vocabulary_size)) or slice_ok):
            raise ValueError(f"variable {v.name!r} meta mismatch: "
                             f"checkpoint {g} vs model {v.meta}")
    return meta


class _InflatePool:
    """The executor that decompresses a load's ``.npyz`` frames ahead,
    started at the first compressed stream the load opens (``get``) and
    shut down when the load ends (``with``)."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None

    def get(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                _default_writers(), thread_name_prefix="oe-ckpt-unzlib")
        return self._pool

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class _NpyDirReader:
    """Dict-like lazy reader over one part of a ``var_*.d`` directory.

    Local ``.npy`` files open memmapped (``__getitem__``, the random-
    access load path); remote URIs and compressed ``.npyz`` files expose
    only sequential ``rows``/``chunks`` streaming, the latter inflated on
    ``inflate``'s pool. ``prefix`` selects a part (``"part0_"``); the
    empty prefix reads the local layout's unprefixed files."""

    def __init__(self, vdir: str, prefix: str, inflate: _InflatePool):
        self._vdir = vdir
        self._prefix = prefix
        self._inflate = inflate
        self._remote = fs.is_remote(vdir)
        self._suffix: Dict[str, str] = {}
        for f in fs.listdir(vdir):
            sfx = ".npy" if f.endswith(".npy") else \
                ".npyz" if f.endswith(".npyz") else None
            if sfx and f.startswith(prefix) \
                    and (prefix or not f.startswith("part")):
                self._suffix[f[len(prefix):-len(sfx)]] = sfx

    def __contains__(self, name: str) -> bool:
        return name in self._suffix

    @property
    def streaming(self) -> bool:
        """True when this part has no random-access representation
        (remote URI or compressed frames)."""
        return self._remote or ".npyz" in self._suffix.values()

    def _path(self, name: str) -> str:
        if name not in self._suffix:
            raise KeyError(name)
        return fs.join(self._vdir, self._prefix + name + self._suffix[name])

    def __getitem__(self, name: str):
        if self._remote or self._suffix.get(name) == ".npyz":
            raise TypeError(
                "remote/compressed readers stream; use rows()/chunks()")
        return np.load(self._path(name), mmap_mode="r")

    def rows(self, name: str) -> int:
        if self._suffix.get(name) == ".npyz":
            return fs.npyz_shape(self._path(name))[1][0]
        if self._remote:
            return fs.npy_shape(self._path(name))[1][0]
        return self[name].shape[0]

    def chunks(self, name: str, size: int):
        if self._suffix.get(name) == ".npyz":
            return fs.iter_npyz_chunks(self._path(name), size,
                                       pool=self._inflate.get())
        if self._remote:
            return fs.iter_npy_chunks(self._path(name), size)
        arr = self[name]
        return (arr[lo:lo + size] for lo in range(0, arr.shape[0], size))


def _reader_rows(reader, name: str) -> int:
    # a legacy npz handle has no .rows: its member decompresses whole
    return reader.rows(name) if hasattr(reader, "rows") \
        else reader[name].shape[0]


def _aligned_reader_chunks(reader, names, size: int):
    """Dicts of row-aligned chunks of several fields of one reader: the
    streams of a ``_NpyDirReader``, or slices of a legacy npz handle's
    members, each decompressed once."""
    if hasattr(reader, "chunks"):
        iters = {n: iter(reader.chunks(n, size)) for n in names}
        while True:
            out = {}
            for n in names:
                try:
                    out[n] = next(iters[n])
                except StopIteration:
                    if out:
                        raise ValueError(f"field {n} is shorter than "
                                         f"{names[0]}") from None
                    return
            yield out
    else:
        arrs = {m: reader[m] for m in names}
        for lo in range(0, arrs[names[0]].shape[0], size):
            yield {m: a[lo:lo + size] for m, a in arrs.items()}


def _open_var(path: str, vid: int, name: str,
              inflate: _InflatePool) -> list:
    """Readers of one variable: one per dump part (a dump written by N
    processes has N), one for the local layout, or the legacy npz
    handle."""
    vdir = fs.join(path, _var_dir(vid, name))
    if fs.isdir(vdir):
        prefixes = sorted({f.split("_", 1)[0] + "_"
                           for f in fs.listdir(vdir)
                           if f.startswith("part")})
        if prefixes:
            return [_NpyDirReader(vdir, p, inflate) for p in prefixes]
        return [_NpyDirReader(vdir, "", inflate)]
    legacy = fs.join(path, _var_file(vid, name))
    if fs.is_remote(legacy):
        return [np.load(fs.open_file(legacy, "rb"))]
    return [np.load(legacy)]


def _decode(block: np.ndarray, true_dtype: Optional[str],
            target: torch.dtype, legacy_dtype: Optional[str]) -> torch.Tensor:
    """One stored block as a CPU tensor of ``target``'s dtype. Opaque
    ``V2`` blocks are bfloat16 words when the recorded storage dtype (or,
    for "tpu-1" dumps without one, the target or the dump's table dtype)
    says so."""
    if block.dtype.kind == "V":
        for cand in (true_dtype, _NP_NAMES.get(target), legacy_dtype):
            if cand == "bfloat16" and block.dtype.itemsize == 2:
                return torch.from_numpy(
                    np.array(block).view(np.int16)).view(
                        torch.bfloat16).to(target)
        raise ValueError(
            f"stored void block of itemsize {block.dtype.itemsize} "
            f"matches none of (recorded={true_dtype!r}, target={target}, "
            f"dump table dtype={legacy_dtype!r})")
    return torch.from_numpy(np.array(block)).to(target)


def _deliver_rows(target: torch.Tensor, where, rows: torch.Tensor) -> None:
    """Rows of one block into ``target`` on its device: ``where`` is a
    ``slice`` (a window of logical rows) or the block's row ids (an
    ``index_copy_``). Every load of an array variable goes through it."""
    rows = rows.to(target.device, non_blocking=True)
    if isinstance(where, slice):
        target[where].copy_(rows)
    else:
        target.index_copy_(0, torch.from_numpy(where).to(target.device),
                           rows)


def _load_field(arr: np.ndarray, target: torch.Tensor,
                true_dtype: Optional[str], legacy_dtype: Optional[str],
                what: str) -> None:
    """Stream a local memmapped field into ``target`` block by block
    (rows past the end of the file keep their fill)."""
    if tuple(arr.shape[1:]) != tuple(target.shape[1:]):
        raise ValueError(f"{what}: rows of shape {arr.shape[1:]}, expected "
                         f"{tuple(target.shape[1:])}")
    rows = min(target.shape[0], arr.shape[0])
    step = _block_rows(target)
    for lo in range(0, rows, step):
        hi = min(rows, lo + step)
        _deliver_rows(target, slice(lo, hi), _decode(
            arr[lo:hi], true_dtype, target.dtype, legacy_dtype))


def _held_shards(collection: EmbeddingCollection, name: str):
    """The shards of an array variable this process holds on a mesh
    across processes (``sharded_table.local_shards``), else None."""
    if not collection.mesh.spans_processes:
        return None
    return st.local_shards(collection.mesh, collection.sharding_spec(name))


def _load_array_var_stream(readers, name: str, spec, collection,
                           with_opt: bool, stored: Dict[str, str],
                           legacy: Optional[str], from_hash: bool = False,
                           shard_slice: Optional[tuple] = None):
    """An array variable streamed from keyed parts, compressed frames, a
    remote URI, a legacy npz or (on a mesh across processes, or under a
    shard slice) the local layout, chunk by chunk through
    ``_deliver_rows``. Ids at or past the vocabulary are dropped, as in
    JAX; ``from_hash`` converts a hash dump (its keys become row ids, and
    a key outside ``[0, input_dim)`` fails the load: a conversion must
    deliver every row or fail). ``shard_slice=(k, G)`` keeps the ids ≡ k
    (mod G), id ``i`` at row ``i // G``. On a mesh across processes only
    the rows of the shards this process holds are delivered, straight
    into their stacked rows (a ``ShardedTableState``)."""
    from .table import TableState, resolve_dtype
    if from_hash and shard_slice is not None:
        raise ValueError("hash->array conversion cannot be combined with a "
                         "serving shard slice (serve hash dumps as hash)")
    vocab, dim = spec.input_dim, spec.output_dim
    dtype = resolve_dtype(spec.meta())
    held = _held_shards(collection, name)
    sspec = collection.sharding_spec(name)
    n_rows = vocab if held is None else len(held) * sspec.rows_per_shard
    weights = torch.zeros((n_rows, dim), dtype=dtype,
                          device=collection.device)
    slots = collection.optimizer(name).init_slots(n_rows, dim, dtype,
                                                  collection.device)
    targets = {"weights": weights, **{f"slot_{s}": t
                                      for s, t in slots.items()}}
    for r in readers:
        id_field = "keys" if from_hash else ("ids" if "ids" in r else None)
        fields = ["weights"] + [f for f in targets
                                if f != "weights" and with_opt and f in r]
        names = ([id_field] if id_field else []) + fields
        size = min(_LOAD_CHUNK, max(_reader_rows(r, names[0]), 1))
        offset = 0
        for chunk in _aligned_reader_chunks(r, names, size):
            if id_field:
                ids = np.asarray(chunk[id_field])
                if ids.ndim == 2:
                    ids = hash_lib.join64(ids)
                ids = ids.astype(np.int64)
                if from_hash and ids.size and (ids.min() < 0
                                               or ids.max() >= vocab):
                    bad = ids[(ids < 0) | (ids >= vocab)][0]
                    raise ValueError(
                        f"hash->array conversion of {name!r}: stored key "
                        f"{bad} is outside the bounded vocab {vocab}; a "
                        "load must deliver every row or fail")
            else:
                # a logical-order file: row i is id i
                got = chunk["weights"].shape[0]
                ids = np.arange(offset, offset + got, dtype=np.int64)
                offset += got
            if shard_slice is not None:
                k, g = shard_slice
                mine = (ids % g) == k
                ids = np.where(mine, ids // g, -1)
            keep = (ids >= 0) & (ids < vocab)
            at = ids
            if held is not None:
                # the stacked row of each id on the shards held, -1 off
                phys = sspec.physical_rows(torch.from_numpy(
                    np.where(keep, ids, 0))).numpy() \
                    - held.start * sspec.rows_per_shard
                keep &= (phys >= 0) & (phys < n_rows)
                at = phys
            for f in fields:
                block = chunk[f]
                if tuple(block.shape[1:]) != tuple(targets[f].shape[1:]):
                    raise ValueError(
                        f"{name!r} {f}: rows of shape {block.shape[1:]}, "
                        f"expected {tuple(targets[f].shape[1:])}")
                rows = _decode(block, stored.get(f), targets[f].dtype,
                               legacy)
                if not keep.all():
                    rows = rows[torch.from_numpy(keep)]
                _deliver_rows(targets[f], at[keep], rows)
    if held is None:
        return TableState(weights=weights, slots=slots)
    return st.ShardedTableState(weights=weights, slots=slots,
                                num_shards=sspec.num_shards,
                                **st.held_fields(held, sspec))


def _hash_chunk_keys(ck: np.ndarray, state, name: str,
                     from_array: bool) -> np.ndarray:
    """One chunk's dump keys (or, ``from_array``, logical row ids) in the
    table's key form: int32 ids, or ``[n, 2]`` int32 pairs on a wide
    table."""
    empty = hash_lib.empty_key(torch.int32)
    if from_array:
        ck = ck.astype(np.int64)
        if state.wide:
            # logical id i becomes the pair (lo=i, hi=0), the 64-bit key i
            return hash_lib.split64(ck)
        if ck.size and int(ck.max()) > np.iinfo(np.int32).max:
            raise ValueError(f"array->hash conversion of {name!r}: logical "
                             f"id {ck.max()} does not fit key dtype int32")
        return ck.astype(np.int32)
    if state.wide and ck.ndim == 1:
        # an int32 (or int64) dump into a wide table: narrow keys become
        # the pairs of the same 64-bit values; keys in the wide EMPTY
        # band (hi == INT32_MIN) would read as free slots
        ck = hash_lib.split64(ck.astype(np.int64))
        banded = ck[:, 1] == empty
        if banded.any():
            raise ValueError(
                f"{int(banded.sum())} dump keys of {name!r} fall in the "
                "wide-key EMPTY band (hi word == INT32_MIN, keys in "
                "[-2^63, -2^63+2^32)); the wide pair encoding excludes "
                "that range")
    elif not state.wide and ck.ndim == 2:
        # a wide dump into an int32 table: join, refuse truncation (an
        # int64 table takes the joined keys as they are)
        joined = hash_lib.join64(ck)
        if state.keys.dtype == torch.int64:
            return joined
        if joined.size and (joined.max() > np.iinfo(np.int32).max
                            or joined.min() < np.iinfo(np.int32).min):
            raise ValueError(
                f"wide-key dump of {name!r} holds keys outside the "
                "table's int32 range; load into a key_dtype='wide' "
                "variable instead")
        ck = joined.astype(np.int32)
    return ck


def _load_hash_var(readers, name: str, spec, collection, with_opt: bool,
                   stored: Dict[str, str], legacy: Optional[str], rng,
                   from_array: bool = False,
                   shard_slice: Optional[tuple] = None):
    """An empty hash table on the collection's device, filled by inserting
    every part's rows chunk by chunk; refuses a dump whose rows do not all
    fit. ``from_array`` converts an array dump (its ids, or its logical
    row order, become keys). The fresh table takes the collection's init
    key for the variable under ``rng`` (``EmbeddingCollection.
    hash_init_rng``), as JAX's loader takes ``collection.init(rng)``'s, so
    a loaded model that trains on draws JAX's init rows for keys the dump
    lacks. ``shard_slice=(k, G)`` keeps the keys whose (joined 64-bit)
    value is ≡ k (mod G), the router's owner rule. On a mesh across
    processes each process inserts the keys its own shards own."""
    state = hot_cache.unwrap(collection.init(rng, only=[name])[name])
    targets = {"weights": state.weights,
               **{f"slot_{s}": t for s, t in state.slots.items()}}
    total = 0
    for r in readers:
        id_field = ("ids" if "ids" in r else None) if from_array \
            else "keys"
        fields = ["weights"] + [f for f in targets
                                if f != "weights" and with_opt and f in r]
        names = ([id_field] if id_field else []) + fields
        n = _reader_rows(r, names[0])
        offset = 0
        for chunk in _aligned_reader_chunks(r, names,
                                            min(_LOAD_CHUNK, max(n, 1))):
            got = chunk["weights"].shape[0]
            if id_field:
                ck = np.array(chunk[id_field])
            else:
                ck = np.arange(offset, offset + got, dtype=np.int64)
                offset += got
            sel = None
            if shard_slice is not None:
                k, g = shard_slice
                ids64 = hash_lib.join64(ck) if ck.ndim == 2 \
                    else ck.astype(np.int64)
                sel = (ids64 % g) == k
                ck = ck[sel]
            total += ck.shape[0]
            ck = _hash_chunk_keys(ck, state, name, from_array)
            rows = {}
            for f in fields:
                block = chunk[f]
                if block.shape[0] != got or tuple(block.shape[1:]) \
                        != tuple(targets[f].shape[1:]):
                    raise ValueError(
                        f"{name!r} {f}: a chunk of shape {block.shape} "
                        f"does not match its {got} keys")
                if sel is not None:
                    block = block[sel]
                rows[f] = _decode(block, stored.get(f), targets[f].dtype,
                                  legacy).to(collection.device)
            weights = rows.pop("weights")
            insert = partial(sh.insert_rows_sharded, mesh=collection.mesh,
                             spec=collection.sharding_spec(name)) \
                if collection.sharded(name) else hash_lib.insert_rows
            insert(state, torch.from_numpy(ck).to(collection.device),
                   weights, {f[len("slot_"):]: v for f, v in rows.items()})
    # every process of a mesh across them sees the total
    failed = sh.total_insert_failures(
        state, collection.mesh, collection.sharding_spec(name)) \
        if collection.sharded(name) else int(state.insert_failures)
    if failed:
        raise RuntimeError(
            f"hash variable {name!r}: {failed} of {total} checkpoint rows "
            f"did not fit (hash_capacity={spec.hash_capacity}); increase "
            "hash_capacity — a load must deliver every row or fail")
    return state


def _load_var(path: str, name: str, spec, collection, meta: ModelMeta,
              with_opt: bool, inflate: _InflatePool, rng,
              shard_slice: Optional[tuple] = None):
    """One variable's state from any layout of its dump (module note), on
    the collection's shards."""
    readers = _open_var(path, collection.variable_id(name), name, inflate)
    stored = meta.extra.get("storage_dtypes", {}).get(name, {})
    dump = {v.name: v.meta for v in meta.variables}[name]
    legacy, dump_hash = dump.datatype, _is_hash(dump)
    if spec.use_hash:
        return _load_hash_var(readers, name, spec, collection, with_opt,
                              stored, legacy, rng, from_array=not dump_hash,
                              shard_slice=shard_slice)
    state = _load_array_var(readers, name, spec, collection, with_opt,
                            stored, legacy, dump_hash, shard_slice)
    if collection.sharded(name) and _held_shards(collection, name) is None:
        # the logical rows laid out on the shards (mod permutation applied)
        state = st.from_logical(state, collection.sharding_spec(name),
                                spec.input_dim, collection.optimizer(name))
    return state


def _load_array_var(readers, name: str, spec, collection, with_opt: bool,
                    stored: Dict[str, str], legacy: Optional[str],
                    dump_hash: bool, shard_slice: Optional[tuple] = None):
    """An array variable's logical rows, from any layout of its dump (on
    a mesh across processes, its shards' stacked rows)."""
    from .table import TableState, resolve_dtype
    local = readers[0]
    if dump_hash or len(readers) > 1 \
            or not isinstance(local, _NpyDirReader) \
            or local.streaming or "ids" in local \
            or shard_slice is not None \
            or _held_shards(collection, name) is not None:
        return _load_array_var_stream(readers, name, spec, collection,
                                      with_opt, stored, legacy,
                                      from_hash=dump_hash,
                                      shard_slice=shard_slice)
    device = collection.device
    dtype = resolve_dtype(spec.meta())
    weights = torch.zeros((spec.input_dim, spec.output_dim), dtype=dtype,
                          device=device)
    _load_field(local["weights"], weights, stored.get("weights"), legacy,
                f"{name!r} weights")
    slots = collection.optimizer(name).init_slots(
        spec.input_dim, spec.output_dim, dtype, device)
    for sname, tensor in slots.items():
        # absent from the dump (saved without optimizer state, or under
        # another optimizer): the slot keeps its fresh init
        if with_opt and f"slot_{sname}" in local:
            _load_field(local[f"slot_{sname}"], tensor,
                        stored.get(f"slot_{sname}"), legacy,
                        f"{name!r} slot_{sname}")
    return TableState(weights=weights, slots=slots)


def load_checkpoint(path: str, collection: EmbeddingCollection, *,
                    dense_state_template: Any = None,
                    rng=None, shard_slice: Optional[tuple] = None,
                    info: Optional[Dict[str, Any]] = None):
    """Rebuild every variable's state from ``path`` on the collection's
    device; returns ``states``, or ``(states, (params, opt_state))`` when
    ``dense_state_template`` (a ``(params, opt_state)`` pair of the
    port's, whose tensors give names, shapes and device) is given.

    A delta chain is replayed over the base (``checkpoint_delta.
    replay_chain``): committed entries checksum-verified and applied in
    order; a torn final entry is discarded whole, a torn middle one
    raises. A load that races the writer's compactor retries once when
    the manifest's ``base_id`` moved under it. ``rng``: the collection key
    whose hash init keys the loaded hash tables take (as JAX's
    ``load_checkpoint(rng=)``; None: ``prng_key(collection.seed)``).
    ``info`` (a caller's dict) receives ``applied_seq``, the chain version
    the returned states reflect, and ``resume_extra``, the ``extra``
    committed with that version, both from the verify pass the replay
    used.

    ``shard_slice=(k, G)`` loads only the rows a serving shard group's
    member ``k`` of ``G`` owns: array ids ≡ k (mod G), id ``i`` at local
    row ``i // G`` (the variable's vocabulary :func:`shard_slice_vocab`),
    hash keys whose joined 64-bit value is ≡ k (mod G), kept as they are.
    On a mesh across processes every process loads, from any layout,
    only the rows its own shards hold (every process must call it)."""
    from . import checkpoint_delta as cd
    with scope.span("checkpoint.load"):
        last_err = None
        for _attempt in range(2):
            m0 = cd.read_manifest(path)
            id0 = m0["base_id"] if m0 else None
            try:
                out = _load_checkpoint_impl(
                    path, collection,
                    dense_state_template=dense_state_template, rng=rng,
                    shard_slice=shard_slice, info=info)
            except RuntimeError as e:
                m1 = cd.read_manifest(path)
                if (m1["base_id"] if m1 else None) != id0:
                    last_err = e
                    continue
                raise
            m1 = cd.read_manifest(path)
            if (m1["base_id"] if m1 else None) == id0:
                return out
            last_err = RuntimeError("chain compacted under the load")
        raise RuntimeError(
            f"checkpoint at {path!r} kept changing under the load "
            "(background compaction); quiesce the writer or retry"
        ) from last_err


def _load_checkpoint_impl(path: str, collection: EmbeddingCollection, *,
                          dense_state_template: Any, rng,
                          shard_slice: Optional[tuple],
                          info: Optional[Dict[str, Any]]):
    from . import checkpoint_delta as cd
    meta = _check_meta(path, collection, shard_slice)
    with_opt = bool(meta.extra.get("include_optimizer", True))
    out = {}
    with _InflatePool() as inflate:
        for name, spec in collection.specs.items():
            out[name] = _load_var(path, name, spec, collection, meta,
                                  with_opt, inflate, rng, shard_slice)
    manifest = cd.read_manifest(path)
    if manifest and manifest.get("chain"):
        out = cd.replay_chain(path, collection, out, manifest=manifest,
                              with_opt=with_opt, shard_slice=shard_slice,
                              info=info)
    elif info is not None:
        # chainless: the base reflects content_seq (0 for plain dumps)
        info["applied_seq"] = cd.verified_seq(manifest, [])
        info["resume_extra"] = cd.resume_extra(manifest, [])
    # a plane's derived state comes back empty: an all-padding replica
    # (the first refresh re-admits the hot set), an empty residual
    out = {name: collection.attach_derived(name, st_)
           for name, st_ in out.items()}
    if dense_state_template is not None:
        from .utils.msgpack_state import dense_state_from_bytes
        with fs.open_file(fs.join(path, DENSE_FILE), "rb") as f:
            dense = dense_state_from_bytes(f.read(), dense_state_template)
        return out, dense
    return out


def export_dense(collection: EmbeddingCollection,
                 states: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every bounded variable as a dense ``[input_dim, dim]`` host numpy
    array (``openembedding_tpu/checkpoint.py`` ``export_dense``, the
    reference's ``save_as_original_model``): its rows in logical id
    order (a sharded table's layout undone), padding dropped, copied back
    from the device (bfloat16 tables as float32); a plane's replica or
    residual is left out. A hash variable cannot be densified and raises
    ``ValueError``, as in JAX. On a mesh across processes a process holds
    part of each table, so it raises ``ValueError``: load the dump in one
    process and export there."""
    if collection.mesh.spans_processes:
        raise ValueError("export_dense needs every row in one process; "
                         "load the dump across processes wrote in one "
                         "process and export there")
    out = {}
    for name, spec in collection.specs.items():
        if spec.use_hash:
            raise ValueError(
                f"variable {name!r} uses an unbounded hash key space and "
                "cannot be exported densely (reference rejects this too)")
        state = hot_cache.unwrap(states[name])
        if collection.sharded(name):
            state = st.to_logical(state, collection.sharding_spec(name),
                                  spec.input_dim)
        w = state.weights[:spec.input_dim]
        if w.dtype == torch.bfloat16:
            w = w.float()
        out[name] = w.to("cpu", copy=True).numpy()
    return out
