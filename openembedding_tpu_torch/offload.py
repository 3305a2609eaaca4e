"""Host-offloaded embedding tier (``openembedding_tpu/offload.py``): tables
bigger than device memory, their rows in a host store, a bounded hash
cache on the device.

The reference's Persistent-Memory tier keeps bulk rows in cheap, slow
storage, a fast cache of the working set, and checkpoints incrementally
through a per-row ``work_id`` watermark. As in JAX:

* :class:`HostOffloadedTable`: one variable, host rows and a device hash
  cache, flushed whole when full;
* :class:`ShardedOffloadedTable`: the ``Trainer``'s tier (``Trainer(
  offload=)``), at one shard or over a one-process mesh. Its cache is an
  ordinary int32-key hash table (``embedding_spec()``; on a mesh a
  ``sharded_hash`` table of ``make_hash_sharding_spec(mesh,
  cache_capacity)``, stacked shards, as JAX's) that the step pulls and
  pushes like any hash variable; the object holds the host store (numpy,
  optionally disk memmaps under ``backing_dir``) and exact ``resident`` /
  ``planned`` / ``dirty`` / ``last_touch`` books, so it knows cache
  membership without reading the device. ``host_prepare`` runs on the trainer's lookahead
  thread and ``apply_prepared`` inserts its rows before the step; an
  overflowing batch evicts the least recently touched rows (dirty rows
  written back, the survivors re-inserted); writebacks copy the cache into
  pinned host buffers and scatter them on a writer thread; ``persist``
  writes a base file and then increments, ``restore`` replays them.

The persist files are JAX's, byte for byte in layout: ``base_<w>.npz`` and
``inc_<w>.npz`` holding ``ids``, ``weights``, ``work_id`` and ``slot_*``,
under an ``offload_meta`` JSON that commits the chain, rebased past
``COMPACT_CHAIN_LEN`` entries. Each package restores the other's chain.

What differs from JAX is where the state lives. JAX's step donates the
cache and gets a new one; the port's cache is updated in place and a
captured step holds its tensors' addresses. So every host insert, the
eviction's rebuild and a restore's clear write into the same tensors, on
the current stream, ordered between two replays; the rebuild rewrites the
cache's init key (``PRNGKey(work_id)``, JAX's) in a ``[2]`` int32 device
tensor that the init-rows kernel reads at each launch, so no eviction
makes the step program stale. Writebacks enqueue their device-to-host
copies before the next replay can write the cache, and the writer thread
waits on a CUDA event, not on the device. No step reads the device: the
insert-overflow counter is read only at join points (``flush``,
``persist``, ``restore``, ``finish``, an eviction), or every
``overflow_check_every_n_batches`` batches.

On a mesh every shard's part of the cache is handled as one table: host
inserts go to each key's owner shard (``sharded_hash.insert_rows_sharded``
and its packed form), an eviction streams every shard to the host and
re-inserts the survivors the same way, and the overflow counter is the
shards' ``shard_failures``. The host books know nothing of shards, as in
JAX, so they assume one process sees the whole batch. A mesh across
processes raises (:func:`across_processes_error`), as the reference
cannot run there: JAX's writeback reads the whole sharded cache onto one
host (``np.asarray(jax.device_get(v))``, ``openembedding_tpu/offload.py``
``:614``, which JAX refuses for an array over other processes' devices,
and which every flush, eviction and persist reaches), and its books see
only the batch one process passes to ``note_update`` (``:992``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from .analysis import scope
from .analysis.concurrency import make_rlock, sync_point
from .dirty import DirtyTracker
from .embedding import EmbeddingSpec
from .meta import EmbeddingVariableMeta
from .ops.init_rows import init_flat
from .optim.initializers import Constant, fold_in, make_initializer, \
    prng_key, threefry_key
from .optim.optimizers import make_optimizer
from .utils import compress as compress_lib
from .utils import fs
from .utils.device import DeviceLike, resolve_device
from .parallel import sharded_hash as sh
from . import hash_table as hash_lib
from . import table as table_lib

OFFLOAD_META_FILE = "offload_meta"
COMPACT_CHAIN_LEN = 8   # rebase the incremental chain past this many entries
INSERT_CHUNK = 1 << 16  # rows one host insert ships at a time


# --- host arrays and device tensors ----------------------------------------

def _failures(cache) -> torch.Tensor:
    """A cache's cumulative insert-failure counter, the tensor itself
    (updated in place): one shard's scalar, or a sharded cache's
    ``shard_failures`` (summed where read)."""
    if isinstance(cache, sh.ShardedHashState):
        return cache.shard_failures
    return cache.insert_failures


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The host store's dtype for a table dtype: bfloat16 as its 16-bit
    words (numpy has no bfloat16), others as themselves."""
    if dtype == torch.bfloat16:
        return np.dtype(np.uint16)
    return torch.empty((), dtype=dtype).numpy().dtype


def _words_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor numpy can hold: bfloat16 as int16 words."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host (waits for the device), bfloat16 as
    uint16 words."""
    arr = _words_view(t).to("cpu", copy=True).numpy()
    return arr.view(np.uint16) if t.dtype == torch.bfloat16 else arr


def _to_device(arr: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A host array on ``device`` as ``dtype`` (uint16 words as bfloat16),
    copied without waiting."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype == torch.bfloat16:
        t = t.view(torch.int16)
    t = t.to(device, non_blocking=True)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _ids_tensor(ids, device: torch.device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device)
    return torch.from_numpy(np.array(ids, copy=True)).to(device)


def _host_ids(ids) -> np.ndarray:
    """A batch column as a host numpy array (a tensor is copied back)."""
    if isinstance(ids, torch.Tensor):
        return ids.detach().cpu().numpy()
    return np.asarray(ids)


def _valid_unique(ids, vocab: int) -> np.ndarray:
    ids = np.unique(_host_ids(ids).ravel())
    return ids[(ids >= 0) & (ids < vocab)]


def _draw_store(out: np.ndarray, initializer, key, device: torch.device,
                dtype: torch.dtype) -> None:
    """``out`` (host rows) := ``initializer``'s flat draw under ``key``
    (``initializer.init(key, out.shape, dtype)`` in JAX), drawn on
    ``device`` by KI's flat mode (its plain version on the CPU)."""
    t = torch.empty(out.shape, dtype=dtype, device=device)
    init_flat(t, key, 0, initializer)
    out[...] = _to_host(t)


# --- persistence (both tiers) ------------------------------------------------

def _persist_store(path: str, *, vocab: int, meta: EmbeddingVariableMeta,
                   work_id: int, persisted_work: int,
                   host_weights: np.ndarray,
                   host_slots: Dict[str, np.ndarray],
                   host_work_id: np.ndarray,
                   compress: str = "") -> Dict[str, Any]:
    """Shared base/increment writer. The first call writes every row into
    ``base_<work_id>.npz``; later calls write the rows whose watermark
    passed ``persisted_work`` into ``inc_<work_id>.npz``; past
    ``COMPACT_CHAIN_LEN`` entries a fresh base replaces the chain and the
    superseded files are deleted. The chain file and then the meta are
    each written atomically (``fs.open_atomic``); the meta's rename is the
    commit, so a kill at any instant leaves the old chain or the new one,
    and debris the next persist sweeps (``_gc_orphans``). ``compress=
    "zlib"`` writes deflated members (``np.load`` reads both)."""
    fs.makedirs(path)
    meta_path = fs.join(path, OFFLOAD_META_FILE)
    chain = []
    if fs.exists(meta_path):
        chain = fs.read_json(meta_path)["checkpoints"]
    # the persisting process is the directory's single writer: sweeping
    # here never races another writer's in-flight files
    _gc_orphans(path, chain)
    if len(chain) >= COMPACT_CHAIN_LEN:
        stale = [e["file"] for e in chain]
        chain = []
    else:
        stale = []
    savez = np.savez_compressed \
        if compress_lib.check_persist_codec(compress) else np.savez
    if not chain:
        fname = f"base_{work_id}.npz"
        with fs.open_atomic(fs.join(path, fname)) as f:
            savez(f, ids=np.arange(vocab, dtype=np.int64),
                  weights=host_weights, work_id=host_work_id,
                  **{f"slot_{k}": v for k, v in host_slots.items()})
        changed = vocab
    else:
        ids = np.nonzero(host_work_id > persisted_work)[0].astype(np.int64)
        fname = f"inc_{work_id}.npz"
        with fs.open_atomic(fs.join(path, fname)) as f:
            savez(f, ids=ids, weights=host_weights[ids],
                  work_id=host_work_id[ids],
                  **{f"slot_{k}": v[ids] for k, v in host_slots.items()})
        changed = int(ids.size)
    chain.append({"file": fname, "work_id": work_id})
    # the commit point: before this rename readers see the old chain
    fs.write_json_atomic(meta_path, {"checkpoints": chain, "vocab": vocab,
                                     "meta": meta.to_json()})
    for old in stale:
        try:
            fs.remove(fs.join(path, old))
        except OSError:
            pass
    return {"file": fname, "rows": changed}


def _gc_orphans(path: str, chain) -> int:
    """Remove chain files the committed meta does not list, and leftover
    temporary writes: the debris of a kill mid-persist."""
    live = {e["file"] for e in chain} | {OFFLOAD_META_FILE}
    n = 0
    try:
        names = fs.listdir(path)
    except OSError:  # pragma: no cover — listing is best-effort
        return 0
    for fname in names:
        orphan_chain = (fname.endswith(".npz")
                        and fname.startswith(("base_", "inc_"))
                        and fname not in live)
        if orphan_chain or fs.is_tmp_orphan(fname):
            try:
                fs.remove(fs.join(path, fname))
                n += 1
            except OSError:  # pragma: no cover
                pass
    return n


def _replay_store(path: str, *, vocab: int, host_weights: np.ndarray,
                  host_slots: Dict[str, np.ndarray],
                  host_work_id: np.ndarray) -> int:
    """Replay the committed chain, base then increments (newest wins);
    returns the highest persisted work id. Files the meta does not list
    are ignored."""
    meta = fs.read_json(fs.join(path, OFFLOAD_META_FILE))
    if int(meta["vocab"]) != vocab:
        raise ValueError(f"offload checkpoint vocab {meta['vocab']} != "
                         f"table vocab {vocab}")
    max_work = 0
    for entry in meta["checkpoints"]:
        with fs.open_file(fs.join(path, entry["file"]), "rb") as f:
            data = np.load(f)
            ids = data["ids"]
            host_weights[ids] = data["weights"]
            for sname in host_slots:
                host_slots[sname][ids] = data[f"slot_{sname}"]
            host_work_id[ids] = data["work_id"]
        max_work = max(max_work, int(entry["work_id"]))
    return max_work


def _slot_stores(optimizer, dim: int, dtype: torch.dtype, alloc):
    """The optimizer's slots as host arrays, filled with their initial
    values: ``alloc(name, shape, np dtype, fill)``."""
    return {sname: alloc(f"slot_{sname}", tuple(sshape),
                         _np_dtype(optimizer.slot_dtype(sname, dtype)),
                         optimizer.slot_init(sname))
            for sname, sshape in optimizer.slot_shapes(dim).items()}


class HostOffloadedTable:
    """One embedding variable: host rows and a device hash cache (int32
    keys), flushed whole when full. ``device``: where the cache lives (cuda
    unless named)."""

    def __init__(self, meta: EmbeddingVariableMeta, optimizer: Any,
                 initializer: Any = None, *,
                 vocab: int,
                 cache_capacity: int,
                 persist_pending_window: int = 64,
                 occupancy_threshold: float = 0.7,
                 seed: int = 0,
                 device: DeviceLike = None):
        self.meta = meta
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(optimizer)
        self.initializer = make_initializer(
            initializer or table_lib.DEFAULT_INITIALIZER)
        self.vocab = int(vocab)
        self.cache_capacity = int(cache_capacity)
        self.persist_pending_window = persist_pending_window
        self.occupancy_threshold = occupancy_threshold
        dim = meta.embedding_dim
        self.dtype = table_lib.resolve_dtype(meta)
        rng = prng_key(seed)
        # the host store, drawn whole from the seed's key as JAX draws it
        self.host_weights = np.empty((self.vocab, dim),
                                     _np_dtype(self.dtype))
        _draw_store(self.host_weights, self.initializer, rng, self.device,
                    self.dtype)
        self.host_slots = _slot_stores(
            self.optimizer, dim, self.dtype,
            lambda _n, shape, adtype, fill: np.full(
                (self.vocab,) + shape, fill, adtype))
        self.host_work_id = np.zeros(self.vocab, np.int64)
        self.work_id = 1            # current update-batch watermark
        self.persisted_work = 0     # highest watermark on disk
        self._batches_since_persist = 0
        self.cache = hash_lib.create_hash_table(
            meta, self.optimizer, capacity=self.cache_capacity,
            rng=fold_in(rng, 1), key_dtype="int32", device=self.device)

    # --- cache management ---------------------------------------------------
    def _cached_mask(self, ids: np.ndarray) -> np.ndarray:
        slots = hash_lib.find_rows(self.cache.keys,
                                   _ids_tensor(ids.astype(np.int32),
                                               self.device))
        return slots.cpu().numpy() >= 0

    def prepare(self, ids) -> None:
        """Make every (unique, valid) batch id cache-resident, flushing
        first when the incoming rows would pass the load budget."""
        ids = _valid_unique(ids, self.vocab)
        missing = ids[~self._cached_mask(ids)]
        used = self.cache.num_used()
        if used + missing.size > self.occupancy_threshold \
                * self.cache_capacity:
            self.flush()
            missing = ids  # the cache is empty now: insert the whole batch
        if missing.size == 0:
            return
        hash_lib.insert_rows(
            self.cache, _ids_tensor(missing.astype(np.int32), self.device),
            _to_device(self.host_weights[missing], self.dtype, self.device),
            {k: torch.from_numpy(v[missing]).to(self.device)
             for k, v in self.host_slots.items()})
        if int(self.cache.insert_failures) > 0:
            raise RuntimeError(
                "HBM cache insert overflow — cache_capacity too small for "
                "one batch's working set")

    def pull(self, ids) -> torch.Tensor:
        """Cache-resident lookup (call :meth:`prepare` first)."""
        return hash_lib.pull(self.cache, _ids_tensor(ids, self.device), None)

    def apply_gradients(self, ids, grads) -> None:
        """Cache-resident update; advances the work counter. Ids outside
        ``[0, vocab)`` become EMPTY (dropped), checked before any narrowing
        so that a wide id never wraps into the valid range."""
        ids = _ids_tensor(ids, self.device)
        valid = (ids >= 0) & (ids < self.vocab)
        ids = torch.where(valid, ids, 0).to(torch.int32)
        ids = torch.where(valid, ids, hash_lib.empty_key(torch.int32))
        grads = grads.to(self.device) if isinstance(grads, torch.Tensor) \
            else torch.from_numpy(np.asarray(grads)).to(self.device)
        hash_lib.apply_gradients(self.cache, self.optimizer,
                                 self.initializer, ids, grads)
        self.next_work()

    def next_work(self) -> None:
        self.work_id += 1
        self._batches_since_persist += 1

    # --- writeback / persistence -------------------------------------------
    def flush(self) -> int:
        """Write every live cache row back to the host, stamped with the
        current ``work_id``, and clear the cache."""
        keys = _to_host(self.cache.keys)
        live = keys != hash_lib.empty_key(keys.dtype)
        ids = keys[live]
        if ids.size:
            self.host_weights[ids] = _to_host(self.cache.weights)[live]
            for sname, sval in self.cache.slots.items():
                self.host_slots[sname][ids] = _to_host(sval)[live]
            self.host_work_id[ids] = self.work_id
        self.clear_cache()
        return int(ids.size)

    def clear_cache(self) -> None:
        """Drop every cache row without writeback (the restore path)."""
        self.cache.keys.fill_(hash_lib.empty_key(torch.int32))
        self.cache.insert_failures.zero_()

    @property
    def should_persist(self) -> bool:
        used = self.cache.num_used()
        return (self._batches_since_persist >= self.persist_pending_window
                or used >= self.occupancy_threshold * self.cache_capacity)

    def persist(self, path: str) -> Dict[str, Any]:
        """Incremental checkpoint: a base on the first call, increments
        afterwards."""
        self.flush()
        out = _persist_store(
            path, vocab=self.vocab, meta=self.meta, work_id=self.work_id,
            persisted_work=self.persisted_work,
            host_weights=self.host_weights, host_slots=self.host_slots,
            host_work_id=self.host_work_id)
        self.persisted_work = self.work_id
        self._batches_since_persist = 0
        return out

    def restore(self, path: str) -> None:
        """Replay base and increments; the watermark stays monotonic."""
        max_work = _replay_store(
            path, vocab=self.vocab, host_weights=self.host_weights,
            host_slots=self.host_slots, host_work_id=self.host_work_id)
        self.work_id = max(self.work_id, max_work + 1)
        self.persisted_work = max_work
        self.clear_cache()  # stale pre-restore rows must not write back


@dataclasses.dataclass
class PreparedBatch:
    """The host half of a prepare, made ahead of time on the lookahead
    thread: the batch's unique valid ids, their non-resident subset and
    its host rows. ``needs_evict``: the misses pass the cache budget, so
    the apply evicts first. ``gen``: the residency generation the
    prepare was computed against; an eviction or a restore bumps it, and a
    stale prepare is recomputed at its apply."""

    uniq: np.ndarray                      # unique valid batch ids
    missing: np.ndarray                   # the non-resident subset
    rows: Optional[np.ndarray]            # host_weights[missing]
    slot_rows: Dict[str, np.ndarray]      # host_slots[*][missing]
    needs_evict: bool = False
    gen: int = 0                          # residency generation stamp


def across_processes_error(what: str) -> NotImplementedError:
    """The refusal of an offloaded table over a mesh across processes
    (module note): the reference cannot run one there."""
    return NotImplementedError(
        f"{what} over a mesh across processes: the reference cannot run "
        "an offloaded table there (its writeback reads the whole sharded "
        "cache onto one host, openembedding_tpu/offload.py:614, and its "
        "host books see only the batch one process passes to note_update, "
        ":992); use a one-process mesh")


class ShardedOffloadedTable:
    """The ``Trainer``'s offload tier: a host store plus a device hash
    cache registered in the collection (:meth:`embedding_spec`) and kept
    in ``TrainState.emb``.

    ``mesh`` (a one-process ``parallel.mesh.Mesh``, as JAX's argument)
    shards the cache over its positions (``spec``, a
    ``HashShardingSpec``); None, or a mesh of one position, keeps the
    one-device cache. ``device`` (cuda unless named; the mesh's device on
    a mesh) is the cache's device, where the host store's initial rows
    are drawn unless the initializer is constant. A mesh across
    processes raises :func:`across_processes_error` before any work.
    Every other argument is JAX's."""

    def __init__(self, name: str, meta: EmbeddingVariableMeta,
                 optimizer: Any, initializer: Any = None, *,
                 vocab: int, cache_capacity: int, mesh=None,
                 device: DeviceLike = None,
                 persist_pending_window: int = 64,
                 occupancy_threshold: float = 0.7,
                 keep_fraction: float = 0.5,
                 backing_dir: Optional[str] = None,
                 persist_compress: str = "",
                 seed: int = 0,
                 overflow_check_every_n_batches: int = 0):
        if mesh is not None and mesh.spans_processes:
            raise across_processes_error(f"ShardedOffloadedTable {name!r}")
        self.name = name
        self.meta = meta
        self.mesh = mesh
        # the cache's layout: the collection's for a hash variable of
        # hash_capacity=cache_capacity on this mesh
        self.spec = None if mesh is None else sh.make_hash_sharding_spec(
            mesh, cache_capacity)
        self.sharded = self.spec is not None and self.spec.num_shards > 1
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.optimizer = make_optimizer(optimizer)
        self.initializer = make_initializer(
            initializer or table_lib.DEFAULT_INITIALIZER)
        self._optimizer_config = optimizer
        self._initializer_config = initializer
        self.vocab = int(vocab)
        self.cache_capacity = int(cache_capacity)
        self.persist_pending_window = persist_pending_window
        # bounded-lag overflow detection for loops that reach no join
        # point: every N batches note_update reads the counter once
        self.overflow_check_every_n_batches = int(
            overflow_check_every_n_batches)
        self._batches_since_overflow_check = 0
        self.occupancy_threshold = occupancy_threshold
        self.keep_fraction = keep_fraction
        self.persist_compress = compress_lib.check_persist_codec(
            persist_compress)
        dim = meta.embedding_dim
        self.dtype = table_lib.resolve_dtype(meta)
        npdtype = _np_dtype(self.dtype)

        def _alloc(fname, shape, adtype, fill=None):
            if backing_dir:
                os.makedirs(backing_dir, exist_ok=True)
                arr = np.lib.format.open_memmap(
                    os.path.join(backing_dir, f"{name}_{fname}.npy"),
                    mode="w+", dtype=adtype, shape=shape)
            else:
                arr = np.empty(shape, adtype)
            if fill is not None:
                arr[:] = fill
            return arr

        # the host store, drawn in bounded chunks as JAX draws it: chunk
        # [lo, hi) from fold_in(PRNGKey(seed), lo); a constant fills here
        rng = prng_key(seed)
        if isinstance(self.initializer, Constant):
            self.host_weights = _alloc("weights", (self.vocab, dim), npdtype,
                                       fill=self.initializer.value)
        else:
            self.host_weights = _alloc("weights", (self.vocab, dim), npdtype)
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            chunk = max(1, (64 << 20) // max(1, dim * itemsize))
            for lo in range(0, self.vocab, chunk):
                hi = min(self.vocab, lo + chunk)
                _draw_store(self.host_weights[lo:hi], self.initializer,
                            fold_in(rng, lo), self.device, self.dtype)
        self.host_slots: Dict[str, np.ndarray] = _slot_stores(
            self.optimizer, dim, self.dtype,
            lambda n, shape, adtype, fill: _alloc(
                n, (self.vocab,) + shape, adtype, fill))
        self.host_work_id = _alloc("work_id", (self.vocab,), np.int64, 0)

        self._resident = np.zeros(self.vocab, bool)
        self._resident_count = 0  # kept exact; vocab-sized sums are O(GB)
        # PLANNED residency: rows an in-flight PreparedBatch will insert at
        # its apply, so a K-deep prepare chain computes batch N+k's misses
        # against the residency batch N+k will find
        self._planned = np.zeros(self.vocab, bool)
        self._planned_count = 0
        self._gen = 0
        # guards the residency books and the dirty marks: host_prepare runs
        # on the trainer's lookahead thread while apply_prepared and the
        # eviction change them on the step's thread. The writer thread
        # never takes it (the eviction joins the writer while holding it)
        self._book = make_rlock(f"offload.{self.name}.book")
        self.evictions = 0  # lifetime LRU-eviction count
        # prepares and applies redone because an eviction rebuilt the
        # residency under them (the generation protocol's retries)
        self.gen_retries = 0
        self._last_touch = np.zeros(self.vocab, np.int64)
        self.work_id = 1
        self.persisted_work = 0
        self._batches_since_persist = 0
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        # rows a failed writeback left stale, re-marked dirty at the join
        # (written by the writer, read after the thread join)
        self._writer_err_dirty: Optional[np.ndarray] = None
        # the last writeback's device-to-host bytes and CUDA events
        self.writeback_bytes = 0
        self._wb_events = None
        self._dirty = DirtyTracker(self.vocab, rows_per_chunk=1,
                                   name=f"offload.{name}", lock=self._book)
        self._persister: Optional[threading.Thread] = None
        self._persister_err: Optional[BaseException] = None
        # the cumulative insert-failure counter of the cache the last host
        # insert wrote (a device tensor, read only at join points)
        self._overflow_latest: Optional[torch.Tensor] = None
        # bytes the host inserts shipped to the device, lifetime
        self.insert_bytes = 0
        from .utils import observability
        observability.register_memory_source("offload", name, self)

    def memory_stats(self) -> Dict[str, float]:
        """Host-memory gauges (``observability.memory_stats``): store bytes
        (a memmap store is flagged), book bytes and the row counters."""
        store = self.host_weights.nbytes + self.host_work_id.nbytes \
            + sum(a.nbytes for a in self.host_slots.values())
        book = self._resident.nbytes + self._planned.nbytes \
            + self._dirty.nbytes + self._last_touch.nbytes
        with self._book:
            resident = self._resident_count
            planned = self._planned_count
            evictions = self.evictions
        return {
            "store_bytes": float(store),
            "store_memmap": float(isinstance(self.host_weights, np.memmap)),
            "book_bytes": float(book),
            "resident_rows": float(resident),
            "planned_rows": float(planned),
            "cache_capacity_rows": float(self.cache_capacity),
            "evictions": float(evictions),
        }

    # --- spec / state creation ---------------------------------------------
    def embedding_spec(self, **kw) -> EmbeddingSpec:
        """The spec to register this variable under in a collection: an
        int32-key hash table (the cache) with this table's configs; any
        field may be overridden (e.g. ``name=..., output_dim=1``)."""
        base = dict(
            name=self.name, input_dim=-1, output_dim=self.meta.embedding_dim,
            dtype=self.meta.datatype, optimizer=self._optimizer_config,
            initializer=self._initializer_config,
            hash_capacity=self.cache_capacity,
            # keyed by bounded host-store row ids: int32 keys
            key_dtype="int32")
        return EmbeddingSpec(**{**base, **kw})

    def create_cache(self, rng=None):
        """An empty cache on the table's device (stacked shards on a mesh,
        a ``ShardedHashState``), its init key ``rng`` (default
        ``PRNGKey(0)``) held on the device (:meth:`adopt`)."""
        rng = prng_key(0) if rng is None else rng
        if self.sharded:
            cache = sh.create_sharded_hash_table(
                self.meta, self.optimizer, mesh=self.mesh, spec=self.spec,
                rng=rng, key_dtype="int32")
        else:
            cache = hash_lib.create_hash_table(
                self.meta, self.optimizer, capacity=self.cache_capacity,
                rng=rng, key_dtype="int32", device=self.device)
        return self.adopt(cache)

    @staticmethod
    def adopt(cache):
        """Move a cache's init key onto its device, as a ``[2]`` int32
        tensor of the key's words, in place (a no-op when it is there):
        the form an eviction can rewrite under a captured step. The
        trainer's collection creates the cache with a host key; the first
        apply adopts it, before the first step program is built."""
        if not isinstance(cache.init_rng, torch.Tensor):
            words = np.asarray(threefry_key(cache.init_rng), np.uint32)
            cache.init_rng = torch.from_numpy(words.view(np.int32)).to(
                cache.keys.device)
        return cache

    def _rebuild(self, cache, rng):
        """Empty ``cache`` in place, as ``create_cache(rng)`` makes it: keys
        EMPTY, weights zero, slots at their initial values, the failure
        count zero and the init key ``rng``. Every tensor keeps its
        address, so a captured step stays bound to it."""
        self.adopt(cache)
        cache.keys.fill_(hash_lib.empty_key(torch.int32))
        cache.weights.zero_()
        for sname, sval in cache.slots.items():
            sval.fill_(self.optimizer.slot_init(sname))
        _failures(cache).zero_()
        words = np.asarray(threefry_key(rng), np.uint32).view(np.int32)
        cache.init_rng[0].fill_(int(words[0]))
        cache.init_rng[1].fill_(int(words[1]))
        return cache

    # --- writer thread ------------------------------------------------------
    def _join_writeback(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            redo, self._writer_err_dirty = self._writer_err_dirty, None
            if redo is not None:
                # updates not written: re-mark so a later flush retries
                with self._book:
                    self._dirty.restore(redo)
            raise RuntimeError("async writeback failed") from err

    def writeback_ms(self) -> Optional[float]:
        """Device time of the last writeback's copies (CUDA events), once
        it has been joined; None on the CPU or before any writeback."""
        if self._wb_events is None:
            return None
        start, end = self._wb_events
        end.synchronize()
        return start.elapsed_time(end)

    def _start_writeback(self, cache, dirty_ids: np.ndarray) -> None:
        """Copy the cache to the host and scatter the ``dirty_ids`` rows
        into the host store on a writer thread. On CUDA the copies go into
        pinned buffers on the current stream, so they precede any later
        replay that writes the cache; the writer waits on their event."""
        self._join_writeback()
        # an async persist is reading host rows; the scatter below is the
        # only host-row writer: wait until the snapshot is on disk
        self._join_persist()
        arrays = {"keys": cache.keys, "weights": cache.weights,
                  **{f"slot_{k}": v for k, v in cache.slots.items()}}
        cuda = cache.keys.device.type == "cuda"
        arrays = {k: _words_view(v) for k, v in arrays.items()}
        event = None
        if cuda:
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in arrays.items()}
            start = torch.cuda.Event(enable_timing=True)
            event = torch.cuda.Event(enable_timing=True)
            start.record()
            for k, v in arrays.items():
                host[k].copy_(v, non_blocking=True)
            event.record()
            self._wb_events = (start, event)
        else:
            # copies of their own: the next step writes the cache in place
            host = {k: v.clone() for k, v in arrays.items()}
        self.writeback_bytes = sum(v.numel() * v.element_size()
                                   for v in arrays.values())
        work = self.work_id
        bf16 = cache.weights.dtype == torch.bfloat16

        def _run():
            try:
                sync_point("offload.writeback.run")
                with scope.span("offload.writeback", table=self.name):
                    if event is not None:
                        event.synchronize()
                    rows = {k: v.numpy() for k, v in host.items()}
                    if bf16:
                        rows["weights"] = rows["weights"].view(np.uint16)
                    keys = rows["keys"]
                    # the step inserts whatever batch keys it sees;
                    # out-of-range ids must not index the host store
                    live = (keys != hash_lib.empty_key(keys.dtype)) \
                        & (keys >= 0) & (keys < self.vocab)
                    ids = keys[live]
                    mask = np.zeros(self.vocab, bool)
                    mask[dirty_ids] = True
                    sel = mask[ids]
                    ids = ids[sel]
                    sync_point("offload.writeback.scatter")
                    if ids.size:
                        self.host_weights[ids] = rows["weights"][live][sel]
                        for sname in self.host_slots:
                            self.host_slots[sname][ids] = \
                                rows[f"slot_{sname}"][live][sel]
                        self.host_work_id[ids] = work
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                # the rows are re-marked AT THE JOIN: the writer must not
                # take _book itself
                self._writer_err_dirty = dirty_ids
                self._writer_err = e

        # clear eagerly so updates landing during the writeback re-mark
        # their rows; restored at the join on failure
        with self._book:
            self._dirty.clear_chunks(dirty_ids)
        self._writer = threading.Thread(
            target=_run, daemon=True, name=f"oe-writeback-{self.name}")
        self._writer.start()

    # --- cache management ---------------------------------------------------
    def _gather_host(self, ids: np.ndarray):
        """Host rows of ``ids``: (weights, slot rows). Pure reads, safe on
        the lookahead thread: writebacks touch dirty rows, which are
        resident, and gathers missing rows, which are not."""
        rows = self.host_weights[ids]
        srows = {k: v[ids] for k, v in self.host_slots.items()}
        return rows, srows

    def _packed_layout(self, key_dtype: np.dtype):
        """Column layout of the one-transfer insert, or None when dtypes
        rule it out (int32 keys bitcast into an f32 column; f32 weights
        and slots)."""
        if key_dtype != np.int32 \
                or self.host_weights.dtype != np.float32 \
                or any(a.dtype != np.float32
                       for a in self.host_slots.values()):
            return None
        dim = int(np.prod(self.host_weights.shape[1:], dtype=np.int64))
        col = 1 + dim
        layout = []
        for sname in sorted(self.host_slots):
            shape = tuple(self.host_slots[sname].shape[1:])
            cols = int(np.prod(shape, dtype=np.int64)) if shape else 1
            layout.append((sname, col, cols, shape))
            col += cols
        return dim, col, tuple(layout)

    def _insert_rows(self, cache, ids: np.ndarray, rows: np.ndarray,
                     slot_rows: Dict[str, np.ndarray]):
        """Device half of an insert: host rows into the cache, in place, in
        chunks of ``INSERT_CHUNK`` rows in ``ids``' order (JAX's, so the
        keys land in JAX's slots). Where dtypes allow, a chunk is one
        packed f32 buffer (keys bitcast into column 0) staged in pinned
        memory: one host-to-device copy, the keys a ``view(int32)`` of
        their column on the device. Reads nothing back."""
        packed_fmt = self._packed_layout(np.dtype(np.int32))
        dev = cache.keys.device
        pin = dev.type == "cuda"
        for lo in range(0, ids.size, INSERT_CHUNK):
            sub = ids[lo:lo + INSERT_CHUNK].astype(np.int32)
            n = sub.size
            if packed_fmt is not None:
                dim, total_cols, layout = packed_fmt
                buf = torch.empty((n, total_cols), dtype=torch.float32,
                                  pin_memory=pin)
                b = buf.numpy()
                b[:, 0] = sub.view(np.float32)
                b[:, 1:1 + dim] = rows[lo:lo + n].reshape(n, dim)
                for sname, start, cols, _shape in layout:
                    b[:, start:start + cols] = \
                        slot_rows[sname][lo:lo + n].reshape(n, cols)
                d = buf.to(dev, non_blocking=True)
                self.insert_bytes += buf.numel() * 4
                keys = d[:, 0].contiguous().view(torch.int32)
                w = d[:, 1:1 + dim]
                if self.sharded:
                    sh.insert_rows_sharded_packed(cache, d, layout,
                                                  mesh=self.mesh,
                                                  spec=self.spec)
                    continue
                srows = {sname: d[:, s:s + c].reshape((n,) + shape)
                         for sname, s, c, shape in layout}
                hash_lib.insert_rows(cache, keys, w, srows)
                continue
            keys = torch.from_numpy(sub).to(dev, non_blocking=True)
            w = _to_device(rows[lo:lo + n], self.dtype, dev)
            srows = {k: torch.from_numpy(np.ascontiguousarray(
                slot_rows[k][lo:lo + n])).to(dev, non_blocking=True)
                for k in self.host_slots}
            self.insert_bytes += sub.nbytes + rows[lo:lo + n].nbytes + sum(
                slot_rows[k][lo:lo + n].nbytes for k in self.host_slots)
            if self.sharded:
                sh.insert_rows_sharded(cache, keys, w, srows or None,
                                       mesh=self.mesh, spec=self.spec)
            else:
                hash_lib.insert_rows(cache, keys, w, srows)
        # the counter is cumulative and updated in place: keep it, and
        # read it only at a join point (check_overflow)
        self._overflow_latest = _failures(cache)
        return cache

    def check_overflow(self, cache=None) -> None:
        """Read the cache's cumulative insert-failure counter (one device
        read) and raise if any insert overflowed a probe window. A join-
        point operation: ``flush``, ``persist``, ``restore``, ``finish``,
        an eviction, or every ``overflow_check_every_n_batches`` batches.
        ``cache``: the live cache, whose counter also holds the step's own
        push failures; else the counter of the last host insert."""
        if cache is not None:
            v = _failures(cache)
        elif self._overflow_latest is not None:
            v = self._overflow_latest
        else:
            return
        overflowed = int(v.sum()) > 0   # may raise; keep v
        self._overflow_latest = None
        self._batches_since_overflow_check = 0
        if overflowed:
            raise RuntimeError(
                f"offloaded table {self.name!r}: HBM cache insert "
                "overflow — raise cache_capacity or lower "
                "occupancy_threshold")

    def _insert_from_host(self, cache, ids: np.ndarray):
        rows, srows = self._gather_host(ids)
        return self._insert_rows(cache, ids, rows, srows)

    def host_prepare(self, ids) -> PreparedBatch:
        """Host-only half of :meth:`prepare`: residency math and the host
        gather. Misses are computed against resident OR planned, and marked
        planned before returning, so a chain of prepares (run in batch
        order) sees the residency each batch finds at its apply. Every
        prepared batch must reach :meth:`apply_prepared` or
        :meth:`cancel_prepared` (cancel all outstanding ones together)."""
        ids = _valid_unique(ids, self.vocab)
        budget = int(self.occupancy_threshold * self.cache_capacity)
        while True:
            with self._book:
                gen = self._gen
                missing = ids[~(self._resident[ids] | self._planned[ids])]
                if self._resident_count + self._planned_count \
                        + missing.size > budget:
                    # the eviction rebuilds the cache (sync path); no gather
                    return PreparedBatch(uniq=ids, missing=missing,
                                         rows=None, slot_rows={},
                                         needs_evict=True, gen=gen)
            # gather OUTSIDE the lock: missing rows are neither resident
            # nor planned, so neither writeback nor eviction touches them
            rows, srows = self._gather_host(missing)
            with self._book:
                if self._gen != gen:
                    self.gen_retries += 1
                    continue  # evicted under the gather; recompute
                # mark after the gather succeeded: a failed prepare leaks
                # nothing
                self._planned[missing] = True
                self._planned_count += int(missing.size)
            return PreparedBatch(uniq=ids, missing=missing, rows=rows,
                                 slot_rows=srows, gen=gen)

    def cancel_prepared(self, prep: PreparedBatch) -> None:
        """Release a prepared batch that will never be applied."""
        with self._book:
            if prep.gen == self._gen and not prep.needs_evict:
                self._planned[prep.missing] = False
                self._planned_count -= int(prep.missing.size)

    def apply_prepared(self, cache, prep: PreparedBatch):
        """Device half: insert a prepared batch's rows into ``cache`` (in
        place; returned). Evicts first when the batch passes the budget,
        and recomputes a stale prepare (an eviction since rebuilt the
        cache)."""
        self.adopt(cache)
        with self._book:
            stale = prep.gen != self._gen
            if stale:
                # recompute in batch order: drop every planned claim, bump
                # the generation again (later prepares recompute at their
                # applies) and reclaim for this batch first, atomically
                self._gen += 1
                self._planned[:] = False
                self._planned_count = 0
                self.gen_retries += 1
                inner = self.host_prepare(prep.uniq)
                try:
                    return self.apply_prepared(cache, inner)
                except BaseException:
                    self.cancel_prepared(inner)
                    raise
        # join first: the writer may still be reading pinned copies whose
        # rows the dirty marks below must not lose
        self._join_writeback()
        # no overflow read here: the per-step path never reads the device
        self._last_touch[prep.uniq] = self.work_id
        if prep.needs_evict:
            budget = int(self.occupancy_threshold * self.cache_capacity)
            # one atomic section for evict + re-derive + mark: a lookahead
            # prepare must not plan keys this batch is about to insert
            with self._book:
                cache = self._evict(cache, protect=prep.uniq,
                                    budget=budget,
                                    incoming=prep.missing.size)
                # re-gather after the eviction made host rows current
                missing = prep.uniq[~self._resident[prep.uniq]]
                rows, slot_rows = self._gather_host(missing)
                self._resident[missing] = True
                self._resident_count += int(missing.size)
        else:
            missing, rows, slot_rows = prep.missing, prep.rows, \
                prep.slot_rows
            with self._book:
                # planned -> resident atomically
                self._resident[missing] = True
                self._resident_count += int(missing.size)
                self._planned[missing] = False
                self._planned_count -= int(missing.size)
        if missing.size == 0:
            return cache
        try:
            return self._insert_rows(cache, missing, rows, slot_rows)
        except BaseException:
            # unwind the optimistic marks so a retry finds the books as
            # they were before this apply
            with self._book:
                self._resident[missing] = False
                self._resident_count -= int(missing.size)
                if not prep.needs_evict:
                    self._planned[missing] = True
                    self._planned_count += int(missing.size)
            raise

    def prepare(self, cache, ids):
        """Make every (unique, valid) batch id cache-resident; returns the
        cache (updated in place). ``host_prepare`` then
        ``apply_prepared``."""
        return self.apply_prepared(cache, self.host_prepare(ids))

    def _evict(self, cache, protect: np.ndarray, budget: int,
               incoming: int):
        """LRU eviction: write back the dirty rows, keep the most recently
        touched survivors, rebuild the cache in place with them."""
        sync_point("offload.evict")
        with scope.span("offload.evict", table=self.name):
            self._join_writeback()
            # the rebuild zeroes the counter: read the live one first
            self.check_overflow(cache)
            resident_ids = np.nonzero(self._resident)[0]
            keep_target = max(0, min(int(self.keep_fraction * budget),
                                     budget - incoming))
            prot = np.zeros(self.vocab, bool)
            prot[protect] = True
            candidates = resident_ids[~prot[resident_ids]]
            order = np.argsort(self._last_touch[candidates], kind="stable")
            keep_protected = resident_ids[prot[resident_ids]]
            n_keep = max(0, keep_target - keep_protected.size)
            keep = np.concatenate([keep_protected,
                                   candidates[order][::-1][:n_keep]])
            # write back every dirty resident row, synchronously: the
            # rebuild below reads current host rows
            dirty_ids = resident_ids[self._dirty.mask_rows(resident_ids)]
            self._start_writeback(cache, dirty_ids)
            self._join_writeback()
            cache = self._rebuild(cache, prng_key(int(self.work_id)))
            self._resident[:] = False
            self._resident_count = 0
            # invalidate every in-flight prepare
            self._gen += 1
            self._planned[:] = False
            self._planned_count = 0
            self.evictions += 1
            if keep.size:
                cache = self._insert_from_host(cache, np.sort(keep))
                self._resident[keep] = True
                self._resident_count = int(keep.size)
            return cache

    # --- step bookkeeping ---------------------------------------------------
    def note_update(self, ids, *, uniq: Optional[np.ndarray] = None) -> None:
        """Record that a step pushed gradients for ``ids``: dirty marks and
        the watermark's advance (``uniq``: the batch's unique valid ids,
        when the caller has them). Every ``overflow_check_every_n_batches``
        calls, also read the overflow counter."""
        if uniq is None:
            uniq = _valid_unique(ids, self.vocab)
        with self._book:
            self._dirty.mark_rows(uniq)
        self.work_id += 1
        self._batches_since_persist += 1
        n = self.overflow_check_every_n_batches
        if n > 0:
            self._batches_since_overflow_check += 1
            if self._batches_since_overflow_check >= n:
                self.check_overflow()

    # --- persistence --------------------------------------------------------
    def flush(self, cache) -> int:
        """Write back every dirty row asynchronously (the cache stays).
        Raises an error a previous writeback stored."""
        with scope.span("offload.flush", table=self.name):
            self._join_writeback()
            self.check_overflow(cache)
            sync_point("offload.flush")
            with self._book:
                dirty_ids = self._dirty.dirty_chunks()
            if dirty_ids.size:
                self._start_writeback(cache, dirty_ids)
            return int(dirty_ids.size)

    @property
    def should_persist(self) -> bool:
        return (self._batches_since_persist >= self.persist_pending_window
                or self._resident_count
                >= self.occupancy_threshold * self.cache_capacity)

    def _join_persist(self) -> None:
        if self._persister is not None:
            self._persister.join()
            self._persister = None
        if self._persister_err is not None:
            err, self._persister_err = self._persister_err, None
            raise RuntimeError("async persist failed") from err

    def finish(self) -> None:
        """End-of-loop barrier: join (and raise) the writeback and the
        persist, both joined even when the first raises, then raise any
        pending insert overflow."""
        try:
            self._join_writeback()
        finally:
            self._join_persist()
        self.check_overflow()

    def persist(self, cache, path: str, *,
                blocking: bool = True) -> Dict[str, Any]:
        """Incremental checkpoint (a base on the first call, increments
        afterwards). ``blocking=False`` writes on a background thread and
        returns ``{"async": True, "work_id": w}``; its errors surface at
        the next join."""
        self.flush(cache)
        self._join_writeback()
        self._join_persist()
        work, persisted = self.work_id, self.persisted_work
        # the watermark advances optimistically; a failed write is re-
        # covered by the next persist (its rows' stamps pass the last
        # committed meta)
        self.persisted_work = self.work_id
        self._batches_since_persist = 0
        kw = dict(path=path, vocab=self.vocab, meta=self.meta, work_id=work,
                  persisted_work=persisted, host_weights=self.host_weights,
                  host_slots=self.host_slots,
                  host_work_id=self.host_work_id,
                  compress=self.persist_compress)
        if blocking:
            with scope.span("offload.persist", table=self.name):
                return _persist_store(**kw)

        def _run():
            try:
                with scope.span("offload.persist", table=self.name):
                    _persist_store(**kw)
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                self._persister_err = e
                self.persisted_work = persisted

        self._persister = threading.Thread(
            target=_run, daemon=True, name=f"oe-persist-{self.name}")
        self._persister.start()
        return {"async": True, "work_id": work}

    def restore(self, path: str, cache=None):
        """Replay base and increments into the host store; returns an
        empty cache (pre-restore rows must not write back): ``cache``
        rebuilt in place when given (its step program stays valid), else
        a new one. Raises on a pending pre-restore overflow."""
        self._join_writeback()
        self._join_persist()
        self.check_overflow()
        max_work = _replay_store(
            path, vocab=self.vocab, host_weights=self.host_weights,
            host_slots=self.host_slots, host_work_id=self.host_work_id)
        self.work_id = max(self.work_id, max_work + 1)
        self.persisted_work = max_work
        self._batches_since_persist = 0
        with self._book:
            self._resident[:] = False
            self._resident_count = 0
            self._gen += 1
            self._planned[:] = False
            self._planned_count = 0
            self._dirty.clear_all()
            self._last_touch[:] = 0
        rng = prng_key(int(self.work_id))
        if cache is None:
            return self.create_cache(rng)
        return self._rebuild(cache, rng)

