"""Serving-side model registry (``openembedding_tpu/serving/registry.py``).

Loads a checkpoint for serving, in any layout ``checkpoint.load_checkpoint``
reads (local, compressed part files, fsspec URIs, legacy ``.npz``, any
number of parts), and answers read-only lookups: models are
keyed by ``model_sign``, carry CREATING/NORMAL/DELETING/ERROR status, load
synchronously or on a thread (CREATING while it runs), and a lookup takes
one snapshot of the model's states per request. Every lookup is a pull on
the registry's device: through the CUDA row-gather kernel
(``ops/gather.py``) for an array variable, through the CUDA probe-gather
kernel (``ops/probe_gather.py``) for a hash variable, whose table the load
fills by inserting the dump's rows. Wide hash variables take ``[..., 2]``
int32 (lo, hi) pair queries or narrow ids, which the lookup widens.

A model loaded from a delta chain starts at the version its load
replayed (``applied_seq``). ``apply_delta`` hot-swaps a trainer-published
delta (``checkpoint_delta.Delta`` or its wire bytes) under version
gating: the next seq applies, a stale one is acknowledged as a no-op, a
gap raises. The patched states are built from copies of the touched
tensors (copy-on-write) and published by one reference swap under the
registry lock, so a lookup in flight keeps the snapshot it took.

Micro-batching (``enable_batching``, ``serving/batcher.py``): concurrent
flat lookups against one model coalesce into one deduplicated pull per
flush. Each flush pads its unique keys to a power-of-two bucket of at
least 64 rows, as JAX pads them for its jitted pull. On a CUDA device
each (variable, bucket, id dtype and shape) then replays one captured
CUDA graph (``ops.launches.CountedGraph``): its static id buffer is
filled by a copy, its rows sliced to the flush's keys. A captured graph
holds the addresses of the state tensors it read, and a hot-swap
publishes copies of the touched ones, so a model's graphs are bound to
the ONE states snapshot they were captured on: a flush reading another
snapshot captures anew for it and frees the old graphs (JAX's jitted
pull takes the states as arguments and never meets this). On the CPU
the bucket pull runs eagerly. ``warm_batch_programs`` captures the
ladder JAX compiles.

Shard groups (``create_model(shard_index=k, shard_count=G)``): a model
larger than one process serves from ``G`` processes, each holding the
ids or keys ≡ k (mod G) (``checkpoint.load_checkpoint(shard_slice=)``;
the reference's shard x replica placement over its parameter servers).
Lookups take global ids: an array id maps to its local row ``id // G``,
and an id or key the member does not own reads a zero row (the router,
``ha.ShardedRoutingClient``, sends each member only its own). Deltas
keep the rows the member owns. ``num_shards`` > 1 lays each table over
a one-process mesh of that many shards on the registry's device.

The registry records JAX's serving metrics: each lookup request counts
in ``record_serving_lookup`` (and ``record_batch_stats`` when the
evaluate-performance gate is on) under a ``serving.lookup`` span, and
the registry is the ``serving`` memory source (``loaded_models``,
``model_bytes``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..analysis import scope
from ..analysis.concurrency import make_lock, sync_point
from ..embedding import EmbeddingCollection, EmbeddingSpec
from ..meta import ModelMeta, ModelStatus, UNBOUNDED_VOCAB
from ..parallel import hot_cache
from ..utils import fs
from ..utils.device import DeviceLike, resolve_device

MIN_BUCKET = 64         # the smallest flush bucket, as in JAX


def bucket_rows(n: int) -> int:
    """The flush bucket of ``n`` unique keys: the next power of two, at
    least :data:`MIN_BUCKET`."""
    return 1 << max(MIN_BUCKET.bit_length() - 1, (n - 1).bit_length())


def _host_view(indices) -> np.ndarray:
    """A query as a host numpy array (a tensor copied to the host)."""
    if isinstance(indices, torch.Tensor):
        return indices.detach().cpu().numpy()
    return np.asarray(indices)


def _num_elements(indices) -> int:
    if isinstance(indices, torch.Tensor):
        return int(indices.numel())
    return int(np.asarray(indices).size)


def _tensors(obj):
    """Every tensor of a table state (weights, slots, keys, counters)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


class _BucketGraphs:
    """The captured bucket pulls of one model on ONE states snapshot.

    One ``CountedGraph`` per (variable, id dtype, id shape), all captured
    into one memory pool and replayed one at a time under the owner's
    lock (their static buffers, and the pool's scratch, are shared).
    ``build_s`` sums the captures' seconds, ``pool_bytes`` the memory they
    reserved."""

    def __init__(self, collection: EmbeddingCollection,
                 states: Dict[str, Any], map_ids):
        self.collection = collection
        self.states = states
        # the shard slice's global-to-local id map (ServingModel.map_ids)
        self.map_ids = map_ids
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Tuple, Tuple[Any, torch.Tensor, torch.Tensor]] = {}
        self.build_s = 0.0
        self.pool_bytes = 0

    def _fn(self, name: str, ids: torch.Tensor):
        coll, states = self.collection, self.states

        def fn():
            rows = coll.pull(states, {name: self.map_ids(name, ids)},
                             batch_sharded=False, read_only=True,
                             serving_rows=True)[name]
            return rows.to(torch.float32)
        return fn

    def _build(self, key, name: str, host: torch.Tensor) -> np.ndarray:
        """Capture the pull of ``host``'s shape: one eager run on a side
        stream first (every kernel's first launch happens outside the
        capture), whose rows answer this call. The ``CountedGraph``
        captures on a side stream of its own with ``thread_local`` error
        mode, so other threads go on launching."""
        from ..ops.launches import CountedGraph
        t0 = time.perf_counter()
        dev = self.collection.device
        ids = torch.empty(host.shape, dtype=host.dtype, device=dev)
        ids.copy_(host, non_blocking=True)
        fn = self._fn(name, ids)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = fn()
        main.wait_stream(side)
        first.record_stream(main)
        graph = CountedGraph()
        with graph.capture(pool=self.pool):
            # inside the capture: entering it empties the allocator's cache
            reserved = torch.cuda.memory_reserved(dev)
            out = fn()
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.graphs[key] = (graph, ids, out)
        rows = first.cpu().numpy()
        self.build_s += time.perf_counter() - t0
        return rows

    def pull(self, name: str, host: torch.Tensor) -> np.ndarray:
        """Float32 host rows of the host ids ``host`` (a whole bucket)."""
        key = (name, host.dtype, tuple(host.shape))
        entry = self.graphs.get(key)
        if entry is None:
            return self._build(key, name, host)
        graph, ids, out = entry
        ids.copy_(host, non_blocking=True)
        graph.replay()
        # the copy to the host waits for the replay, so the static
        # buffers are free again when it returns
        return out.cpu().numpy()

    def release(self) -> None:
        """Free the graphs once the device has finished with them."""
        torch.cuda.synchronize(self.collection.device)
        self.graphs.clear()


class ServingModel:
    """One loaded model: collection + read-only states.

    ``shard_slice=(k, G)`` marks a shard-group member, holding the ids or
    keys ≡ k (mod G); lookups take global ids (:meth:`map_ids`)."""

    def __init__(self, sign: str, collection: EmbeddingCollection,
                 states: Dict[str, Any], meta: ModelMeta, version: int = 0,
                 shard_slice: Optional[Tuple[int, int]] = None):
        self.sign = sign
        self.collection = collection
        self.states = states
        self.meta = meta
        self.shard_slice = tuple(shard_slice) if shard_slice else None
        self.version = int(version)
        # serializes hot-swaps of this model (the version check and the
        # build); lookups never take it
        self.swap_lock = make_lock(f"serving.swap.{sign}")
        # the captured bucket pulls (CUDA only) of one states snapshot,
        # and the lock that serializes their captures and replays
        self._graphs: Optional[_BucketGraphs] = None
        self._graph_lock = make_lock(f"serving.graphs.{sign}")
        self._by_id = {collection.variable_id(name): name
                       for name in collection.specs}

    def variable_name(self, variable_id: int) -> str:
        return self._by_id[variable_id]

    def _name(self, variable: Any) -> str:
        name = (variable if isinstance(variable, str)
                else self._by_id[int(variable)])
        if name not in self.collection.specs:
            raise KeyError(f"model {self.sign!r} has no variable {name!r}")
        return name

    def export_rows(self, variable: Any, offset: int, limit: int):
        """Page through this replica's live rows: ``(ids, rows, total)``.

        The peer restore's reader (JAX ``ServingModel.export_rows``): a
        respawned replica pages ``offset`` from 0 to ``total`` on a living
        peer and rebuilds its state from the pages alone. ``ids`` are
        int64 (a wide key travels joined), ``rows`` a CPU tensor in the
        table's dtype. A hash variable pages its slots (``total`` is the
        capacity; free slots are skipped), an array variable its rows."""
        name = self._name(variable)
        spec = self.collection.specs[name]
        state = hot_cache.unwrap(self.states[name])
        if spec.use_hash:
            from .. import hash_table as hash_lib
            total = int(state.keys.shape[0])
            hi = min(offset + limit, total)
            keys = state.keys[offset:hi].cpu().numpy()
            empty = hash_lib.empty_key(torch.int32)
            if keys.ndim == 2:
                live = keys[:, 1] != empty
                ids = hash_lib.join64(keys[live])
            else:
                live = keys != empty
                ids = keys[live].astype(np.int64)
            rows = state.weights[offset:hi].cpu()[torch.from_numpy(live)]
            return ids, rows, total
        total = int(spec.input_dim)
        hi = min(offset + limit, total)
        ids = np.arange(offset, hi, dtype=np.int64)
        rows = state.weights[offset:hi].cpu()
        if self.shard_slice is not None:
            # local row l holds global id l * G + k
            k, g = self.shard_slice
            ids = ids * g + k
        return ids, rows, total

    def map_ids(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        """A lookup's global ids (placed, pair-widened) in this member's
        id space: on a shard slice ``(k, G)`` an owned array id ``i``
        becomes its local row ``i // G``, an owned hash key stays as it
        is, and what the member does not own becomes invalid (``-1``, or
        an EMPTY key or pair, masked whole): a zero row. The owner rule
        is ``id % G`` on the joined 64-bit value, the loader's and the
        router's. Without a slice the ids pass."""
        if self.shard_slice is None:
            return idx
        k, g = self.shard_slice
        spec = self.collection.specs[name]
        if not spec.use_hash:
            return torch.where(idx % g == k, torch.div(
                idx, g, rounding_mode="floor"), torch.full_like(idx, -1))
        from .. import hash_table as hash_lib
        empty = hash_lib.empty_key(idx.dtype)
        if spec.key_dtype == "wide":
            if idx.dim() < 1 or idx.shape[-1] != 2:
                raise ValueError(
                    f"variable {name!r} takes [..., 2] int32 pair queries "
                    f"(hash_table.split64), got shape {tuple(idx.shape)}")
            owned = hash_lib.pair_mod(idx, g) == k
            return torch.where(owned[..., None], idx,
                               torch.full_like(idx, empty))
        return torch.where(idx.to(torch.int64) % g == k, idx,
                           torch.full_like(idx, empty))

    def lookup(self, variable: Any, indices) -> torch.Tensor:
        """Read-only pull for one variable (by name or variable_id), on the
        model's device: zero rows for ids outside ``[0, input_dim)`` and
        for hash keys the table does not hold.

        The JAX registry's shape contract, which reads the sequence axis,
        never the pooled spec's training rule:

        - a flat query (narrow ``[n]`` ids, or ``[n, 2]`` pairs on a wide
          hash variable) returns one row per id, never pooled;
        - a sequence query on a pooled variable (``[B, L]``, or ``[B, L,
          2]`` pairs on a wide one) returns the pooled ``[B, dim]`` rows.

        On a wide variable any trailing dim of 2 is a pair axis, so a
        narrow ``[B, 2]`` sequence reads as ``B`` pairs: send such
        sequences padded to another length, or as ``[B, 2, 2]`` pairs."""
        name = self._name(variable)
        # ONE reference grab = one consistent version of the states: a
        # hot-swap publishes a new dict and never mutates this one
        states = self.states
        sync_point("serving.lookup.snapshot")
        return self._lookup_impl(name, indices, states)

    def batchable(self, variable: Any, indices) -> Optional[str]:
        """The variable NAME when this query can ride the micro-batcher
        (a flat row query: narrow ``[n]`` integer ids, or ``[n, 2]``
        int32 pairs on a wide hash variable), else None: sequence and
        pooled queries take the direct path, since batching concatenates
        key streams."""
        name = (variable if isinstance(variable, str)
                else self._by_id.get(int(variable)))
        if name is None or name not in self.collection.specs:
            return None
        spec = self.collection.specs[name]
        idx = np.asarray(indices)
        if not np.issubdtype(idx.dtype, np.integer):
            return None
        if idx.ndim == 1:
            return name
        if idx.ndim == 2 and idx.shape[-1] == 2 and spec.use_hash \
                and spec.key_dtype == "wide" and idx.dtype == np.int32:
            return name
        return None

    def _lookup_impl(self, name: str, indices, states,
                     record: bool = True, span: bool = True
                     ) -> torch.Tensor:
        """The pull against an explicit states snapshot, shared by the
        direct path (one snapshot a lookup) and the bucket pulls (one a
        flush). ``record=False`` where the batcher already recorded each
        request at its offer; ``span=False`` keeps warm-up pulls out of
        the ``serving.lookup`` histogram."""
        from ..utils import observability
        if record:
            observability.record_serving_lookup(name, _num_elements(indices))
            if observability.evaluate_performance():
                observability.record_batch_stats(
                    {name: _host_view(indices)})
        spec = self.collection.specs[name]
        idx = self.collection.to_device(name, indices, pair_ndim=2)
        seq_ndim = 3 if spec.use_hash and spec.key_dtype == "wide" else 2
        as_rows = spec.pooling is None or idx.dim() < seq_ndim
        ctx = (scope.span("serving.lookup", table=name) if span
               else contextlib.nullcontext())
        with ctx:
            rows = self.collection.pull(states,
                                        {name: self.map_ids(name, idx)},
                                        batch_sharded=False, read_only=True,
                                        serving_rows=as_rows)
        return rows[name]

    def pull_bucket(self, name: str, keys: np.ndarray, states, *,
                    span: bool = True) -> np.ndarray:
        """Float32 host rows of a flush's unique ``keys`` against the
        snapshot ``states``: the keys padded to their bucket
        (:func:`bucket_rows`) by repeating the last, pulled (one captured
        graph's replay on CUDA, eagerly on the CPU), the pad rows sliced
        off. Records no lookup (the batcher recorded each request)."""
        n = int(keys.shape[0])
        if n:
            cap = bucket_rows(n)
            if cap != n:
                keys = np.concatenate(
                    [keys, np.repeat(keys[-1:], cap - n, axis=0)])
        if n == 0 or self.collection.device.type != "cuda":
            rows = self._lookup_impl(name, keys, states, record=False,
                                     span=span)
            return rows.to(torch.float32).cpu().numpy()[:n]
        host = self.collection.host_ids(name, keys, pair_ndim=2)
        ctx = (scope.span("serving.lookup", table=name) if span
               else contextlib.nullcontext())
        with ctx, self._graph_lock:
            graphs = self._graphs
            if graphs is None or graphs.states is not states:
                # captured on another snapshot: its graphs read tensors
                # a hot-swap may have replaced
                if graphs is not None:
                    graphs.release()
                graphs = self._graphs = _BucketGraphs(self.collection,
                                                      states, self.map_ids)
            rows = graphs.pull(name, host)
        return rows[:n]

    def graph_reading(self) -> Dict[str, float]:
        """The captured bucket pulls of the current snapshot: their count,
        build seconds and pool bytes (all 0 without captures)."""
        with self._graph_lock:
            g = self._graphs
            if g is None:
                return {"graphs": 0, "build_s": 0.0, "pool_bytes": 0}
            return {"graphs": len(g.graphs), "build_s": g.build_s,
                    "pool_bytes": g.pool_bytes}

    def release_graphs(self) -> None:
        """Free the captured bucket pulls (a retired model's)."""
        with self._graph_lock:
            if self._graphs is not None:
                self._graphs.release()
                self._graphs = None


def _specs_from_meta(meta: ModelMeta, hash_capacity: int,
                     num_shards: int = -1,
                     shard_slice: Optional[Tuple[int, int]] = None
                     ) -> List[EmbeddingSpec]:
    """Rebuild EmbeddingSpecs from a checkpoint's model_meta alone, with
    the stateless ``default`` optimizer (serving allocates and loads no
    slot tensors) and the combiners of ``variable_pooling``. Hash capacity and key dtype come from the meta's
    ``hash_variables`` extra where the dump recorded them, else
    ``hash_capacity`` and ``"int32"``, as in the JAX registry. A shard
    slice ``(k, G)`` shrinks an array vocabulary to the slice's rows
    (``checkpoint.shard_slice_vocab``) and a hash capacity to its share
    (``ceil(capacity / G)``)."""
    hash_info = meta.extra.get("hash_variables", {})
    poolings = meta.extra.get("variable_pooling", {})
    specs = []
    for v in sorted(meta.variables, key=lambda v: v.variable_id):
        hash_var = v.meta.vocabulary_size >= UNBOUNDED_VOCAB
        info = hash_info.get(v.name, {})
        vocab = v.meta.vocabulary_size
        cap = int(info.get("hash_capacity", hash_capacity))
        if shard_slice is not None:
            k, g = shard_slice
            vocab = ckpt_lib.shard_slice_vocab(vocab, k, g)
            cap = max(1, -(-cap // g))
        specs.append(EmbeddingSpec(
            name=v.name, input_dim=-1 if hash_var else vocab,
            output_dim=v.meta.embedding_dim, dtype=v.meta.datatype,
            optimizer={"category": "default"},
            hash_capacity=cap,
            key_dtype=info.get("key_dtype", "int32"),
            num_shards=num_shards,
            pooling=poolings.get(v.name)))
    return specs


class ModelRegistry:
    """All models served by this process, on one device (cuda unless the
    caller names another). ``default_hash_capacity`` sizes the hash tables
    of a dump that did not record its own."""

    def __init__(self, device: DeviceLike = None, *,
                 default_hash_capacity: int = 2**20):
        self.device = resolve_device(device)
        self.default_hash_capacity = default_hash_capacity
        self._lock = make_lock("serving.registry")
        self._models: Dict[str, ServingModel] = {}
        self._status: Dict[str, Dict[str, Any]] = {}
        # async create_model load threads, joined by close()
        self._loaders: Dict[str, threading.Thread] = {}
        # micro-batching: enable_batching arms the config; each model's
        # batcher is made at its first batched lookup and drained at
        # delete/close; with an online plan each batcher gets a tuner
        self._batch_cfg: Optional[Dict[str, Any]] = None
        self._batchers: Dict[str, Any] = {}
        self._batch_plan: Optional[Any] = None
        self._tuners: Dict[str, Any] = {}
        from ..utils import observability
        observability.register_memory_source("serving", "registry", self)

    def memory_stats(self) -> Dict[str, float]:
        """The ``serving`` memory gauges: the loaded models and the bytes
        of their state tensors."""
        with self._lock:
            models = list(self._models.values())
        total = sum(int(t.numel()) * t.element_size()
                    for m in models for st in m.states.values()
                    for t in _tensors(st))
        return {"loaded_models": float(len(models)),
                "model_bytes": float(total)}

    def create_model(self, model_uri: str, *,
                     model_sign: Optional[str] = None,
                     replica_num: int = 3, num_shards: int = -1,
                     shard_index: int = 0, shard_count: int = 1,
                     block: bool = True) -> str:
        """Load a checkpoint for serving; returns the model_sign. With
        ``block=False`` the load runs on a thread and the status is
        CREATING until it ends in NORMAL or ERROR. ``shard_count`` > 1
        loads only this process's shard slice, the ids or keys ≡
        ``shard_index`` (mod ``shard_count``), so a model larger than one
        process serves from a shard group (module note). ``num_shards``
        > 1 lays the tables over a one-process mesh of that many shards
        (-1 and 1: one)."""
        if shard_count < 1 or not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        if num_shards == 0 or num_shards < -1:
            raise ValueError(f"num_shards={num_shards}")
        shard_slice = (shard_index, shard_count) if shard_count > 1 \
            else None
        with fs.open_file(fs.join(model_uri, ckpt_lib.MODEL_META_FILE),
                          "rb") as f:
            meta = ModelMeta.loads(f.read().decode("utf-8"))
        sign = model_sign or meta.model_sign or model_uri
        with self._lock:
            if sign in self._status and self._status[sign][
                    "model_status"] == ModelStatus.CREATING:
                raise ValueError(f"model {sign!r} is already being created")
            self._status[sign] = {
                "model_sign": sign, "model_uri": model_uri,
                "model_status": ModelStatus.CREATING, "model_error": "",
                "replica_num": replica_num,
                "shard_index": shard_index, "shard_count": shard_count,
            }

        def _load():
            try:
                sync_point("registry.load.start")
                with scope.span("registry.load", detail={"sign": sign}):
                    coll = self._collection(meta, num_shards, shard_slice)
                    # the hot-swap version is the chain seq THIS load
                    # replayed, as the load reports it: a separate read
                    # could see a delta committed after the replay
                    load_info: Dict[str, Any] = {}
                    states = ckpt_lib.load_checkpoint(
                        model_uri, coll, shard_slice=shard_slice,
                        info=load_info)
                    if self.device.type == "cuda":
                        # a failed copy must surface here, as an ERROR
                        # status, not under the first lookup
                        torch.cuda.synchronize(self.device)
                    model = ServingModel(
                        sign, coll, states, meta,
                        version=int(load_info.get("applied_seq", 0)),
                        shard_slice=shard_slice)
                sync_point("registry.load.commit")
                with self._lock:
                    replaced = self._models.get(sign)
                    self._models[sign] = model
                    self._status[sign]["model_status"] = ModelStatus.NORMAL
                    self._status[sign]["version"] = model.version
                # a same-sign reload replaced the model: drain the batcher
                # bound to the old one (keep_model spares a batcher a
                # racing lookup already bound to the new one)
                self._close_batchers([sign], keep_model=model)
                if replaced is not None:
                    replaced.release_graphs()
            except Exception as e:  # noqa: BLE001 — recorded as ERROR status
                with self._lock:
                    self._status[sign]["model_status"] = ModelStatus.ERROR
                    self._status[sign]["model_error"] = (
                        f"{e}\n{traceback.format_exc()}")
            finally:
                me = threading.current_thread()
                with self._lock:
                    if self._loaders.get(sign) is me:
                        del self._loaders[sign]

        if block:
            _load()
            with self._lock:
                status = dict(self._status[sign])
            if status["model_status"] == ModelStatus.ERROR:
                raise RuntimeError(status["model_error"])
        else:
            t = threading.Thread(target=_load, daemon=True,
                                 name=f"oe-model-load-{sign}")
            with self._lock:
                self._loaders[sign] = t
                t.start()
        return sign

    def _collection(self, meta: ModelMeta, num_shards: int = -1,
                    shard_slice: Optional[Tuple[int, int]] = None
                    ) -> EmbeddingCollection:
        """The serving collection of a dump's meta: on the registry's
        device, or over a one-process mesh of ``num_shards`` shards."""
        from ..parallel.mesh import create_mesh
        specs = _specs_from_meta(meta, self.default_hash_capacity,
                                 num_shards if num_shards > 1 else -1,
                                 shard_slice)
        if num_shards > 1:
            return EmbeddingCollection(
                specs, create_mesh(1, num_shards, device=self.device))
        return EmbeddingCollection(specs, device=self.device)

    # --- micro-batched lookups (serving/batcher.py) ------------------------
    def enable_batching(self, *, max_batch_rows: int = 0,
                        max_wait_us: Optional[int] = None,
                        max_queue_rows: int = 0,
                        timeout: float = 30.0,
                        plan: Optional[Any] = None) -> None:
        """Arm the micro-batching lookup scheduler: concurrent flat
        lookups against one model coalesce into one deduplicated pull a
        flush, with responses bit-identical to unbatched lookups. Zero or
        None keeps a knob's default (``batcher.knob_defaults``); an
        explicit ``max_wait_us=0`` flushes at once. ``plan`` (an
        ``envconfig.PlanConfig``) with its ``online`` switch set gives
        every batcher an :class:`batcher.AdaptiveBatchTuner`."""
        from . import batcher as batcher_mod
        defaults = batcher_mod.knob_defaults()
        cfg = {"max_batch_rows": max_batch_rows
               or defaults["max_batch_rows"],
               "max_wait_us": defaults["max_wait_us"]
               if max_wait_us is None else max_wait_us,
               "max_queue_rows": max_queue_rows
               or defaults["max_queue_rows"],
               "timeout": timeout}
        with self._lock:
            self._batch_cfg = cfg
            self._batch_plan = plan

    @property
    def batching_enabled(self) -> bool:
        with self._lock:
            return self._batch_cfg is not None

    def _batcher_for(self, sign: str, model: ServingModel):
        """This sign's batcher, made at first use and bound to ONE
        ServingModel object: a same-sign replacement (create_model or
        register_model) gets a fresh batcher and the stale one is drained.
        None when batching is off or the model is no longer live."""
        from . import batcher as batcher_mod
        stale = None
        stale_tuner = None
        try:
            with self._lock:
                entry = self._batchers.get(sign)
                if entry is not None:
                    if entry[0] is model:
                        return entry[1]
                    stale = self._batchers.pop(sign)[1]
                    stale_tuner = self._tuners.pop(sign, None)
                if self._batch_cfg is None \
                        or self._models.get(sign) is not model:
                    return None
                b = self._make_batcher(sign, model, self._batch_cfg)
                self._batchers[sign] = (model, b)
                if self._batch_plan is not None \
                        and getattr(self._batch_plan, "online", False):
                    self._tuners[sign] = batcher_mod.AdaptiveBatchTuner(
                        b, self._batch_plan)
                return b
        finally:
            if stale_tuner is not None:
                stale_tuner.stop(restore=False)
            if stale is not None:
                # outside the registry lock: the drain flush pulls
                stale.close()

    def _make_batcher(self, sign: str, model: ServingModel, cfg):
        from . import batcher as batcher_mod

        def _snap(model=model):
            # the flush's one reference grab
            return model.states

        def _pull(states, name, uniq, model=model):
            return model.pull_bucket(name, uniq, states)

        return batcher_mod.LookupBatcher(sign, _snap, _pull, **cfg)

    def warm_batch_programs(self, *, dtypes=("int32", "int64")) -> int:
        """Build every bucket pull the NORMAL models' flushes can run
        (each power-of-two bucket from 64 up to ``max_batch_rows``, or the
        plan's ``rows_ceiling`` in online mode, for each id dtype and,
        on a wide hash variable, for int32 pairs), so the first storm
        meets no capture. On CUDA each is a captured graph (an int64
        narrow query of a wide variable shares its pairs' graph);
        on the CPU each runs once eagerly. Returns the count JAX's
        registry returns for the same model. No-op unless batching is
        armed."""
        with self._lock:
            cfg = self._batch_cfg
            plan = self._batch_plan
            models = list(self._models.values())
        if cfg is None:
            return 0
        warm_rows = cfg["max_batch_rows"]
        if plan is not None and getattr(plan, "online", False):
            warm_rows = max(warm_rows, plan.rows_ceiling)
        n = 0
        for model in models:
            states = model.states
            for name, spec in model.collection.specs.items():
                wide = spec.use_hash and spec.key_dtype == "wide"
                cap = MIN_BUCKET
                while True:
                    for dt in dtypes:
                        model.pull_bucket(name, np.zeros(cap, np.dtype(dt)),
                                          states, span=False)
                        n += 1
                    if wide:
                        model.pull_bucket(name, np.zeros((cap, 2), np.int32),
                                          states, span=False)
                        n += 1
                    if cap >= warm_rows:
                        break
                    cap <<= 1
        return n

    def lookup(self, sign: str, variable: Any, indices):
        """Serve one lookup against a NORMAL model: micro-batched (host
        float32 rows) when batching is armed and the query is flat and no
        larger than the batcher's live row cap, else direct (rows on the
        device). Raises ``batcher.BusyError`` when the bounded queue
        refuses the offer (REST answers 429)."""
        model = self.find_model(sign)
        with self._lock:
            cfg = self._batch_cfg
        if cfg is not None and not isinstance(indices, torch.Tensor):
            idx = np.asarray(indices)
            name = model.batchable(variable, idx)
            if name is not None:
                b = self._batcher_for(sign, model)
                if b is not None and int(idx.shape[0]) <= b.max_batch_rows:
                    return b.lookup(name, idx)
            indices = idx
        return model.lookup(variable, indices)

    def _close_batchers(self, signs=None, keep_model=None) -> None:
        """Drain and drop batchers (``signs``, or all). ``keep_model``
        spares a batcher already bound to that model object."""
        with self._lock:
            if signs is None:
                entries, self._batchers = list(self._batchers.values()), {}
                tuners, self._tuners = list(self._tuners.values()), {}
            else:
                entries = []
                tuners = []
                for s in signs:
                    entry = self._batchers.get(s)
                    if entry is None or entry[0] is keep_model:
                        continue
                    entries.append(self._batchers.pop(s))
                    t = self._tuners.pop(s, None)
                    if t is not None:
                        tuners.append(t)
        for t in tuners:
            t.stop(restore=False)
        for _model, b in entries:
            # outside the registry lock: a drain flush pulls
            b.close()

    def register_model(self, model: ServingModel, *,
                       replica_num: int = 3) -> str:
        """Install an externally assembled model (the peer restore: its
        states were streamed from a living replica, not a dump)."""
        k, g = model.shard_slice or (0, 1)
        with self._lock:
            self._models[model.sign] = model
            self._status[model.sign] = {
                "model_sign": model.sign,
                "model_uri": model.meta.model_uri or "",
                "model_status": ModelStatus.NORMAL, "model_error": "",
                "replica_num": replica_num,
                "shard_index": k, "shard_count": g,
                "version": model.version,
            }
        self._close_batchers([model.sign], keep_model=model)
        return model.sign

    def apply_delta(self, sign: str, delta) -> Dict[str, Any]:
        """Hot-swap a loaded model's rows from a trainer-published delta
        (``checkpoint_delta.Delta`` or its ``encode_delta`` bytes; garbage
        bytes raise ``DeltaDecodeError``, a ``ValueError``).

        Version-gated: the delta's ``seq`` must be ``model.version + 1``;
        a stale seq is acknowledged as a no-op (``applied: False``), a gap
        raises ``RuntimeError``. The new states are built from copies of
        the touched variables' tensors (``apply_delta_to_states(donate=
        False)``; a hash insert draws no init rows) and published by one
        swap under the registry lock: lookups in flight keep their
        snapshot, later ones see the new version whole."""
        from .. import checkpoint_delta as cd
        from ..utils import observability
        if isinstance(delta, (bytes, bytearray)):
            delta = cd.decode_delta(bytes(delta))
        model = self.find_model(sign)
        with model.swap_lock:
            if delta.seq <= model.version:
                return {"applied": False, "version": model.version,
                        "reason": f"stale delta seq {delta.seq}"}
            if delta.seq != model.version + 1:
                raise RuntimeError(
                    f"model {sign!r} is at version {model.version}; "
                    f"delta seq {delta.seq} leaves a gap — apply the "
                    "chain in order (read_deltas_since) or reload")
            sync_point("registry.swap.build")
            with scope.span("registry.apply_delta",
                            detail={"sign": sign, "seq": delta.seq}):
                new_states = cd.apply_delta_to_states(
                    model.collection, model.states, delta.vars,
                    with_opt=False, donate=False,
                    shard_slice=model.shard_slice)
                if self.device.type == "cuda":
                    # apply errors surface here, not under a reader
                    torch.cuda.synchronize(self.device)
            sync_point("registry.swap.commit")
            with self._lock:
                model.states = new_states
                model.version = int(delta.seq)
                if sign in self._status:
                    self._status[sign]["version"] = model.version
        observability.record_swap(delta.rows, delta.seq)
        return {"applied": True, "version": int(delta.seq),
                "rows": int(delta.rows)}

    def join_loads(self, timeout: float = 60.0) -> None:
        with self._lock:
            loaders, self._loaders = dict(self._loaders), {}
        for t in loaders.values():
            t.join(timeout)

    def close(self, timeout: float = 60.0) -> None:
        """Join outstanding async loads and drain every batcher (accepted
        requests get their response, later offers are refused); batching
        disarms, so a straggler cannot start a flusher again."""
        self.join_loads(timeout)
        with self._lock:
            self._batch_cfg = None
            self._batch_plan = None
        self._close_batchers()

    def delete_model(self, sign: str) -> None:
        with self._lock:
            if sign not in self._status:
                raise KeyError(sign)
            self._status[sign]["model_status"] = ModelStatus.DELETING
            model = self._models.pop(sign, None)
            del self._status[sign]
        # in-flight flushes finish against their snapshot; new offers
        # are refused
        self._close_batchers([sign])
        if model is not None:
            model.release_graphs()

    def find_model(self, sign: str) -> ServingModel:
        """NORMAL-status model, KeyError when unknown, RuntimeError while
        it is CREATING or after a failed load."""
        sync_point("registry.find")
        with self._lock:
            st = self._status.get(sign)
            if st is None:
                raise KeyError(f"unknown model {sign!r}")
            if st["model_status"] != ModelStatus.NORMAL:
                raise RuntimeError(
                    f"model {sign!r} is {st['model_status']}: "
                    f"{st.get('model_error', '')}")
            return self._models[sign]

    def show_model(self, sign: str) -> Dict[str, Any]:
        with self._lock:
            if sign not in self._status:
                raise KeyError(sign)
            return dict(self._status[sign])

    def show_models(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._status.values()]

    # --- nodes: the device this registry serves on -------------------------
    def show_nodes(self) -> List[Dict[str, Any]]:
        """The registry's device as the JAX registry lists its mesh's:
        ``{"node_id", "platform", "kind"}`` (``gpu`` and the card's name
        on CUDA, ``cpu`` twice on the CPU, as JAX's CPU devices read)."""
        if self.device.type == "cuda":
            index = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            return [{"node_id": int(index), "platform": "gpu",
                     "kind": torch.cuda.get_device_name(index)}]
        return [{"node_id": 0, "platform": self.device.type,
                 "kind": self.device.type}]
