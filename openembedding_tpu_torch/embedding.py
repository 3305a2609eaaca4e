"""Embedding specs and a collection of tables over a mesh
(``openembedding_tpu/embedding.py``).

``EmbeddingSpec`` keeps the JAX package's fields and validation, so a
model's spec list reads the same in both packages. ``EmbeddingCollection``
is the JAX collection over a one-process mesh (``parallel/mesh.py``; a
``device`` means its 1 x 1 mesh): variable ids by registration order,
the same ``model_meta`` JSON, ``init`` and ``pull``, for array tables and
for hash tables (``input_dim=-1``) with ``"wide"`` pair keys, ``"int32"``
or ``"int64"`` keys, and ``apply_gradients`` (the push) for both. A
variable of one shard is the single-device table (``table.py``,
``hash_table.py``); more shards, on the ``"a2a"`` or ``"psum"`` plane in
either layout, go to ``parallel/sharded_table.py`` and
``parallel/sharded_hash.py``, with JAX's shard counts and per-shard init
keys. A hash pull gives a missing key its deterministic init row (zero
rows under ``read_only``, the serving contract) and the push inserts it.
``enable_dirty_tracking`` arms one chunk bitmap per variable
(``dirty.py``) for delta checkpoints: ``apply_gradients`` marks the
chunks its ids touch, and the ``Trainer`` marks each step's host batch.
A pooled spec (``pooling="sum" | "mean" | "sqrtn"``) takes padded ``[B,
L]`` id matrices (``[B, L, 2]`` pairs on a wide hash variable): the pull
pools its rows to ``[B, dim]`` and the push expands the pooled gradient
back (``ragged.py``). Every plane of JAX's spec runs on a mesh: ``a2a``
and ``psum``, ``a2a+cache`` (a hot-row replica beside the table,
``parallel/hot_cache.py``; its state a ``CachedState``), ``a2a+grouped``
(one exchange a group of tables, ``parallel/grouped.py``),
``a2a+pipelined`` (the ``Trainer``'s double-buffered schedule,
``parallel/pipelined.py``), and the compressed wires of a ``+bf16`` or
``+int8`` suffix (``parallel/precision.py``; an int8_ef variable's state
an ``EFState``). On a mesh across processes
(``distributed.create_global_mesh``) the collection holds this process's
shards and ``pull``/``apply_gradients`` take this process's slice of the
batch (``batch_sharded``: the global batch is the processes' slices in
rank order), on every plane: ``a2a`` (``+bf16``, ``+int8``), ``psum``,
``a2a+cache``, ``a2a+grouped``, ``a2a+pipelined`` and
``a2a+grouped+pipelined``. Dirty tracking marks logical rows and keys on
every plane.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .meta import (UNBOUNDED_VOCAB, EmbeddingVariableMeta, ModelMeta,
                   ModelVariableMeta)
from .optim.initializers import (fold_in, make_initializer, prng_key,
                                 threefry_key)
from .optim.optimizers import make_optimizer
from . import hash_table as hash_lib
from . import ragged
from . import table as table_lib
from .parallel import hot_cache
from .parallel import precision
from .parallel import sharded_hash as sh
from .parallel import sharded_table as st
from .parallel.mesh import Mesh, single_device_mesh
from .utils.device import DeviceLike

POOLINGS = ragged.POOLINGS
_LAYOUTS = ("mod", "div")


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one embedding variable (the JAX package's
    ``EmbeddingSpec``, same fields and defaults)."""

    name: str
    input_dim: int                   # -1 => unbounded hash-key space
    output_dim: int
    dtype: str = "float32"
    optimizer: Any = None            # None => collection default
    initializer: Any = None          # None => collection default
    num_shards: int = -1             # -1 => one shard per device
    hash_capacity: int = 2**20
    layout: str = "mod"
    key_dtype: Optional[str] = None  # None resolves to "wide" for hash
    plane: str = "a2a"
    a2a_capacity: int = 0
    a2a_slack: float = 2.0
    cache_k: int = 0
    exchange_precision: str = "f32"
    push_precision: str = "f32"
    cache_refresh_every: int = 64
    cache_decay: float = 0.8
    pooling: Optional[str] = None

    def __post_init__(self):
        if self.key_dtype is None:
            object.__setattr__(self, "key_dtype",
                               "wide" if self.input_dim == -1 else "int32")
        if self.pooling is not None and self.pooling not in POOLINGS:
            raise ValueError(
                f"embedding {self.name!r}: unknown pooling "
                f"{self.pooling!r}; known: {POOLINGS}")
        if self.layout not in _LAYOUTS:
            raise ValueError(f"embedding {self.name!r}: unknown layout "
                             f"{self.layout!r}; known: {_LAYOUTS}")
        if self.use_hash and self.key_dtype not in hash_lib.KEY_DTYPES:
            raise ValueError(f"embedding {self.name!r}: unknown key_dtype "
                             f"{self.key_dtype!r}; known: "
                             f"{hash_lib.KEY_DTYPES}")
        # a "+bf16"/"+int8" suffix is shorthand for the precision rungs:
        # the spec's plane names the base plane, as in JAX
        if precision.parse_plane(self.plane)[0] not in st.PLANES:
            raise ValueError(f"embedding {self.name!r}: unknown plane "
                             f"{self.plane!r}; known: "
                             f"{st.PLANES} (+bf16 or +int8)")
        try:
            base, ep, pp = precision.resolve_precision(
                self.plane, self.exchange_precision, self.push_precision)
        except ValueError as e:
            raise ValueError(f"embedding {self.name!r}: {e}") from None
        object.__setattr__(self, "plane", base)
        object.__setattr__(self, "exchange_precision", ep)
        object.__setattr__(self, "push_precision", pp)

    @property
    def use_hash(self) -> bool:
        return self.input_dim == -1

    def meta(self) -> EmbeddingVariableMeta:
        vocab = UNBOUNDED_VOCAB if self.use_hash else self.input_dim
        return EmbeddingVariableMeta(datatype=self.dtype,
                                     embedding_dim=self.output_dim,
                                     vocabulary_size=vocab)


class EmbeddingCollection:
    """All sparse variables of one model, sharded over one mesh.

    ``mesh``: a ``parallel.mesh.Mesh``, or a device (cuda unless named;
    ``device=`` too) for its 1 x 1 mesh. ``states`` (from :meth:`init` or
    ``checkpoint.load_checkpoint``) is a plain dict ``name -> state``: a
    ``TableState``/``HashTableState`` for a one-shard variable, a
    ``ShardedTableState``/``ShardedHashState`` otherwise. A spec without
    an optimizer gets ``default_optimizer``, ``{"category": "sgd",
    "learning_rate": 0.01}`` unless given, as in the JAX collection.
    """

    def __init__(self, specs, mesh: Any = None,
                 default_optimizer: Any = None,
                 default_initializer: Any = None,
                 seed: int = 0, *, device: DeviceLike = None):
        if not isinstance(mesh, Mesh):
            if mesh is not None and device is not None:
                raise ValueError("pass a mesh or a device, not both")
            mesh = single_device_mesh(mesh if mesh is not None else device)
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both")
        self.mesh = mesh
        self.device = mesh.device
        self.seed = int(seed)
        if default_optimizer is None:
            default_optimizer = {"category": "sgd", "learning_rate": 0.01}
        if default_initializer is None:
            default_initializer = dict(table_lib.DEFAULT_INITIALIZER)
        self.specs: Dict[str, EmbeddingSpec] = {}
        self._variable_ids: Dict[str, int] = {}
        self._optimizers = {}
        self._initializers = {}
        self._shardings: Dict[str, Any] = {}
        self._dirty_trackers: Dict[str, Any] = {}
        for i, spec in enumerate(specs):
            if spec.name in self.specs:
                raise ValueError(f"duplicate embedding name {spec.name!r}")
            self.specs[spec.name] = spec
            self._variable_ids[spec.name] = i
            self._optimizers[spec.name] = make_optimizer(
                spec.optimizer if spec.optimizer is not None
                else default_optimizer)
            self._initializers[spec.name] = make_initializer(
                spec.initializer if spec.initializer is not None
                else default_initializer)
            if spec.use_hash:
                self._shardings[spec.name] = sh.make_hash_sharding_spec(
                    mesh, total_capacity=spec.hash_capacity,
                    num_shards=spec.num_shards, plane=spec.plane,
                    a2a_capacity=spec.a2a_capacity,
                    a2a_slack=spec.a2a_slack,
                    key_width=64 if spec.key_dtype == "wide" else 32,
                    cache_k=spec.cache_k,
                    exchange_precision=spec.exchange_precision,
                    push_precision=spec.push_precision)
            else:
                self._shardings[spec.name] = st.make_sharding_spec(
                    spec.meta(), mesh, num_shards=spec.num_shards,
                    layout=spec.layout, plane=spec.plane,
                    a2a_capacity=spec.a2a_capacity,
                    a2a_slack=spec.a2a_slack, cache_k=spec.cache_k,
                    exchange_precision=spec.exchange_precision,
                    push_precision=spec.push_precision)

    # --- introspection -----------------------------------------------------
    def sharding_spec(self, name: str):
        """The ``ShardingSpec``/``HashShardingSpec`` of variable ``name``."""
        return self._shardings[name]

    def sharded(self, name: str) -> bool:
        """Whether variable ``name`` runs the mesh's planes (its table a
        ``parallel`` one): more than one shard, or the cached plane, which
        JAX routes at any shard count; any other one-shard variable is the
        single-device table, JAX's one-shard program. On a mesh across
        processes every variable is (a one-shard ``psum`` table is then a
        replica a process, its pushes gathered over the processes)."""
        ss = self._shardings[name]
        return ss.num_shards > 1 or ss.is_cached \
            or self.mesh.spans_processes

    # the plane lists below depend on the specs and the mesh's shape
    # alone, so every process of a mesh across processes has the same
    def cached_names(self) -> tuple:
        """Variables on the ``"a2a+cache"`` plane (hot-row replica)."""
        return tuple(n for n, s in self._shardings.items() if s.is_cached)

    def grouped_names(self) -> tuple:
        """Variables on a grouped plane (``parallel/grouped.py``); one of
        one shard is the single-device table and exchanges nothing."""
        return tuple(n for n, s in self._shardings.items()
                     if s.is_grouped and self.sharded(n))

    def pipelined_names(self) -> tuple:
        """Variables on a pipelined plane (the ``Trainer``'s
        double-buffered schedule, ``parallel/pipelined.py``)."""
        return tuple(n for n, s in self._shardings.items()
                     if s.is_pipelined)

    def make_hot_cache_manager(self, name: str):
        """The admission and refresh driver of one cached variable (the
        ``Trainer`` makes one for each ``"a2a+cache"`` variable)."""
        spec = self.specs[name]
        sspec = self._shardings[name]
        if not sspec.is_cached:
            raise ValueError(f"{name!r} is not on the a2a+cache plane")
        return hot_cache.HotCacheManager(
            spec=sspec, k=sspec.cache_k,
            refresh_every=spec.cache_refresh_every,
            decay=spec.cache_decay, name=name, mesh=self.mesh)

    def attach_derived(self, name: str, table_state):
        """The derived state a plane keeps beside a bare table (JAX's
        ``wrap_hot_cache``, which attaches both): an empty
        (all-padding) replica on ``"a2a+cache"``, an empty int8_ef
        residual (``precision.EFState``) on an int8_ef variable of more
        than one shard; else the table as it is. ``init``, the checkpoint
        loaders and serving use it: both wrappers are derived, never
        saved (a restore forfeits at most one step of feedback)."""
        sspec = self._shardings[name]
        if sspec.is_int8_ef and sspec.num_shards > 1 \
                and not isinstance(table_state, precision.EFState):
            spec = self.specs[name]
            wide = spec.use_hash and spec.key_dtype == "wide"
            sentinel, key_dtype = precision.ef_key_space(
                use_hash=spec.use_hash, wide=wide,
                key_dtype=None if wide or not spec.use_hash
                else spec.key_dtype)
            return precision.empty_ef(table_state, dim=spec.output_dim,
                                      wide=wide, sentinel=sentinel,
                                      key_dtype=key_dtype)
        return hot_cache.attach_empty(table_state, sspec)

    def size_ef(self, states: Dict[str, Any], inputs: Dict[str, Any], *,
                batch_sharded: bool = True) -> None:
        """Size every int8_ef variable's residual for the batch ``inputs``
        in place (``precision.ensure_ef``), before a step program is
        built: its first push then reuses the buffers, which a captured
        graph must keep (a fresh buffer's sentinels and zeros are the
        values the push would size it to)."""
        for name, idx in inputs.items():
            sspec = self._shardings.get(name)
            state = states.get(name)
            if sspec is None or not isinstance(state, precision.EFState):
                continue
            spec = self.specs[name]
            wide = spec.use_hash and spec.key_dtype == "wide"
            # keys a push sees: one a pair on a wide variable
            shape = tuple(np.shape(idx))
            n = int(np.prod(shape))
            if wide and len(shape) >= self._pair_ndim(spec, None) \
                    and shape[-1] == 2:
                n //= 2
            sentinel, key_dtype = precision.ef_key_space(
                use_hash=spec.use_hash, wide=wide,
                key_dtype=None if wide or not spec.use_hash
                else spec.key_dtype)
            precision.ensure_ef(
                state, dim=spec.output_dim, wide=wide, sentinel=sentinel,
                n_flat=n, data=self.mesh.shape[sspec.data_axis],
                model=self.mesh.shape[sspec.model_axis],
                batch_sharded=batch_sharded, key_dtype=key_dtype)

    @property
    def num_shards(self) -> int:
        """The most shards of any variable (the meta's ``num_shards``)."""
        return max((s.num_shards for s in self._shardings.values()),
                   default=1)

    def state_shardings(self) -> Dict[str, Dict[str, tuple]]:
        """Each variable's state fields and the mesh axes their rows are
        sharded over (JAX's NamedShardings, as axis tuples): ``()`` for a
        replicated field such as a hash table's init key."""
        out = {}
        for name, spec in self.specs.items():
            axes = tuple(self._shardings[name].shard_axes) \
                if self.sharded(name) else ()
            fields = {"weights": axes,
                      **{f"slots/{k}": axes for k in
                         self._optimizers[name].slot_shapes(
                             spec.output_dim)}}
            if spec.use_hash:
                fields.update({"keys": axes, "init_rng": (),
                               "insert_failures": axes})
            sspec = self._shardings[name]
            if sspec.is_cached:
                # the replica is whole on every device
                fields.update({"cache/keys": (), "cache/rows": (),
                               **{f"cache/slots/{k}": () for k in
                                  self._optimizers[name].slot_shapes(
                                      spec.output_dim)}})
            elif sspec.is_int8_ef and sspec.num_shards > 1:
                # each sender's residual block on its own position
                fields.update({"ef/keys": axes, "ef/resid": axes})
            out[name] = fields
        return out
    def variable_id(self, name: str) -> int:
        return self._variable_ids[name]

    def optimizer(self, name: str):
        return self._optimizers[name]

    def initializer(self, name: str):
        return self._initializers[name]

    def model_meta(self, model_sign: str = "",
                   model_uri: str = "") -> ModelMeta:
        variables = [
            ModelVariableMeta(meta=self.specs[name].meta(),
                              variable_id=self._variable_ids[name],
                              name=name)
            for name in self.specs
        ]
        variables.sort(key=lambda v: v.variable_id)
        meta = ModelMeta(model_sign=model_sign, model_uri=model_uri,
                         variables=variables, num_shards=self.num_shards)
        meta.extra["variable_num_shards"] = {
            name: s.num_shards for name, s in self._shardings.items()}
        poolings = {name: s.pooling for name, s in self.specs.items()
                    if s.pooling}
        if poolings:
            # serving rebuilds its specs from the meta alone, combiners too
            meta.extra["variable_pooling"] = poolings
        return meta

    # --- dirty tracking (delta checkpoints) ---------------------------------
    def enable_dirty_tracking(self, *, target_chunks: int = 1024,
                              names=None) -> None:
        """Arm chunk-level dirty bitmaps for every variable (idempotent),
        or for the variables in ``names`` (an unknown name raises
        ``ValueError``): about ``target_chunks`` chunks of contiguous
        LOGICAL rows an array variable, ``min(target_chunks,
        hash_capacity)`` key chunks a hash variable, as in JAX, whatever
        the variable's shards, layout or plane (a sharded variable's
        chunks name logical rows and keys, never stacked shard rows).
        Required before ``checkpoint.save_checkpoint(mode="delta")``,
        which writes only the marked chunks. A delta save writes tracked
        variables only: an untracked variable that trains reverts to its
        base rows on a restore, so ``names`` is for variables whose rows
        persist another way (an offloaded table's cache, which
        ``ShardedOffloadedTable.persist`` owns). A loop that runs its own
        pushes without :meth:`apply_gradients` must call
        :meth:`mark_dirty` with each step's ids, as
        ``Trainer.train_step`` does."""
        from .dirty import make_array_tracker, make_hash_tracker
        if names is not None:
            unknown = set(names) - set(self.specs)
            if unknown:
                raise ValueError(
                    f"enable_dirty_tracking: unknown variable(s) "
                    f"{sorted(unknown)}; known: {sorted(self.specs)}")
        for name, spec in self.specs.items():
            if name in self._dirty_trackers:
                continue
            if names is not None and name not in names:
                continue
            if spec.use_hash:
                self._dirty_trackers[name] = make_hash_tracker(
                    name, spec.hash_capacity, target_chunks)
            else:
                self._dirty_trackers[name] = make_array_tracker(
                    name, spec.input_dim, target_chunks)

    @property
    def dirty_trackers(self) -> Dict[str, Any]:
        """``name -> DirtyTracker`` (empty unless tracking is enabled)."""
        return self._dirty_trackers

    def mark_dirty(self, sparse_inputs: Dict[str, Any]) -> None:
        """Mark the chunks a batch's pushes touch, from its ids (numpy
        arrays or tensors; a no-op unless tracking is enabled). Over-
        marking is safe. Hash keys are the joined 64-bit values of wide
        pairs (``hash_table.join64``) or the ids themselves; array ids
        outside ``[0, input_dim)`` are dropped. Ids on a CUDA device are
        read back (a synchronization); nothing is marked while a CUDA
        graph is captured, where the push runs once per capture, not
        once per replay: the ``Trainer`` marks its host batch after each
        step instead."""
        if not self._dirty_trackers:
            return
        for name, idx in sparse_inputs.items():
            tracker = self._dirty_trackers.get(name)
            if tracker is None or idx is None:
                continue
            if isinstance(idx, torch.Tensor):
                if idx.is_cuda and torch.cuda.is_current_stream_capturing():
                    continue
                idx = idx.detach().cpu().numpy()
            arr = np.asarray(idx)
            spec = self.specs[name]
            if spec.use_hash:
                if spec.key_dtype == "wide" and arr.ndim >= 2 \
                        and arr.shape[-1] == 2:
                    keys = hash_lib.join64(arr.reshape(-1, 2))
                else:
                    keys = arr.astype(np.int64).ravel()
                tracker.mark_keys(keys)
            else:
                ids = arr.astype(np.int64).ravel()
                tracker.mark_rows(ids[(ids >= 0) & (ids < spec.input_dim)])

    # --- state lifecycle ---------------------------------------------------
    def variable_key(self, name: str, rng=None) -> Tuple[int, int]:
        """The threefry key of variable ``name`` under the collection key
        ``rng`` (None: ``PRNGKey(seed)``): ``fold_in(rng, variable_id)``,
        the JAX collection's rule. A hash variable keeps it as its init
        key (one for all shards); an array table draws from
        :meth:`table_key`."""
        rng = prng_key(self.seed) if rng is None else threefry_key(rng)
        return fold_in(rng, self._variable_ids[name])

    def table_key(self, name: str, rng=None) -> Tuple[int, int]:
        """The key array variable ``name``'s weights are drawn from:
        :meth:`variable_key` folded with shard 0, as the JAX collection's
        one-shard table draws (``parallel/sharded_table.py``)."""
        return fold_in(self.variable_key(name, rng), 0)

    def hash_init_rng(self, name: str, rng=None) -> Tuple[int, int]:
        """The threefry key of hash variable ``name``'s init rows
        (:meth:`variable_key`), so a port collection initialized with
        ``rng`` draws the rows of JAX's ``collection.init(rng)``."""
        return self.variable_key(name, rng)

    def init(self, rng=None, only: Optional[Any] = None) -> Dict[str, Any]:
        """Materialize every variable (``only`` restricts to some names),
        with JAX's signature and keys: ``rng`` is a threefry key (two
        uint32 words, ``prng_key(seed)``; None: ``prng_key(self.seed)``).
        Array tables draw from :meth:`table_key`, the same values on every
        device and as JAX's ``collection.init(rng)`` on one shard; a
        sharded one draws shard ``s`` from ``fold_in(variable_key, s)``,
        as JAX's does on the same mesh. Hash variables start empty,
        ``round_capacity(hash_capacity)`` slots (``round_capacity(ceil(
        hash_capacity / S))`` a shard), with :meth:`hash_init_rng` as
        their init key. A plane's derived state wraps the table
        (:meth:`attach_derived`)."""
        states = self._init_tables(rng, only)
        return {name: self.attach_derived(name, st_)
                for name, st_ in states.items()}

    def _init_tables(self, rng, only) -> Dict[str, Any]:
        states = {}
        for name, spec in self.specs.items():
            if only is not None and name not in only:
                continue
            if self.sharded(name):
                sspec = self._shardings[name]
                if spec.use_hash:
                    states[name] = sh.create_sharded_hash_table(
                        spec.meta(), self._optimizers[name], mesh=self.mesh,
                        spec=sspec, rng=self.hash_init_rng(name, rng),
                        key_dtype=spec.key_dtype)
                else:
                    states[name] = st.create_sharded_table(
                        spec.meta(), self._optimizers[name],
                        self._initializers[name], mesh=self.mesh,
                        spec=sspec, rng=self.variable_key(name, rng))
                continue
            if spec.use_hash:
                states[name] = hash_lib.create_hash_table(
                    spec.meta(), self._optimizers[name],
                    capacity=spec.hash_capacity,
                    rng=self.hash_init_rng(name, rng),
                    key_dtype=spec.key_dtype, device=self.device)
                continue
            states[name] = table_lib.create_table(
                spec.meta(), self._optimizers[name],
                self._initializers[name], rng=self.table_key(name, rng),
                device=self.device)
        return states

    # --- data plane --------------------------------------------------------
    def pull(self, states: Dict[str, Any], inputs: Dict[str, Any], *,
             batch_sharded: bool = True, read_only: bool = False,
             serving_rows: bool = False) -> Dict[str, torch.Tensor]:
        """Rows for every input column: ``name -> rows``, shaped
        ``indices.shape + (dim,)`` (``indices.shape[:-1] + (dim,)`` for
        pair keys on a wide hash variable); a pooled variable's ``[B, L]``
        sequences (``[B, L, 2]`` pairs) pool to ``[B, dim]``.

        Inputs are integer tensors or numpy arrays of any shape; they move
        to the collection's device. A hash variable gives a missing key
        its deterministic init row, or a zero row under ``read_only`` (the
        serving contract). ``serving_rows`` selects the serving plane's
        row contract, as in JAX: one row per id, no pooling, and any
        trailing dim of 2 on a wide variable is a pair axis.
        ``batch_sharded``: a sharded variable's batch is split over the
        data axis (the training path) or replicated, as in JAX; the rows
        are the same.
        """
        pair_ndim = 2 if serving_rows else None
        placed = {name: self.to_device(name, idx, pair_ndim)
                  for name, idx in inputs.items()}
        # grouped columns: one exchange a group (parallel/grouped.py); the
        # raw rows pool below like any other
        grouped_idx = {n: placed[n] for n in self.grouped_names()
                       if n in placed}
        raw = {}
        if grouped_idx:
            from .parallel import grouped
            raw = grouped.pull_grouped(self, states, grouped_idx,
                                       read_only=read_only,
                                       batch_sharded=batch_sharded)
        rows = {}
        for name, idx in placed.items():
            spec = self.specs[name]
            if name in raw:
                r = raw[name]
            elif self.sharded(name):
                sspec = self._shardings[name]
                if spec.use_hash:
                    r = sh.pull_sharded(
                        states[name], idx,
                        None if read_only else self._initializers[name],
                        mesh=self.mesh, spec=sspec,
                        batch_sharded=batch_sharded)
                else:
                    r = st.pull_sharded(states[name], idx, mesh=self.mesh,
                                        spec=sspec,
                                        batch_sharded=batch_sharded)
            elif spec.use_hash:
                r = hash_lib.pull(
                    states[name], idx,
                    None if read_only else self._initializers[name])
            else:
                r = table_lib.pull(states[name], idx)
            if spec.pooling and not serving_rows:
                r = self._pool(spec, r, idx)
            rows[name] = r
        return rows

    def _pool_args(self, spec: EmbeddingSpec) -> dict:
        """``ragged.pool_rows``' key-space arguments for a pooled spec."""
        return {"pad_id": ragged.pad_id_for(spec),
                "vocab": None if spec.use_hash else spec.input_dim,
                "wide": spec.use_hash and spec.key_dtype == "wide"}

    def _pool(self, spec: EmbeddingSpec, rows: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
        return ragged.pool_rows(rows, idx, spec.pooling,
                                **self._pool_args(spec))

    def apply_gradients(self, states: Dict[str, Any],
                        inputs: Dict[str, Any],
                        row_grads: Dict[str, torch.Tensor], *,
                        batch_sharded: bool = True,
                        mark: bool = True) -> Dict[str, Any]:
        """Push and update every column present in ``row_grads``, in place.

        ``row_grads[name]`` has the shape of the pulled rows and
        ``inputs[name]`` the ids they were pulled for; grouped variables
        push one exchange a group (``parallel/grouped.py``); a pooled
        variable's ``[B, dim]`` gradient is expanded over its sequence
        slots first
        (``ragged.expand_pooled_grads``; padding slots hold invalid ids,
        which the push drops). Array tables run ``table.apply_gradients``
        (dedup, combine, update the touched rows and slots, scatter back),
        hash tables ``hash_table.apply_gradients`` (the same, inserting
        missing keys with their init rows); the other variables' states
        are not touched. Returns ``states``. With dirty tracking armed the
        push marks its ids' chunks first (:meth:`mark_dirty`); ``mark=
        False`` leaves that to the caller (the ``Trainer``'s step, which
        marks its host batch outside the step program, as JAX marks
        outside its jit). A sharded variable pushes through its plane
        (``batch_sharded`` as in :meth:`pull`).
        """
        if mark:
            self.mark_dirty({n: inputs.get(n) for n in row_grads})
        grouped = set(self.grouped_names())
        grouped_idx, grouped_grads = {}, {}
        for name, g in row_grads.items():
            spec = self.specs[name]
            idx = self.to_device(name, inputs[name])
            if spec.pooling:
                g = ragged.expand_pooled_grads(g, idx, spec.pooling,
                                               **self._pool_args(spec))
            if name in grouped:
                grouped_idx[name], grouped_grads[name] = idx, g
            elif self.sharded(name):
                sspec = self._shardings[name]
                if spec.use_hash:
                    states[name] = sh.apply_gradients_sharded(
                        states[name], self._optimizers[name],
                        self._initializers[name], idx, g, mesh=self.mesh,
                        spec=sspec, batch_sharded=batch_sharded)
                else:
                    states[name] = st.apply_gradients_sharded(
                        states[name], self._optimizers[name], idx, g,
                        mesh=self.mesh, spec=sspec,
                        batch_sharded=batch_sharded)
            elif spec.use_hash:
                hash_lib.apply_gradients(states[name], self._optimizers[name],
                                         self._initializers[name], idx, g)
            else:
                table_lib.apply_gradients(states[name],
                                          self._optimizers[name], idx, g)
        if grouped_idx:
            from .parallel import grouped as grouped_lib
            grouped_lib.apply_gradients_grouped(
                self, states, grouped_idx, grouped_grads,
                batch_sharded=batch_sharded)
        return states

    def host_ids(self, name: str, idx,
                 pair_ndim: Optional[int] = None) -> torch.Tensor:
        """Input column ``name`` as an integer tensor where it lies (a host
        array becomes a CPU tensor of its own), host int64 ids of a hash
        variable widened on the host (:meth:`_widen`). The host's half of
        :meth:`to_device`."""
        spec = self.specs[name]
        idx = self._widen(spec, idx, pair_ndim)
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.array(idx, copy=True))
        if idx.dtype.is_floating_point or idx.dtype == torch.bool:
            raise TypeError(f"{spec.name!r}: indices must be integers, got "
                            f"{idx.dtype}")
        return idx

    def to_device(self, name: str, idx,
                  pair_ndim: Optional[int] = None) -> torch.Tensor:
        """Input column ``name`` as an integer tensor on the collection's
        device (a copy that does not wait for the device), pair-widened
        for a wide hash variable. ``pair_ndim``: as in :meth:`_widen`."""
        spec = self.specs[name]
        idx = self.host_ids(name, idx, pair_ndim).to(self.device,
                                                     non_blocking=True)
        if spec.use_hash and spec.key_dtype == "wide" and not _is_pairs(
                idx, self._pair_ndim(spec, pair_ndim)):
            idx = hash_lib.widen_ids(idx)
        return idx

    @staticmethod
    def _pair_ndim(spec: EmbeddingSpec, pair_ndim: Optional[int]) -> int:
        """The least ndim at which a trailing dim of 2 is a pair axis:
        ``pair_ndim`` if given, else 3 for a pooled spec (its ``[B, L=2]``
        matrices are sequences) and 2 otherwise, the JAX rule."""
        if pair_ndim is not None:
            return pair_ndim
        return 3 if spec.pooling else 2

    def _widen(self, spec: EmbeddingSpec, idx,
               pair_ndim: Optional[int] = None):
        """Host int64 ids for a hash variable, before they move to the
        device: (lo, hi) pairs for a wide variable, int32 for an int32 one;
        every other input passes.

        The JAX collection's rule (``EmbeddingCollection._widen``): a
        trailing dim of 2 is a pair axis from ndim ``pair_ndim`` on
        (:meth:`_pair_ndim`: 3 for a pooled spec, 2 otherwise; the serving
        row plane passes 2, its queries being flat pair lists). Host int64
        ids split on the host (``hash_table.split64``); host pair words
        typed int64, and int64 ids for an int32-key table, must fit int32,
        never wrap; an int64-key table takes them as they are. Narrow ids that reach the device widen there
        (``hash_table.widen_ids``, in :meth:`to_device`).
        """
        if not spec.use_hash or isinstance(idx, torch.Tensor):
            return idx
        arr = np.asarray(idx)
        if arr.dtype.kind not in "iu" or arr.dtype.itemsize != 8 \
                or spec.key_dtype == "int64":
            return arr
        if spec.key_dtype == "wide" and not _is_pairs(
                arr, self._pair_ndim(spec, pair_ndim)):
            return hash_lib.split64(arr)
        if arr.size and (arr.max() > np.iinfo(np.int32).max
                         or arr.min() < np.iinfo(np.int32).min):
            raise ValueError(
                f"embedding {spec.name!r}: ids exceed int32 — pass "
                "hash_table.split64(ids) pairs to a key_dtype='wide' "
                "variable, not raw 64-bit ids")
        return arr.astype(np.int32)


def _is_pairs(idx, pair_ndim: int) -> bool:
    """A trailing pair axis at ``pair_ndim`` dims or more."""
    return idx.ndim >= pair_ndim and idx.shape[-1] == 2
