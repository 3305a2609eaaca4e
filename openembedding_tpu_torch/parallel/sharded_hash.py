"""Hash tables sharded over a mesh
(``openembedding_tpu/parallel/sharded_hash.py``).

Each shard is an open-addressing table of ``capacity_per_shard =
round_capacity(ceil(total / S))`` slots (``hash_table.py``), and a key
lives on shard ``key % S`` (the joined 64-bit value's for wide pairs),
its one owner. The shards are stacked on the mesh's device: ``keys``
``[S * capacity_per_shard(, 2)]``, ``weights`` and slots likewise,
shard-major, JAX's global physical arrays; :meth:`ShardedHashState.shard`
gives shard ``s`` as a one-device ``HashTableState`` of views, so the
one-device probe, insert and update run on it in place. Every shard
shares the table's init key (a key's init row does not depend on the
shard count), and each keeps its own count of failed inserts
(``insert_failures``, whose sum JAX's replicated scalar holds).

The two planes of ``sharded_table``: ``"a2a"`` routes each key to its
owner (``parallel/alltoall.py``), whose probe is one launch of the
probe-gather kernel (K2) on its shard and whose misses draw their init
rows by one launch of KI; ``"psum"`` masks the batch to each model
shard's own keys (the others EMPTY), pulls from every shard and sums,
and pushes the masked global batch into each shard. All three key
dtypes run: wide pairs, int32 and int64.

On a mesh across processes a process holds the shards
``sharded_table.local_shards`` names (its positions' on ``a2a``, every
model shard on ``psum``), stacked from ``shard_lo``; ``shard_failures``
counts its own shards' failed inserts, and :func:`total_insert_failures`
sums them over the processes (a collective every process calls). The
``psum`` push takes the global batch, gathered in rank order.

The later ``a2a`` planes run as on array tables
(``parallel/sharded_table.py``): the cached plane's replica holds probed
rows (its owners' write-back finds each admitted key's slot in the
shards held, as JAX's ``find_rows`` does), and an int8_ef push keeps an ``EFState`` of the
table's own key words (pairs as int32 words, int32 and int64 keys as
they are, ``precision.ef_key_space``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..meta import EmbeddingVariableMeta
from ..optim.initializers import make_initializer, threefry_key
from ..optim.optimizers import make_optimizer
from ..table import resolve_dtype
from ..utils import observability
from .. import hash_table as hash_lib
from . import alltoall as a2a
from . import hot_cache, precision
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh
from .sharded_table import (_PlaneProps, _gather_global, held_fields,
                            local_shards, resolve_plane)


@dataclasses.dataclass(frozen=True)
class HashShardingSpec(_PlaneProps):
    """Static layout of one hash table over the mesh."""

    num_shards: int
    capacity_per_shard: int
    max_probes: int = hash_lib.DEFAULT_MAX_PROBES
    data_axis: str = DATA_AXIS
    model_axis: str = MODEL_AXIS
    plane: str = "a2a"
    a2a_capacity: int = 0
    a2a_slack: float = 2.0
    key_width: int = 32  # 64 = [n, 2] int32 (lo, hi) pairs
    cache_k: int = 0     # hot-row replica rows ("a2a+cache")
    exchange_precision: str = "f32"
    push_precision: str = "f32"

    @property
    def shard_axes(self) -> tuple:
        if self.plane != "psum":
            return (self.data_axis, self.model_axis)
        return (self.model_axis,)

    @property
    def wide(self) -> bool:
        return self.key_width == 64

    def owner_shard(self, keys: torch.Tensor) -> torch.Tensor:
        """Each key's shard (int64): the joined 64-bit key mod S for
        pairs (``hash_table.pair_mod``), ``key % S`` (non-negative) for
        int32 and int64 keys."""
        if self.wide:
            return hash_lib.pair_mod(keys, self.num_shards)
        return keys.to(torch.int64) % self.num_shards


def make_hash_sharding_spec(mesh: Mesh, total_capacity: int,
                            num_shards: int = -1,
                            max_probes: int = hash_lib.DEFAULT_MAX_PROBES,
                            plane: str = "a2a",
                            a2a_capacity: int = 0,
                            a2a_slack: float = 2.0,
                            key_width: int = 32,
                            cache_k: int = 0,
                            exchange_precision: str = "f32",
                            push_precision: str = "f32"
                            ) -> HashShardingSpec:
    """``num_shards=-1``: one shard per mesh position (``a2a`` planes) or
    per model slice (``psum``); each shard holds ``round_capacity(ceil(
    total_capacity / S))`` slots, as in JAX. Planes and precisions as in
    ``sharded_table.make_sharding_spec``."""
    plane, exchange_precision, push_precision, cache_k = resolve_plane(
        plane, exchange_precision, push_precision, cache_k)
    if key_width not in (32, 64):
        raise ValueError(f"key_width must be 32 or 64, got {key_width}")
    want = mesh.shape[MODEL_AXIS] if plane == "psum" else mesh.size
    if num_shards == -1:
        num_shards = want
    if num_shards != want:
        raise ValueError(
            f"num_shards={num_shards} must equal the {plane}-plane shard "
            f"count {want} for this mesh (or pass -1)")
    cap = hash_lib.round_capacity(-(-total_capacity // num_shards))
    return HashShardingSpec(num_shards=num_shards, capacity_per_shard=cap,
                            max_probes=max_probes, plane=plane,
                            a2a_capacity=a2a_capacity, a2a_slack=a2a_slack,
                            key_width=key_width, cache_k=cache_k,
                            exchange_precision=exchange_precision,
                            push_precision=push_precision)


@dataclasses.dataclass
class ShardedHashState:
    """One hash table's shards, stacked (module note). ``shard_failures``
    ``[S]`` int64 counts each shard's failed inserts. On a mesh across
    processes the shards held, ``local_shards`` of them from
    ``shard_lo``."""

    keys: torch.Tensor
    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]
    init_rng: Any
    shard_failures: torch.Tensor
    num_shards: int
    shard_lo: int = 0
    local_shards: int = 0

    @property
    def held(self) -> range:
        """The shards held, global ids."""
        return range(self.shard_lo,
                     self.shard_lo + (self.local_shards or self.num_shards))

    @property
    def capacity_per_shard(self) -> int:
        return self.keys.shape[0] // len(self.held)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def dim(self) -> int:
        return self.weights.shape[1]

    @property
    def wide(self) -> bool:
        return hash_lib.is_wide(self.keys)

    @property
    def insert_failures(self) -> torch.Tensor:
        """Failed inserts over the shards held (JAX's replicated total in
        one process; across processes see :func:`total_insert_failures`)."""
        return self.shard_failures.sum()

    def live(self) -> torch.Tensor:
        """``[S * capacity_per_shard]`` bool: slots that hold a key."""
        empty = hash_lib.empty_key(self.keys.dtype)
        return (self.keys[:, 1] if self.wide else self.keys) != empty

    def num_used(self) -> int:
        return int(self.live().sum())

    def shard(self, s: int) -> hash_lib.HashTableState:
        """The ``s``-th shard held (global ``shard_lo + s``) as a
        one-device table of views (its keys, rows, slots and failure
        count); updates of it land here."""
        c = self.capacity_per_shard
        return hash_lib.HashTableState(
            keys=self.keys[s * c:(s + 1) * c],
            weights=self.weights[s * c:(s + 1) * c],
            slots={k: v[s * c:(s + 1) * c] for k, v in self.slots.items()},
            init_rng=self.init_rng,
            insert_failures=self.shard_failures[s])


def create_sharded_hash_table(meta: EmbeddingVariableMeta, optimizer: Any,
                              *, mesh: Mesh, spec: HashShardingSpec,
                              rng=None, key_dtype: str = "int32"):
    """Empty shards of ``spec.capacity_per_shard`` slots each, on the
    mesh's device; every shard keeps the base init key ``rng`` (None:
    ``PRNGKey(0)``), as in JAX. ``key_dtype``: ``"wide"``, ``"int32"`` or
    ``"int64"`` (a spec of 64-bit key width stores wide pairs, as JAX's
    ``key_width`` decides). The cached plane's table comes in a
    ``CachedState``, as in JAX."""
    if spec.wide:
        key_dtype = "wide"
    if key_dtype not in hash_lib.KEY_DTYPES:
        raise ValueError(f"unknown hash key_dtype {key_dtype!r}; known: "
                         f"{hash_lib.KEY_DTYPES}")
    optimizer = make_optimizer(optimizer)
    held = local_shards(mesh, spec)
    s = len(held)
    rows = s * spec.capacity_per_shard
    dev = mesh.device
    dtype = resolve_dtype(meta)
    dim = meta.embedding_dim
    kdt = torch.int64 if key_dtype == "int64" else torch.int32
    shape = (rows, 2) if key_dtype == "wide" else (rows,)
    state = ShardedHashState(
        keys=torch.full(shape, hash_lib.empty_key(kdt), dtype=kdt,
                        device=dev),
        weights=torch.zeros((rows, dim), dtype=dtype, device=dev),
        slots=optimizer.init_slots(rows, dim, dtype, dev),
        init_rng=threefry_key(rng),
        shard_failures=torch.zeros(s, dtype=torch.int64, device=dev),
        num_shards=spec.num_shards, **held_fields(held, spec))
    return hot_cache.attach_empty(state, spec)


def _flat_query(spec: HashShardingSpec, state: ShardedHashState,
                indices: torch.Tensor) -> torch.Tensor:
    """A query as flat keys of the table's dtype: ``[n, 2]`` pairs on a
    wide table, ``[n]`` keys otherwise (``hash_table.check_key_dtype``)."""
    if spec.wide:
        return hash_lib._wide_query(state.keys, indices)
    return hash_lib.check_key_dtype(state.keys, indices.reshape(-1))


def _mask_non_owned(spec: HashShardingSpec, flat: torch.Tensor,
                    me: int) -> torch.Tensor:
    """Keys of ``flat`` that shard ``me`` does not own become EMPTY."""
    empty = hash_lib.empty_key(flat.dtype)
    if spec.wide:
        owned = (spec.owner_shard(flat) == me) & (flat[:, 1] != empty)
        return torch.where(owned[:, None], flat, torch.full_like(flat, empty))
    owned = (spec.owner_shard(flat) == me) & (flat != empty)
    return torch.where(owned, flat, torch.full_like(flat, empty))


def _owner_of(spec: HashShardingSpec):
    def owner(q: torch.Tensor) -> torch.Tensor:
        empty = hash_lib.empty_key(q.dtype)
        valid = (q[..., 1] if spec.wide else q) != empty
        return torch.where(valid, spec.owner_shard(q), spec.num_shards)
    return owner


def total_insert_failures(state: ShardedHashState, mesh: Mesh,
                          spec: HashShardingSpec) -> int:
    """Failed inserts over every shard of the table (JAX's replicated
    total). On a mesh across processes an ``a2a`` table's shards are
    spread over the processes, so their counts are summed over them: a
    collective that every process must call. A ``psum`` table is a
    replica on every process and counts its own."""
    total = state.insert_failures
    if mesh.spans_processes and spec.plane != "psum":
        from .. import distributed
        total = distributed.all_reduce(total.reshape(1).clone(), mesh)[0]
    return int(total)


def insert_rows_sharded(state: ShardedHashState, keys: torch.Tensor,
                        weights: torch.Tensor, slot_rows=None, *,
                        mesh: Mesh, spec: HashShardingSpec
                        ) -> ShardedHashState:
    """Load-path delivery: every shard inserts the keys it owns, verbatim
    (``hash_table.insert_rows`` on its views; the others masked EMPTY);
    keys that find no slot count in that shard's ``shard_failures``.
    In place; returns ``state``."""
    del mesh
    flat = _flat_query(spec, state, keys)
    for j, s in enumerate(state.held):
        hash_lib.insert_rows(state.shard(j), _mask_non_owned(spec, flat, s),
                             weights, slot_rows,
                             max_probes=spec.max_probes)
    return state


def insert_rows_sharded_packed(state: ShardedHashState,
                               packed: torch.Tensor, layout: tuple, *,
                               mesh: Mesh, spec: HashShardingSpec
                               ) -> ShardedHashState:
    """:func:`insert_rows_sharded` from one packed float32 buffer: column
    0 the int32 keys' bits, columns ``[1, 1 + dim)`` the weight row, then
    each slot's row (``layout = ((name, start_col, n_cols, row_shape),
    ...)``), as JAX's packed insert. int32-key tables only."""
    if spec.wide or state.keys.dtype != torch.int32:
        raise ValueError("packed insert supports int32-key tables only")
    n = packed.shape[0]
    dim = state.dim
    keys = packed[:, 0].contiguous().view(torch.int32)
    w = packed[:, 1:1 + dim]
    srows = {name: packed[:, st:st + c].reshape((n,) + tuple(shape))
             for name, st, c, shape in layout}
    return insert_rows_sharded(state, keys, w, srows or None, mesh=mesh,
                               spec=spec)


def pull_sharded(state, indices: torch.Tensor,
                 initializer: Any, *, mesh: Mesh, spec: HashShardingSpec,
                 batch_sharded: bool = True) -> torch.Tensor:
    """Rows for keys of any shape (``[..., 2]`` pairs on a wide table):
    the owner resolves each key; a missing key gets its init row (zero
    rows with ``initializer=None``, the serving contract), EMPTY keys
    zero rows. ``state``: a ``ShardedHashState``, a ``CachedState`` on the
    cached plane (admitted keys are always present in the table, so the
    replica never shadows an init row) or an ``EFState``."""
    if initializer is not None:
        initializer = make_initializer(initializer)
    record = observability.evaluate_performance()
    if spec.is_cached:
        return observability.plane_timed(
            "pull", spec.plane_label, record, _pull_cached, state, indices,
            initializer, mesh, spec, batch_sharded, record)
    return observability.plane_timed(
        "pull", spec.plane_label, record, _pull, hot_cache.unwrap(state),
        indices, initializer, mesh, spec, batch_sharded, record)


def _pull(state, indices, initializer, mesh, spec, batch_sharded, record):
    dim = state.dim
    flat = _flat_query(spec, state, indices)
    lead = tuple(indices.shape[:-1] if spec.wide else indices.shape)
    if spec.plane == "psum":
        out = None
        for s in range(spec.num_shards):
            rows = hash_lib.pull(state.shard(s),
                                 _mask_non_owned(spec, flat, s),
                                 initializer, max_probes=spec.max_probes)
            out = rows if out is None else out + rows
        return out.reshape(lead + (dim,))

    def resolve(req: torch.Tensor) -> torch.Tensor:
        return torch.stack([
            hash_lib.pull(state.shard(j), _mask_non_owned(spec, req[j], s),
                          initializer, max_probes=spec.max_probes)
            for j, s in enumerate(state.held)])

    rows = a2a.exchange_pull(
        flat, resolve, _owner_of(spec),
        sentinel=hash_lib.empty_key(flat.dtype), dim=dim,
        dtype=state.weights.dtype, num_shards=spec.num_shards,
        groups=mesh.shape[spec.data_axis] if batch_sharded else 1,
        capacity=spec.a2a_capacity, slack=spec.a2a_slack,
        record_stats=record, wire_dtype=spec.pull_wire_dtype, mesh=mesh)
    return rows.reshape(lead + (dim,))


def _valid_query(spec, flat):
    empty = hash_lib.empty_key(flat.dtype)
    return (flat[:, 1] if spec.wide else flat) != empty


def _pull_cached(state, indices, initializer, mesh, spec, batch_sharded,
                 record):
    table, cache = state.table, state.cache
    dim = table.dim
    flat = _flat_query(spec, table, indices)
    lead = tuple(indices.shape[:-1] if spec.wide else indices.shape)
    valid = _valid_query(spec, flat)
    pos, hit = hot_cache.lookup(cache.keys, flat, valid)
    served = hot_cache.served_rows(cache.rows, pos, hit)
    hot_cache.record_cache_stats(
        hit, valid, entry_bytes=dim * cache.rows.element_size()
        + (8 if spec.wide else 4), record=record, mesh=mesh)
    resid = hot_cache.mask_hits(flat, hit, hash_lib.empty_key(flat.dtype))
    rows = _pull(table, resid, initializer, mesh, spec, batch_sharded,
                 record).reshape(-1, dim)
    return (rows + served).reshape(lead + (dim,))


def apply_gradients_sharded(state, optimizer: Any,
                            initializer: Any, indices: torch.Tensor,
                            grads: torch.Tensor, *, mesh: Mesh,
                            spec: HashShardingSpec,
                            batch_sharded: bool = True,
                            dedup_capacity: Optional[int] = None):
    """Push and update in place: each key's gradients reach its one owner
    shard, which inserts it if missing (its init row) and updates it
    (``hash_table.apply_gradients`` on the shard's views, with the merged
    pre-reduces on ``a2a``). Returns the state (an int8_ef spec's bare
    table comes back in its new ``EFState``), as on array tables."""
    optimizer = make_optimizer(optimizer)
    initializer = make_initializer(initializer)
    record = observability.evaluate_performance()
    if spec.is_cached:
        return observability.plane_timed(
            "push", spec.plane_label, record, _push_cached, state,
            optimizer, initializer, indices, grads, mesh, spec,
            batch_sharded, dedup_capacity, record)
    ef = None
    table = hot_cache.unwrap(state)
    if spec.is_int8_ef and spec.num_shards > 1:
        sentinel, key_dtype = precision.ef_key_space(
            use_hash=True, wide=spec.wide, key_dtype=table.keys.dtype)
        n_flat = indices.numel() // (2 if spec.wide else 1)
        ef = precision.ensure_ef(
            state, dim=table.dim, wide=spec.wide, sentinel=sentinel,
            n_flat=n_flat, data=mesh.local_data_rows,
            model=mesh.shape[spec.model_axis], batch_sharded=batch_sharded,
            key_dtype=key_dtype)
    observability.plane_timed(
        "push", spec.plane_label, record, _push, table, optimizer,
        initializer, indices, grads, mesh, spec, batch_sharded,
        dedup_capacity, record, ef)
    return ef if ef is not None else state


def _push(state, optimizer, initializer, indices, grads, mesh, spec,
          batch_sharded, dedup_capacity, record, ef=None):
    dim = state.dim
    if indices.numel() == 0:
        return state
    flat = _flat_query(spec, state, indices)
    g2 = grads.reshape(-1, dim)
    if spec.plane == "psum":
        if mesh.spans_processes:
            flat, g2 = _gather_global(flat, g2, mesh)
        for s in range(spec.num_shards):
            hash_lib.apply_gradients(
                state.shard(s), optimizer, initializer,
                _mask_non_owned(spec, flat, s), g2,
                dedup_capacity=dedup_capacity, max_probes=spec.max_probes)
        return state

    def apply_fn(keys, g, counts):
        for j, s in enumerate(state.held):
            hash_lib.apply_gradients(
                state.shard(j), optimizer, initializer,
                _mask_non_owned(spec, keys[j], s), g[j],
                dedup_capacity=dedup_capacity, max_probes=spec.max_probes,
                in_counts=counts[j])
        return state

    from .sharded_table import _ef_views
    out = a2a.exchange_push(
        flat, g2, apply_fn, _owner_of(spec),
        sentinel=hash_lib.empty_key(flat.dtype),
        num_shards=spec.num_shards,
        groups=mesh.shape[spec.data_axis] if batch_sharded else 1,
        capacity=spec.a2a_capacity, slack=spec.a2a_slack,
        record_stats=record, wire_dtype=spec.push_wire_dtype,
        ef_state=None if ef is None else _ef_views(ef, len(state.held)),
        mesh=mesh)
    if ef is not None:
        _, (keys, resid) = out
        ef.keys.copy_(keys.reshape(ef.keys.shape))
        ef.resid.copy_(resid.reshape(ef.resid.shape))
    return state


def _push_cached(state, optimizer, initializer, indices, grads, mesh, spec,
                 batch_sharded, dedup_capacity, record):
    table, cache = state.table, state.cache
    dim = table.dim
    flat = _flat_query(spec, table, indices)
    g2 = grads.reshape(-1, dim)
    valid = _valid_query(spec, flat)
    pos, hit = hot_cache.lookup(cache.keys, flat, valid)
    groups = mesh.shape[spec.data_axis] if batch_sharded else 1
    summed, counts = hot_cache.cache_pre_reduce(
        pos, hit, g2, cache.k, spec.num_shards // groups, groups, mesh)
    hot_cache.record_cache_stats(
        hit, valid, entry_bytes=dim * cache.rows.element_size()
        + (12 if spec.wide else 8), record=record, mesh=mesh)
    resid = hot_cache.mask_hits(flat, hit, hash_lib.empty_key(flat.dtype))
    _push(table, optimizer, initializer, resid, g2, mesh, spec,
          batch_sharded, dedup_capacity, record)
    hot_cache.update_replica(optimizer, cache, summed, counts)
    # the slots of the admitted keys (present by admission) in the
    # shards held
    c = table.capacity_per_shard
    phys = torch.full((cache.k,), -1, dtype=torch.int64,
                      device=cache.keys.device)
    for j, s in enumerate(table.held):
        slot = hash_lib.find_rows(table.keys[j * c:(j + 1) * c],
                                  _mask_non_owned(spec, cache.keys, s),
                                  spec.max_probes)
        phys = torch.where(slot >= 0, j * c + slot, phys)
    hot_cache.write_back(table, cache, phys, counts)
    return state
