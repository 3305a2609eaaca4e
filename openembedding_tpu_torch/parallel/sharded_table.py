"""Array tables sharded over a mesh
(``openembedding_tpu/parallel/sharded_table.py``).

A table of ``vocab`` rows is cut into ``S`` shards of ``rows_per_shard =
ceil(vocab / S)`` rows:

* ``mod`` layout (default, the reference's): global row ``r`` lives on
  shard ``r % S`` at local row ``r // S``;
* ``div`` layout: shard ``r // rows_per_shard``, local ``r %
  rows_per_shard``.

All shards of a mesh live on its one device (``parallel/mesh.py``), so a
table's shards are one stacked tensor, ``[S * rows_per_shard, dim]``:
shard ``s`` is rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)``,
the physical global array JAX's ``device_get`` gives. Two data planes, as
in JAX:

* ``"a2a"``: tables over the whole mesh (``S = data * model``), the
  owner-routed exchange of ``parallel/alltoall.py``. The owners' lookups
  are one launch of the row-gather kernel (K1, ``ops/gather.py``) over the
  stacked shards a round, each owner's requests at its own rows; the push
  runs JAX's applier once per owner on its shard's rows, with the
  merged pre-reduces (``table.apply_gradients(in_counts=)``).
* ``"psum"``: tables over the model axis (``S = model``). JAX keeps a
  replica of each model shard on every data row and updates the replicas
  identically; in one process they would be identical copies, so the
  port keeps one. Pull = one K1 launch that gathers every model shard's
  owned rows of the batch (zero rows elsewhere), then their sum over the
  shards; push = the global batch, masked to each shard's own rows, and
  that shard's update.

Each shard's rows are drawn from ``fold_in(key, shard)`` by KI's flat
mode straight into its slice of the stacked tensor, as JAX's
``create_sharded_table`` draws them, so a 2 x 2 ``a2a`` table does not
start where a 1 x 1 one does (compare like with like). A one-shard
``a2a`` collection keeps the single-device table (``table.py``), which is
JAX's one-shard program.

On a mesh across processes (``distributed.create_global_mesh``) a
process holds only its own shards (:func:`local_shards`): on ``a2a`` its
positions' shards, stacked as above from its first (``shard_lo``), drawn
by KI from the same per-shard keys, so the state is the one-process
mesh's rows with nothing copied; on ``psum`` every model shard, the
replica of its data rows, as JAX keeps one on every data row. The
``psum`` push gathers the global batch from every process in rank order
(JAX's ``all_gather`` over the data axis), so each replica takes the
same update, the one-process mesh's. ``to_logical`` reads the shards
held (:func:`held_ids`).

The other planes of JAX ride the ``a2a`` layout:

* ``"a2a+cache"``: a top-K hot-row replica beside the table
  (``parallel/hot_cache.py``; the state is a ``CachedState``): hits are
  served from the replica, the residue rides the exchange, and the push
  updates the replica from one sum over the senders and writes the rows
  back to their owners, so the table stays authoritative; across
  processes each holds the whole replica and writes back the rows it
  holds (:func:`held_rows`);
* ``"a2a+grouped"`` and ``"a2a+pipelined"`` (and both): the collection
  batches grouped tables into one exchange a group
  (``parallel/grouped.py``) and the ``Trainer`` double-buffers pipelined
  ones (``parallel/pipelined.py``); a per-table call runs ``a2a``'s
  program;
* a ``+bf16``/``+int8`` suffix (``parallel/precision.py``): narrower
  wires, and for ``int8_ef`` an ``EFState`` residual beside the table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..meta import EmbeddingVariableMeta
from ..ops import dedup
from ..ops.gather import gather_rows
from ..ops.init_rows import init_flat
from ..optim.initializers import fold_in, make_initializer, threefry_key
from ..optim.optimizers import make_optimizer
from ..utils import observability
from .. import table as table_lib
from . import alltoall as a2a
from . import hot_cache, precision
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

# every plane on the owner-routed layout (tables over the whole mesh);
# "psum" is the broadcast-style ablation
A2A_PLANES = ("a2a", "a2a+cache", "a2a+grouped", "a2a+pipelined",
              "a2a+grouped+pipelined")
PLANES = A2A_PLANES + ("psum",)
DEFAULT_CACHE_K = 512


class _PlaneProps:
    """The plane and precision properties array and hash specs share."""

    @property
    def is_cached(self) -> bool:
        return self.plane == "a2a+cache"

    @property
    def plane_label(self) -> str:
        """The plane token of ``plane_timed`` spans and timings, with the
        precision suffix (``precision.plane_label``)."""
        return precision.plane_label(self.plane, self.exchange_precision,
                                     self.push_precision)

    @property
    def pull_wire_dtype(self):
        return precision.wire_dtype(self.exchange_precision)

    @property
    def push_wire_dtype(self):
        # int8_ef carries its own int8 payload inside exchange_push
        return precision.wire_dtype(self.push_precision) \
            if self.push_precision == "bf16" else None

    @property
    def is_int8_ef(self) -> bool:
        return self.push_precision == "int8_ef"

    @property
    def is_grouped(self) -> bool:
        """Collection-level multi-table exchange (``parallel/grouped.py``)."""
        return self.plane in ("a2a+grouped", "a2a+grouped+pipelined")

    @property
    def is_pipelined(self) -> bool:
        """The Trainer's double-buffered schedule
        (``parallel/pipelined.py``)."""
        return self.plane in ("a2a+pipelined", "a2a+grouped+pipelined")


def resolve_plane(plane: str, exchange_precision: str, push_precision: str,
                  cache_k: int) -> tuple:
    """``(base_plane, exchange_precision, push_precision, cache_k)`` for a
    spec maker, as in JAX: the suffix folded and checked, ``cache_k`` 0
    off the cached plane and the default on it when not given."""
    plane, ep, pp = precision.resolve_precision(plane, exchange_precision,
                                                push_precision)
    if plane not in PLANES:
        raise ValueError(f"unknown plane {plane!r}")
    if plane == "a2a+cache" and cache_k <= 0:
        cache_k = DEFAULT_CACHE_K
    if plane != "a2a+cache":
        cache_k = 0
    return plane, ep, pp, cache_k


@dataclasses.dataclass(frozen=True)
class ShardingSpec(_PlaneProps):
    """Static description of how one table is laid out on the mesh."""

    num_shards: int
    rows_per_shard: int
    layout: str = "mod"  # "mod" | "div"
    data_axis: str = DATA_AXIS
    model_axis: str = MODEL_AXIS
    plane: str = "a2a"   # a PLANES member
    a2a_capacity: int = 0    # per-destination bucket rows; 0 = auto
    a2a_slack: float = 2.0   # auto capacity = slack * mean bucket size
    cache_k: int = 0         # hot-row replica rows ("a2a+cache")
    exchange_precision: str = "f32"   # "f32" | "bf16"
    push_precision: str = "f32"       # "f32" | "bf16" | "int8_ef"

    @property
    def shard_axes(self) -> tuple:
        """Mesh axes the table's rows are sharded over."""
        if self.plane != "psum":
            return (self.data_axis, self.model_axis)
        return (self.model_axis,)

    @property
    def padded_vocab(self) -> int:
        return self.num_shards * self.rows_per_shard

    def shard_and_local(self, idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.layout == "mod":
            return idx % self.num_shards, idx // self.num_shards
        return idx // self.rows_per_shard, idx % self.rows_per_shard

    def physical_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Each logical id's row in the stacked shards (``shard *
        rows_per_shard + local``, int64), ``-1`` for ids outside ``[0,
        padded_vocab)``."""
        ids = ids.to(torch.int64)
        shard, local = self.shard_and_local(ids)
        valid = (ids >= 0) & (ids < self.padded_vocab)
        return torch.where(valid, shard * self.rows_per_shard + local, -1)


def make_sharding_spec(meta: EmbeddingVariableMeta, mesh: Mesh,
                       num_shards: int = -1, layout: str = "mod",
                       capacity: Optional[int] = None,
                       plane: str = "a2a",
                       a2a_capacity: int = 0,
                       a2a_slack: float = 2.0,
                       cache_k: int = 0,
                       exchange_precision: str = "f32",
                       push_precision: str = "f32") -> ShardingSpec:
    """``num_shards=-1``: one shard per mesh position (``a2a`` planes) or
    per model slice (``psum``); any other count must equal that, as in
    JAX. A ``+bf16``/``+int8`` plane suffix folds into the precisions;
    ``cache_k`` 0 on ``a2a+cache`` takes the default."""
    if layout not in ("mod", "div"):
        raise ValueError(f"unknown layout {layout!r}")
    plane, exchange_precision, push_precision, cache_k = resolve_plane(
        plane, exchange_precision, push_precision, cache_k)
    want = mesh.shape[MODEL_AXIS] if plane == "psum" else mesh.size
    if num_shards == -1:
        num_shards = want
    if num_shards != want:
        raise ValueError(
            f"num_shards={num_shards} must equal the {plane}-plane shard "
            f"count {want} for this mesh (or pass -1)")
    vocab = capacity if capacity is not None else meta.vocabulary_size
    rows_per_shard = math.ceil(vocab / num_shards)
    return ShardingSpec(num_shards=num_shards, rows_per_shard=rows_per_shard,
                        layout=layout, plane=plane,
                        a2a_capacity=a2a_capacity, a2a_slack=a2a_slack,
                        cache_k=cache_k,
                        exchange_precision=exchange_precision,
                        push_precision=push_precision)


@dataclasses.dataclass
class ShardedTableState:
    """One table's shards, stacked: ``weights`` ``[S * rows_per_shard,
    dim]`` and each slot likewise, shard-major (JAX's global physical
    arrays). On a mesh across processes the shards this process holds,
    ``local_shards`` of them from shard ``shard_lo`` (0: all ``S``)."""

    weights: torch.Tensor
    slots: Dict[str, torch.Tensor]
    num_shards: int
    shard_lo: int = 0
    local_shards: int = 0

    @property
    def held(self) -> range:
        """The shards held, global ids."""
        return range(self.shard_lo,
                     self.shard_lo + (self.local_shards or self.num_shards))

    @property
    def rows_per_shard(self) -> int:
        return self.weights.shape[0] // len(self.held)

    @property
    def dim(self) -> int:
        return self.weights.shape[1]

    def shard(self, s: int) -> table_lib.TableState:
        """The ``s``-th shard held (global shard ``shard_lo + s``) as a
        one-device table of views into the stacked tensors (its updates
        land in them)."""
        rps = self.rows_per_shard
        return table_lib.TableState(
            weights=self.weights[s * rps:(s + 1) * rps],
            slots={k: v[s * rps:(s + 1) * rps]
                   for k, v in self.slots.items()})


def local_shards(mesh: Optional[Mesh], spec) -> range:
    """The shards this process holds, global ids: on a mesh across
    processes its own positions' (``a2a`` planes) or every model shard
    (``psum``, the replica of its data rows); else every shard."""
    if mesh is None or not mesh.spans_processes or spec.plane == "psum":
        return range(spec.num_shards)
    return mesh.local_positions


def held_fields(shards: range, spec) -> dict:
    """The state fields that record which shards a process holds."""
    if len(shards) == spec.num_shards:
        return {}
    return {"shard_lo": shards.start, "local_shards": len(shards)}


def _mesh_groups(mesh: Mesh, spec: ShardingSpec,
                 batch_sharded: bool) -> int:
    """The batch slices an exchange splits among its senders: the data
    rows when batch-sharded, else 1 (``alltoall.grid_info``)."""
    return mesh.shape[spec.data_axis] if batch_sharded else 1


def create_sharded_table(meta: EmbeddingVariableMeta, optimizer: Any,
                         initializer: Any = None, *, mesh: Mesh,
                         spec: Optional[ShardingSpec] = None,
                         rng=None):
    """Every shard's rows from ``fold_in(rng, shard)`` (JAX's per-device
    init; ``rng`` None: ``PRNGKey(0)``), drawn by KI's flat mode into the
    shard's slice of the stacked tensor, and the optimizer's slots: the
    shards this process holds (:func:`local_shards`). On the cached plane
    the table comes in a ``CachedState`` with an all-padding replica, as
    in JAX."""
    optimizer = make_optimizer(optimizer)
    initializer = make_initializer(initializer
                                   or table_lib.DEFAULT_INITIALIZER)
    if spec is None:
        spec = make_sharding_spec(meta, mesh)
    rng = threefry_key(rng)
    dtype = table_lib.resolve_dtype(meta)
    dim = meta.embedding_dim
    held = local_shards(mesh, spec)
    rps = spec.rows_per_shard
    n = len(held) * rps
    weights = torch.empty((n, dim), dtype=dtype, device=mesh.device)
    for j, i in enumerate(held):
        key = fold_in(rng, i)
        block = weights[j * rps:(j + 1) * rps]
        if dtype in (torch.float32, torch.bfloat16):
            init_flat(block, key, 0, initializer)
        else:
            block.copy_(initializer.init(key, (rps, dim), dtype,
                                         mesh.device))
    slots = optimizer.init_slots(n, dim, dtype, mesh.device)
    return hot_cache.attach_empty(
        ShardedTableState(weights=weights, slots=slots,
                          num_shards=spec.num_shards,
                          **held_fields(held, spec)), spec)


def filled_sharded(mesh: Mesh, spec: ShardingSpec, tail: tuple, fill,
                   dtype) -> torch.Tensor:
    """A constant-filled ``[padded_vocab, *tail]`` stacked array: the
    blank canvas a checkpoint load delivers rows onto."""
    return torch.full((spec.padded_vocab,) + tuple(tail), fill,
                      dtype=dtype, device=mesh.device)


def deliver_rows_sharded(arr: torch.Tensor, phys: torch.Tensor,
                         rows: torch.Tensor, *, mesh: Mesh,
                         spec: ShardingSpec) -> torch.Tensor:
    """Scatter rows at PHYSICAL positions (``shard * rows_per_shard +
    local``; ``-1`` or out of range = padding, dropped) into a stacked
    array, in place; returns ``arr``. A load path: the mask is read back
    to the host."""
    del mesh
    phys = phys.to(device=arr.device, dtype=torch.int64)
    ok = (phys >= 0) & (phys < spec.padded_vocab)
    arr.index_copy_(0, phys[ok], rows.to(arr.device, arr.dtype)[ok])
    return arr


def held_rows(spec: ShardingSpec, state, ids: torch.Tensor) -> torch.Tensor:
    """Each logical id's row in the stacked shards ``state`` holds (int64),
    ``-1`` for ids outside ``[0, padded_vocab)`` and for ids of shards
    another process holds: ``spec.physical_rows`` in one process."""
    phys = spec.physical_rows(ids)
    held = state.held
    if len(held) == spec.num_shards:
        return phys
    lo = held.start * spec.rows_per_shard
    hi = held.stop * spec.rows_per_shard
    return torch.where((phys >= lo) & (phys < hi), phys - lo, -1)


def logical_to_physical(spec: ShardingSpec, vocab: int,
                        device) -> torch.Tensor:
    """The stacked row of every logical id ``0 .. vocab - 1`` (int64)."""
    return spec.physical_rows(torch.arange(vocab, device=device))


def held_ids(spec: ShardingSpec, vocab: int, held: range,
             device) -> torch.Tensor:
    """The logical ids ``0 .. vocab - 1`` that the shards ``held`` own,
    ascending (int64): every id on one process's mesh."""
    ids = torch.arange(vocab, device=device)
    if len(held) == spec.num_shards:
        return ids
    shard, _ = spec.shard_and_local(ids)
    return ids[(shard >= held.start) & (shard < held.stop)]


def from_logical(state: table_lib.TableState, spec: ShardingSpec,
                 vocab: int, optimizer: Any) -> ShardedTableState:
    """A one-device table of ``vocab`` logical rows laid out on the shards:
    the ``mod`` permutation applied, padding rows past ``vocab`` at JAX's
    load fill (zero weights, each slot at its init value). The checkpoint
    loader's last step."""
    optimizer = make_optimizer(optimizer)
    dev = state.weights.device
    phys = logical_to_physical(spec, vocab, dev)

    def lay(t: torch.Tensor, fill) -> torch.Tensor:
        out = torch.full((spec.padded_vocab,) + tuple(t.shape[1:]), fill,
                         dtype=t.dtype, device=dev)
        out.index_copy_(0, phys, t[:vocab])
        return out
    return ShardedTableState(
        weights=lay(state.weights, 0.0),
        slots={k: lay(v, optimizer.slot_init(k))
               for k, v in state.slots.items()},
        num_shards=spec.num_shards)


def to_logical(state: ShardedTableState, spec: ShardingSpec,
               vocab: int) -> table_lib.TableState:
    """The logical rows a sharded table holds as a one-device table
    (JAX's ``gather_logical_window``): the ``mod`` permutation undone,
    the padding dropped; every id ``0 .. vocab - 1`` in one process, the
    ids :func:`held_ids` lists on a mesh across processes. A copy."""
    held = state.held
    ids = held_ids(spec, vocab, held, state.weights.device)
    phys = spec.physical_rows(ids) - held.start * spec.rows_per_shard
    return table_lib.TableState(
        weights=state.weights.index_select(0, phys),
        slots={k: v.index_select(0, phys) for k, v in state.slots.items()})


# --- data plane ------------------------------------------------------------------

def _owner_of(spec: ShardingSpec):
    def owner(keys: torch.Tensor) -> torch.Tensor:
        k = keys.to(torch.int64)
        shard, _ = spec.shard_and_local(k)
        valid = (k >= 0) & (k < spec.padded_vocab)
        return torch.where(valid, shard, spec.num_shards)
    return owner


def _owned_rows(spec: ShardingSpec, keys: torch.Tensor,
                shard_lo: int = 0) -> torch.Tensor:
    """``[L_owner, K]`` requests of the owners ``shard_lo ..`` -> each
    key's row in the stacked shards held where its row owner is the
    requested owner, else ``-1`` (JAX's ``resolve`` mask)."""
    k = keys.to(torch.int64)
    shard, local = spec.shard_and_local(k)
    j = torch.arange(keys.shape[0], device=keys.device)[:, None]
    mine = (k >= 0) & (k < spec.padded_vocab) & (shard == j + shard_lo)
    return torch.where(mine, j * spec.rows_per_shard + local, -1)


def pull_sharded(state, indices: torch.Tensor, *,
                 mesh: Mesh, spec: ShardingSpec,
                 batch_sharded: bool = True) -> torch.Tensor:
    """Rows for ``indices`` of any shape (``indices.shape + (dim,)``),
    zero rows for invalid ids. ``batch_sharded``: the batch is split over
    the data axis (the training path) or replicated (each sender then
    takes a slice of the whole batch), as in JAX; the rows are the same.
    ``state``: a ``ShardedTableState``, a ``CachedState`` on the cached
    plane (hot keys served by the replica, the residue by the exchange),
    or an ``EFState`` (read through)."""
    record = observability.evaluate_performance()
    if spec.is_cached:
        return observability.plane_timed(
            "pull", spec.plane_label, record, _pull_cached, state, indices,
            mesh, spec, batch_sharded, record)
    return observability.plane_timed(
        "pull", spec.plane_label, record, _pull, hot_cache.unwrap(state),
        indices, mesh, spec, batch_sharded, record)


def _pull(state, indices, mesh, spec, batch_sharded, record):
    dim = state.dim
    flat = indices.reshape(-1)
    if spec.plane == "psum":
        s = spec.num_shards
        phys = spec.physical_rows(flat)
        shard = torch.div(phys, spec.rows_per_shard, rounding_mode="floor")
        me = torch.arange(s, device=flat.device)[:, None]
        ids = torch.where((phys >= 0) & (shard == me), phys, -1)
        rows = gather_rows(state.weights, ids.reshape(-1)).view(s, -1, dim)
        out = rows[0]
        for i in range(1, s):
            out = out + rows[i]
        return out.reshape(tuple(indices.shape) + (dim,))

    def resolve(req: torch.Tensor) -> torch.Tensor:
        ids = _owned_rows(spec, req, state.shard_lo)
        return gather_rows(state.weights, ids.reshape(-1)).view(
            req.shape[0], -1, dim)

    rows = a2a.exchange_pull(
        flat, resolve, _owner_of(spec), sentinel=dedup.FILL, dim=dim,
        dtype=state.weights.dtype, num_shards=spec.num_shards,
        groups=_mesh_groups(mesh, spec, batch_sharded),
        capacity=spec.a2a_capacity, slack=spec.a2a_slack,
        record_stats=record, wire_dtype=spec.pull_wire_dtype, mesh=mesh)
    return rows.reshape(tuple(indices.shape) + (dim,))


def _pull_cached(state, indices, mesh, spec, batch_sharded, record):
    """The cached plane's pull: hits from the replica (one K1 launch over
    its rows), the rest through the exchange with hits masked invalid,
    the two summed (each entry is zero in one of them)."""
    table, cache = state.table, state.cache
    dim = table.dim
    flat = indices.reshape(-1)
    valid = (flat >= 0) & (flat < spec.padded_vocab)
    pos, hit = hot_cache.lookup(cache.keys, flat, valid)
    served = hot_cache.served_rows(cache.rows, pos, hit)
    hot_cache.record_cache_stats(
        hit, valid, entry_bytes=dim * cache.rows.element_size() + 4,
        record=record, mesh=mesh)
    resid = hot_cache.mask_hits(flat, hit, dedup.FILL)
    rows = _pull(table, resid, mesh, spec, batch_sharded, record)
    return (rows + served).reshape(tuple(indices.shape) + (dim,))


def apply_gradients_sharded(state, optimizer: Any,
                            indices: torch.Tensor, grads: torch.Tensor, *,
                            mesh: Mesh, spec: ShardingSpec,
                            batch_sharded: bool = True,
                            dedup_capacity: Optional[int] = None):
    """Push and update in place: every shard applies its own rows' update
    (``a2a``: the owners' merged pre-reduces; ``psum``: the global batch
    masked to the shard), each with ``table.apply_gradients`` and
    ``dedup_capacity`` as JAX's applier. Returns the state: ``state``
    itself, or on an int8_ef spec given a bare table its new ``EFState``
    (the residual of this push). On the cached plane the replica takes
    the hot keys' update and writes their rows back to the owners."""
    optimizer = make_optimizer(optimizer)
    record = observability.evaluate_performance()
    if spec.is_cached:
        return observability.plane_timed(
            "push", spec.plane_label, record, _push_cached, state,
            optimizer, indices, grads, mesh, spec, batch_sharded,
            dedup_capacity, record)
    ef = None
    if spec.is_int8_ef and spec.num_shards > 1:
        table = hot_cache.unwrap(state)
        sentinel, key_dtype = precision.ef_key_space(use_hash=False)
        ef = precision.ensure_ef(
            state, dim=table.dim, wide=False, sentinel=sentinel,
            n_flat=indices.numel(), data=mesh.local_data_rows,
            model=mesh.shape[spec.model_axis], batch_sharded=batch_sharded,
            key_dtype=key_dtype)
    observability.plane_timed(
        "push", spec.plane_label, record, _push, hot_cache.unwrap(state),
        optimizer, indices, grads, mesh, spec, batch_sharded,
        dedup_capacity, record, ef)
    return ef if ef is not None else state


def _push(state, optimizer, indices, grads, mesh, spec, batch_sharded,
          dedup_capacity, record, ef=None):
    dim = state.dim
    flat = indices.reshape(-1)
    g2 = grads.reshape(-1, dim)
    if flat.shape[0] == 0:
        return state
    if spec.plane == "psum":
        if mesh.spans_processes:
            # every replica takes the global batch (JAX's all_gather over
            # the data axis), in rank order
            flat, g2 = _gather_global(flat, g2, mesh)
        shard, local = spec.shard_and_local(flat.to(torch.int64))
        valid = (flat >= 0) & (flat < spec.padded_vocab)
        for s in range(spec.num_shards):
            masked = torch.where(valid & (shard == s), local, -1)
            table_lib.apply_gradients(state.shard(s), optimizer, masked, g2,
                                      dedup_capacity=dedup_capacity)
        return state

    def apply_fn(keys, g, counts):
        k = keys.to(torch.int64)
        shard, local = spec.shard_and_local(k)
        valid = (k >= 0) & (k < spec.padded_vocab)
        for j, s in enumerate(state.held):
            masked = torch.where(valid[j] & (shard[j] == s), local[j], -1)
            table_lib.apply_gradients(state.shard(j), optimizer, masked,
                                      g[j], dedup_capacity=dedup_capacity,
                                      in_counts=counts[j])
        return state

    out = a2a.exchange_push(
        flat, g2, apply_fn, _owner_of(spec), sentinel=dedup.FILL,
        num_shards=spec.num_shards,
        groups=_mesh_groups(mesh, spec, batch_sharded),
        capacity=spec.a2a_capacity, slack=spec.a2a_slack,
        record_stats=record, wire_dtype=spec.push_wire_dtype,
        ef_state=None if ef is None else _ef_views(ef, len(state.held)),
        mesh=mesh)
    if ef is not None:
        _, (keys, resid) = out
        ef.keys.copy_(keys.reshape(ef.keys.shape))
        ef.resid.copy_(resid.reshape(ef.resid.shape))
    return state


def _gather_global(flat: torch.Tensor, g2: torch.Tensor, mesh: Mesh):
    """Every process's push entries, in rank order: the global batch of
    a ``psum`` push (ids as int64, so every key dtype crosses alike)."""
    from .. import distributed
    tail = tuple(flat.shape[1:])
    ids = distributed.all_gather(flat.to(torch.int64), mesh)
    grads = distributed.all_gather(g2, mesh)
    return (ids.reshape((-1,) + tail).to(flat.dtype),
            grads.reshape(-1, g2.shape[-1]))


def _ef_views(ef, num_shards: int):
    """An ``EFState``'s stacked buffers as ``[S, m(, 2)]`` and ``[S, m,
    dim]`` (``S`` the senders held): sender ``p``'s block is row ``p``."""
    s = num_shards
    return (ef.keys.view((s, -1) + tuple(ef.keys.shape[1:])),
            ef.resid.view(s, -1, ef.resid.shape[-1]))


def _push_cached(state, optimizer, indices, grads, mesh, spec,
                 batch_sharded, dedup_capacity, record):
    """The cached plane's push: the hot keys' gradients pre-reduced by
    every sender into K bins and summed over the senders, the replica
    updated by them (rows of zero count untouched) and its rows written
    back to their owners; the residue pushed through the exchange."""
    table, cache = state.table, state.cache
    dim = table.dim
    flat = indices.reshape(-1)
    g2 = grads.reshape(-1, dim)
    valid = (flat >= 0) & (flat < spec.padded_vocab)
    pos, hit = hot_cache.lookup(cache.keys, flat, valid)
    groups = _mesh_groups(mesh, spec, batch_sharded)
    summed, counts = hot_cache.cache_pre_reduce(
        pos, hit, g2, cache.k, spec.num_shards // groups, groups, mesh)
    hot_cache.record_cache_stats(
        hit, valid, entry_bytes=dim * cache.rows.element_size() + 8,
        record=record, mesh=mesh)
    resid = hot_cache.mask_hits(flat, hit, dedup.FILL)
    _push(table, optimizer, resid, g2, mesh, spec, batch_sharded,
          dedup_capacity, record)
    hot_cache.update_replica(optimizer, cache, summed, counts)
    hot_cache.write_back(table, cache, held_rows(spec, table, cache.keys),
                         counts)
    return state
