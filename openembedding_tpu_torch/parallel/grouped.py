"""The grouped multi-table exchange, one exchange a GROUP of tables a step
(``plane="a2a+grouped"``; ``openembedding_tpu/parallel/grouped.py``).

``EmbeddingCollection.pull`` and ``apply_gradients`` run one exchange a
table; a model of T tables on this plane runs one a group instead, and
stays equal to the per-table loop:

* :func:`plan_groups` groups the collection's grouped tables by (kind,
  bucket dim, key shape, shard count, layout, exchange sizing, dtype,
  precisions), members in registration order; an array group splits
  where its concatenated padded vocabularies would leave int32;
* each group's ids become one tagged stream: array table ``t``'s id ``i``
  rides as ``bases[t] + i`` over the concatenation of the padded
  vocabularies (ids a table rejects become the sentinel first, so they
  never alias a neighbour's range); hash keys carry a table-id column
  beside their words (``[n, 2]`` ``(key, tag)``, ``[n, 3]`` ``(lo, hi,
  tag)``), deduplicated lexicographically;
* one ``alltoall.exchange_pull`` and one ``exchange_push`` route the
  stream. Each owner sorts its received stream once (stable, by offset or
  tag: every member's entries contiguous) and serves each member from a
  window of STATIC size, the member's global entry count before dedup
  (no owner receives more of a table than that), starting at the
  member's first entry: its work grows with the stream, not with
  ``T x stream``. Windows may spill into a neighbour's entries, which
  every member masks before it touches a table.

Rows travel at the group's bucket width (the next power of two over its
dims) and each table's columns are sliced back after the exchange. Each
member applies its own optimizer on its owners. In the port an array
member's owners share one stacked table, so a member's update over every
owner's window is one ``table.apply_gradients`` on the stacked rows (a
row is in its owner's window only, so each row's entries and their order
are the per-owner push's); its owners' row lookups are one launch of the
row-gather kernel (K1) a round. A hash member probes and updates each
owner's shard (K2 and KI, as the per-table plane does).

On a mesh across processes (``distributed.create_global_mesh``) the
exchanges cross the processes (``alltoall.grid_all_to_all``); a process
holds its own positions' owners, so every owner index is local (from
the members' ``shard_lo``), and a member's window bound counts the
global batch, the processes' equal slices together.

Per-table calls on a grouped spec (serving, checkpoints,
``sharded_table.pull_sharded``) run the plain ``a2a`` exchange, so the
plane composes with cached variables in the same collection. Counters
(host side, gated, not while a graph is captured): ``grouped_groups`` and
``grouped_exchange_bytes`` (entries before dedup times the row and key
words).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from .. import hash_table as hash_lib
from .. import table as table_lib
from ..analysis import scope
from ..ops import dedup
from ..ops.gather import gather_rows
from ..utils import observability
from . import alltoall as a2a

GROUPED_PLANES = ("a2a+grouped", "a2a+grouped+pipelined")

# array offset streams are int32: a group's concatenated padded vocabs
# stay addressable (the planner splits groups at this boundary)
_MAX_OFFSET_SPAN = 2**31 - 1


def dim_bucket(dim: int) -> int:
    """The next power of two >= ``dim`` (at least 1): the width rows of
    mixed dims share a round at."""
    return 1 << max(0, int(dim) - 1).bit_length() if dim > 1 else 1


@dataclasses.dataclass(frozen=True)
class ArrayMember:
    """What one array table brings to its group."""

    name: str
    dim: int
    spec: Any                     # sharded_table.ShardingSpec
    optimizer: Any


@dataclasses.dataclass(frozen=True)
class HashMember:
    """What one hash table brings to its group."""

    name: str
    dim: int
    spec: Any                     # sharded_hash.HashShardingSpec
    optimizer: Any
    initializer: Any              # None: the read-only pull contract


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One exchange group: its members share bucket width, kind, key
    shape, shard count and mesh axes, so one routed round serves all."""

    kind: str                     # "array" | "hash"
    bucket_dim: int
    key_dtype: str                # array: "int32" offsets; hash: key words
    members: tuple
    bases: Tuple[int, ...] = ()   # array only: offset bases

    @property
    def wide(self) -> bool:
        return self.kind == "hash" and self.key_dtype == "wide"


def plan_groups(collection, names, *, read_only: bool = False
                ) -> Tuple[GroupPlan, ...]:
    """``names`` (all on a grouped plane) in exchange groups, as JAX
    plans them (module note), ordered by their first member's id."""
    ordered = sorted(names, key=collection.variable_id)
    buckets: Dict[tuple, list] = {}
    for name in ordered:
        spec = collection.specs[name]
        ss = collection.sharding_spec(name)
        if ss.plane not in GROUPED_PLANES:
            raise ValueError(f"{name!r} is not on a grouped plane "
                             f"({GROUPED_PLANES})")
        if spec.use_hash:
            key = ("hash", ss.plane, spec.key_dtype,
                   dim_bucket(spec.output_dim),
                   ss.num_shards, ss.data_axis, ss.model_axis,
                   ss.a2a_capacity, ss.a2a_slack, spec.dtype,
                   ss.exchange_precision, ss.push_precision)
        else:
            key = ("array", ss.plane, dim_bucket(spec.output_dim),
                   ss.num_shards,
                   ss.layout, ss.data_axis, ss.model_axis,
                   ss.a2a_capacity, ss.a2a_slack, spec.dtype,
                   ss.exchange_precision, ss.push_precision)
        buckets.setdefault(key, []).append(name)

    plans = []
    for key, group_names in buckets.items():
        if key[0] == "hash":
            members = tuple(
                HashMember(
                    name=n, dim=collection.specs[n].output_dim,
                    spec=collection.sharding_spec(n),
                    optimizer=collection.optimizer(n),
                    initializer=(None if read_only
                                 else collection.initializer(n)))
                for n in group_names)
            plans.append(GroupPlan(kind="hash", bucket_dim=key[3],
                                   key_dtype=key[2], members=members))
            continue
        run, span = [], 0
        for n in group_names:
            ss = collection.sharding_spec(n)
            if run and span + ss.padded_vocab > _MAX_OFFSET_SPAN:
                plans.append(_array_plan(collection, tuple(run), key[2]))
                run, span = [], 0
            run.append(n)
            span += ss.padded_vocab
        if run:
            plans.append(_array_plan(collection, tuple(run), key[2]))
    plans.sort(key=lambda p: collection.variable_id(p.members[0].name))
    return tuple(plans)


def _array_plan(collection, group_names, bucket: int) -> GroupPlan:
    members = tuple(
        ArrayMember(name=n, dim=collection.specs[n].output_dim,
                    spec=collection.sharding_spec(n),
                    optimizer=collection.optimizer(n))
        for n in group_names)
    bases = a2a.segment_offsets([m.spec.padded_vocab for m in members])
    return GroupPlan(kind="array", bucket_dim=bucket, key_dtype="int32",
                     members=members, bases=bases)


def _stream_bounds(plan: GroupPlan, idxs, procs: int = 1
                   ) -> Tuple[int, ...]:
    """Each member's static window size: its global entry count before
    dedup (``procs`` equal slices of this process's), the most of it one
    owner can receive in one exchange."""
    out = []
    for i in idxs:
        out.append(i.numel() // (2 if plan.wide else 1) * procs)
    return tuple(out)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x`` ``[S, n, ...]`` taken at ``idx`` ``[S, j]`` row by row."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return a2a._take_rows(x, idx)


def _sorted_member_windows(col: torch.Tensor, bounds, thresholds,
                           *streams):
    """Every owner's stream sorted once by ``col`` ``[S, n]`` (stable:
    sentinels, the dtype's minimum, first; each member's entries
    contiguous), then per member ``t`` the static window ``[start, start
    + min(n, bounds[t]))``, ``start`` the first entry ``>= thresholds[t]``
    clamped into range. Yields ``(t, (col_w, order_w, *stream_w))``, each
    ``[S, size, ...]``; ``order_w`` maps window positions back to stream
    positions."""
    s, n = col.shape
    order = torch.argsort(col, dim=1, stable=True)
    scol = torch.gather(col, 1, order).contiguous()
    sorted_streams = [_take(x, order) for x in streams]
    for t, (bound, thr) in enumerate(zip(bounds, thresholds)):
        size = min(n, bound)
        start = torch.searchsorted(
            scol, torch.full((s, 1), int(thr), dtype=col.dtype,
                             device=col.device))
        start = torch.clamp_max(start, n - size)
        idx = start + torch.arange(size, device=col.device)
        yield t, (torch.gather(scol, 1, idx), torch.gather(order, 1, idx),
                  *[_take(x, idx) for x in sorted_streams])


def _scatter_add_rows(out: torch.Tensor, ow: torch.Tensor,
                      rows: torch.Tensor) -> None:
    """``out[s, ow[s, j]] += rows[s, j]`` for ``out`` ``[S, n, B]``, rows
    padded to ``B`` columns."""
    s, n, b = out.shape
    if rows.shape[-1] < b:
        rows = torch.nn.functional.pad(rows, (0, b - rows.shape[-1]))
    flat = (ow + torch.arange(s, device=ow.device)[:, None] * n).reshape(-1)
    out.view(s * n, b).index_add_(0, flat, rows.reshape(-1, b))


def _me(keys: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """Each owner row's global shard id: this process's owners from
    ``lo``."""
    return torch.arange(lo, lo + keys.shape[0], device=keys.device)[:, None]


# --- array groups: offset streams ---------------------------------------------

def _array_owner(plan: GroupPlan):
    members, bases = plan.members, plan.bases
    num_shards = members[0].spec.num_shards

    def owner(keys: torch.Tensor) -> torch.Tensor:
        k = keys.to(torch.int64)
        own = torch.full(keys.shape, num_shards, dtype=torch.int64,
                         device=keys.device)
        for t, m in enumerate(members):
            in_t = (k >= bases[t]) & (k < bases[t + 1])
            shard, _ = m.spec.shard_and_local(k - bases[t])
            own = torch.where(in_t, shard, own)
        return own
    return owner


def _member_rows(plan: GroupPlan, t: int, kw: torch.Tensor,
                 lo: int = 0) -> torch.Tensor:
    """Each window key's row in member ``t``'s stacked shards (held from
    shard ``lo``) where the key is the member's and owned by the window's
    owner, else ``-1``."""
    m = plan.members[t]
    k = kw.to(torch.int64)
    shard, local = m.spec.shard_and_local(k - plan.bases[t])
    mine = (k >= plan.bases[t]) & (k < plan.bases[t + 1]) \
        & (shard == _me(kw, lo))
    return torch.where(mine, (shard - lo) * m.spec.rows_per_shard + local,
                       -1)


def _tag_array_streams(plan: GroupPlan, idxs) -> torch.Tensor:
    """Per-table id columns -> one offset-tagged int32 stream; an id its
    table rejects becomes the sentinel before the shift."""
    tagged = []
    for t, m in enumerate(plan.members):
        flat = idxs[t].reshape(-1).to(torch.int64)
        ok = (flat >= 0) & (flat < m.spec.padded_vocab)
        tagged.append(torch.where(ok, flat + plan.bases[t],
                                  dedup.FILL).to(torch.int32))
    return torch.cat(tagged)


def _groups_of(mesh, spec, batch_sharded: bool) -> int:
    return mesh.shape[spec.data_axis] if batch_sharded else 1


def _lo(plan: GroupPlan, states) -> int:
    """The first shard this process holds (every member alike)."""
    return states[plan.members[0].name].shard_lo


def _carve(plan: GroupPlan, rows: torch.Tensor, idxs):
    sizes = [i.numel() // (2 if plan.wide else 1) for i in idxs]
    segs = a2a.carve_segments(rows, sizes)
    out = []
    for t, (seg, m) in enumerate(zip(segs, plan.members)):
        lead = tuple(idxs[t].shape[:-1] if plan.wide else idxs[t].shape)
        out.append(seg[:, :m.dim].reshape(lead + (m.dim,)))
    return out


def _array_pull(mesh, plan: GroupPlan, states, idxs, batch_sharded,
                record):
    first = plan.members[0].spec
    weights = [states[m.name].weights for m in plan.members]
    bounds = _stream_bounds(plan, idxs, mesh.process_count)
    lo = _lo(plan, states)

    def resolve(req: torch.Tensor) -> torch.Tensor:
        s, n = req.shape
        out = torch.zeros((s, n, plan.bucket_dim), dtype=weights[0].dtype,
                          device=req.device)
        for t, (kw, ow) in _sorted_member_windows(req, bounds,
                                                  plan.bases[:-1]):
            ids = _member_rows(plan, t, kw, lo)
            rows = gather_rows(weights[t], ids.reshape(-1)).view(
                s, -1, plan.members[t].dim)
            _scatter_add_rows(out, ow, rows)
        return out

    rows = a2a.exchange_pull(
        _tag_array_streams(plan, idxs), resolve, _array_owner(plan),
        sentinel=dedup.FILL, dim=plan.bucket_dim, dtype=weights[0].dtype,
        num_shards=first.num_shards,
        groups=_groups_of(mesh, first, batch_sharded),
        capacity=first.a2a_capacity, slack=first.a2a_slack,
        record_stats=record, wire_dtype=first.pull_wire_dtype, mesh=mesh)
    return _carve(plan, rows, idxs)


def _pad_grads(plan: GroupPlan, grads) -> torch.Tensor:
    return torch.cat([
        torch.nn.functional.pad(g.reshape(-1, m.dim),
                                (0, plan.bucket_dim - m.dim))
        for g, m in zip(grads, plan.members)])


def _array_push(mesh, plan: GroupPlan, states, idxs, grads, batch_sharded,
                record):
    first = plan.members[0].spec
    bounds = _stream_bounds(plan, idxs, mesh.process_count)
    lo = _lo(plan, states)

    def apply_fn(keys, g, counts):
        for t, (kw, _ow, gw, cw) in _sorted_member_windows(
                keys, bounds, plan.bases[:-1], g, counts):
            m = plan.members[t]
            st = states[m.name]
            table_lib.apply_gradients(
                table_lib.TableState(weights=st.weights, slots=st.slots),
                m.optimizer, _member_rows(plan, t, kw, lo).reshape(-1),
                gw[..., :m.dim].reshape(-1, m.dim),
                in_counts=cw.reshape(-1))

    a2a.exchange_push(
        _tag_array_streams(plan, idxs), _pad_grads(plan, grads), apply_fn,
        _array_owner(plan), sentinel=dedup.FILL,
        num_shards=first.num_shards,
        groups=_groups_of(mesh, first, batch_sharded),
        capacity=first.a2a_capacity, slack=first.a2a_slack,
        record_stats=record, wire_dtype=first.push_wire_dtype, mesh=mesh)


# --- hash groups: a table-id column beside the key words ------------------------

def _hash_empty(plan: GroupPlan, states) -> Tuple[int, torch.dtype]:
    kd = states[plan.members[0].name].keys.dtype
    return hash_lib.empty_key(kd), kd


def _tag_hash_streams(plan: GroupPlan, idxs, empty: int,
                      key_dtype: torch.dtype) -> torch.Tensor:
    """Per-table key columns -> one ``[N, kw + 1]`` (key..., tag) stream
    of the tables' key dtype; an EMPTY key becomes an all-sentinel row
    (no table's traffic)."""
    tagged = []
    for t, _m in enumerate(plan.members):
        if plan.wide:
            flat = idxs[t].reshape(-1, 2)
            valid = flat[:, 1] != empty
            cols = flat
        else:
            flat = idxs[t].reshape(-1).to(key_dtype)
            valid = flat != empty
            cols = flat[:, None]
        tag = torch.where(valid, t, empty).to(cols.dtype)
        row = torch.cat([torch.where(valid[:, None], cols,
                                     torch.full_like(cols, empty)),
                         tag[:, None]], dim=1)
        tagged.append(row)
    return torch.cat(tagged)


def _hash_owner(plan: GroupPlan, kw: int):
    members = plan.members
    num_shards = members[0].spec.num_shards

    def owner(q: torch.Tensor) -> torch.Tensor:
        keyc = q[..., :kw] if plan.wide else q[..., 0]
        tag = q[..., kw]
        valid = (tag >= 0) & (tag < len(members))
        return torch.where(valid, members[0].spec.owner_shard(keyc),
                           num_shards)
    return owner


def _hash_windows(plan: GroupPlan, q: torch.Tensor, bounds, empty: int,
                  lo: int, *streams):
    """Per member: its windows' keys masked to the member's owned keys
    (EMPTY elsewhere; the owners held from shard ``lo``), and the windows
    of ``streams``."""
    kw = 2 if plan.wide else 1
    keyc_all = q[..., :kw] if plan.wide else q[..., 0]
    for t, (tag, ow, keyc, *rest) in _sorted_member_windows(
            q[..., kw], bounds, range(len(plan.members)), keyc_all,
            *streams):
        m = plan.members[t]
        mine = (tag == t) & (m.spec.owner_shard(keyc) == _me(tag, lo))
        fill = torch.full_like(keyc, empty)
        masked = torch.where(mine[..., None] if plan.wide else mine, keyc,
                             fill)
        yield t, ow, masked, rest


def _hash_pull(mesh, plan: GroupPlan, states, idxs, batch_sharded,
               record):
    first = plan.members[0].spec
    kw = 2 if plan.wide else 1
    empty, kd = _hash_empty(plan, states)
    bounds = _stream_bounds(plan, idxs, mesh.process_count)
    lo = _lo(plan, states)
    dtype = states[plan.members[0].name].weights.dtype

    def resolve(q: torch.Tensor) -> torch.Tensor:
        s, n = q.shape[:2]
        out = torch.zeros((s, n, plan.bucket_dim), dtype=dtype,
                          device=q.device)
        for t, ow, masked, _ in _hash_windows(plan, q, bounds, empty, lo):
            m = plan.members[t]
            st = states[m.name]
            rows = torch.stack([
                hash_lib.pull(st.shard(o), masked[o], m.initializer,
                              max_probes=m.spec.max_probes)
                for o in range(s)])
            _scatter_add_rows(out, ow, rows)
        return out

    rows = a2a.exchange_pull(
        _tag_hash_streams(plan, idxs, empty, kd), resolve,
        _hash_owner(plan, kw),
        sentinel=empty, dim=plan.bucket_dim, dtype=dtype,
        num_shards=first.num_shards,
        groups=_groups_of(mesh, first, batch_sharded),
        capacity=first.a2a_capacity, slack=first.a2a_slack,
        record_stats=record, wire_dtype=first.pull_wire_dtype, mesh=mesh)
    return _carve(plan, rows, idxs)


def _hash_push(mesh, plan: GroupPlan, states, idxs, grads, batch_sharded,
               record):
    first = plan.members[0].spec
    kw = 2 if plan.wide else 1
    empty, kd = _hash_empty(plan, states)
    bounds = _stream_bounds(plan, idxs, mesh.process_count)
    lo = _lo(plan, states)

    def apply_fn(q, g, counts):
        for t, _ow, masked, (gw, cw) in _hash_windows(plan, q, bounds,
                                                      empty, lo, g, counts):
            m = plan.members[t]
            st = states[m.name]
            for o in range(q.shape[0]):
                hash_lib.apply_gradients(
                    st.shard(o), m.optimizer, m.initializer, masked[o],
                    gw[o, :, :m.dim], max_probes=m.spec.max_probes,
                    in_counts=cw[o])

    a2a.exchange_push(
        _tag_hash_streams(plan, idxs, empty, kd), _pad_grads(plan, grads),
        apply_fn, _hash_owner(plan, kw), sentinel=empty,
        num_shards=first.num_shards,
        groups=_groups_of(mesh, first, batch_sharded),
        capacity=first.a2a_capacity, slack=first.a2a_slack,
        record_stats=record, wire_dtype=first.push_wire_dtype, mesh=mesh)


# --- collection-level dispatch ------------------------------------------------

def _record_group(plan: GroupPlan, idxs, itemsize: int,
                  procs: int = 1) -> None:
    """Host counters: one group exchanged and an entry-granularity byte
    estimate of its routed traffic (before dedup) over the global batch,
    ``procs`` equal slices of this process's."""
    if plan.kind == "hash":
        kc = (2 if plan.wide else 1) + 1
        n = sum(int(i.numel()) // (2 if plan.wide else 1) for i in idxs)
    else:
        kc = 1
        n = sum(int(i.numel()) for i in idxs)
    n *= procs
    nbytes = n * (plan.bucket_dim * itemsize + kc * 4)
    observability.GLOBAL.add("grouped_groups", 1)
    observability.GLOBAL.add("grouped_exchange_bytes", nbytes)
    scope.HISTOGRAMS.observe("grouped_exchange_bytes", float(nbytes))


def _bare(states, names):
    from . import hot_cache
    return {n: hot_cache.unwrap(states[n]) for n in names}


def pull_grouped(collection, states, idx_map: Dict[str, torch.Tensor], *,
                 read_only: bool = False,
                 batch_sharded: bool = True) -> Dict[str, torch.Tensor]:
    """Rows for every grouped column of ``idx_map`` (ids on the device,
    widened), one routed exchange a group: raw rows shaped as the
    per-table path's (``EmbeddingCollection.pull`` pools them)."""
    record = observability.evaluate_performance()
    host_record = record and not observability.under_trace(idx_map)
    mesh = collection.mesh
    out = {}
    for plan in plan_groups(collection, tuple(idx_map),
                            read_only=read_only):
        names = [m.name for m in plan.members]
        idxs = [idx_map[n] for n in names]
        bare = _bare(states, names)
        fn = _array_pull if plan.kind == "array" else _hash_pull
        res = observability.plane_timed(
            "pull", plan.members[0].spec.plane_label, record, fn, mesh,
            plan, bare, idxs, batch_sharded, record)
        if host_record:
            _record_group(plan, idxs, bare[names[0]].weights.element_size(),
                          mesh.process_count)
        out.update(zip(names, res))
    return out


def apply_gradients_grouped(collection, states,
                            idx_map: Dict[str, torch.Tensor],
                            grads_map: Dict[str, torch.Tensor], *,
                            batch_sharded: bool = True) -> Dict[str, Any]:
    """Push and update every grouped column, one pre-reduced exchange a
    group, each member's optimizer on its owners; in place. Returns the
    members' states."""
    record = observability.evaluate_performance()
    host_record = record and not observability.under_trace(idx_map)
    mesh = collection.mesh
    for plan in plan_groups(collection, tuple(idx_map)):
        names = [m.name for m in plan.members]
        idxs = [idx_map[n] for n in names]
        grads = [grads_map[n] for n in names]
        bare = _bare(states, names)
        fn = _array_push if plan.kind == "array" else _hash_push
        observability.plane_timed(
            "push", plan.members[0].spec.plane_label, record, fn, mesh,
            plan, bare, idxs, grads, batch_sharded, record)
        if host_record:
            _record_group(plan, idxs, bare[names[0]].weights.element_size(),
                          mesh.process_count)
    return {n: states[n] for n in idx_map}
