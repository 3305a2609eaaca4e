"""The hot-row replica cache, the ``"a2a+cache"`` plane
(``openembedding_tpu/parallel/hot_cache.py``).

A host-side decayed frequency sketch (:class:`FreqSketch`) ranks the keys
a variable sees; every ``cache_refresh_every`` steps, outside the step, the
top K are admitted and their rows and optimizer slots gathered into a
replica (:class:`HotCacheState`) held beside the table in a
:class:`CachedState`. In JAX every device holds the replica; the port's
mesh lives on one device, so it holds one.

* **Pull**: each batch is partitioned in the step by a hit mask (static
  shapes): hits are served from the replica (one row-gather kernel launch
  over its rows), the rest ride the exchange with the hits masked to the
  invalid sentinel, and the two sum (each entry is zero in one of them).
* **Push**: every sender pre-reduces its slice's hits into K bins, the
  bins are summed over the senders in mesh order (JAX's psum over the
  K rows), the replica takes the optimizer update of the rows whose count
  is not zero, and the owners' rows are written back from it, so the table
  stays authoritative and a refresh only re-gathers.

Each key's update runs once with the same totals as on ``a2a``, so the
parameters match ``a2a``'s to float-summation-order tolerance.

On a mesh across processes (``distributed.create_global_mesh``) every
process holds the whole replica, as every JAX device does, and the same
bits of it: the senders' partial sums are all-gathered in rank order and
added in mesh sender order, the one-process sum; the replica's gather
takes each key's rows from the process that owns it (one all-gather of
the owners' rows, slots and found flags); and the owners' write-back
lands on the rows a process holds. The ``Trainer`` counts the global
batch into every process's sketch, so the admitted keys agree. The
replica's buffers keep their size, and a refresh rewrites them in place
(:func:`build_cache` with ``out=``), so a captured step program stays
valid across refreshes.

Counters (gated by ``observability.evaluate_performance()``, as the
exchange's): ``cache_hits`` and ``cache_misses`` count the batch's valid
entries against the replica (each sender's slice once, so the totals are
JAX's sums over devices); ``ici_bytes_saved`` the exchange bytes the hits
skipped (row and key/count words an entry, before dedup).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import hash_table as hash_lib
from .. import table as table_lib
from ..analysis import scope
from ..ops.gather import gather_rows
from ..ops.probe_gather import probe_gather
from ..utils import observability
from . import alltoall as a2a
from . import precision

DEFAULT_CACHE_K = 512


@dataclasses.dataclass
class HotCacheState:
    """The top-K replica: ``keys`` ``[K]`` (``[K, 2]`` wide pairs) sorted
    ascending (signed order for narrow keys, unsigned 64-bit order for
    pairs) and padded with the plane's invalid sentinel; ``rows`` ``[K,
    dim]`` and ``slots`` the owners' current values for those keys."""

    keys: torch.Tensor
    rows: torch.Tensor
    slots: Dict[str, torch.Tensor]

    @property
    def k(self) -> int:
        return self.keys.shape[0]

    @property
    def wide(self) -> bool:
        return self.keys.dim() == 2


@dataclasses.dataclass
class CachedState:
    """A table and its hot-row replica, threaded as one state."""

    table: Any
    cache: HotCacheState


def unwrap(state: Any) -> Any:
    """The authoritative table of a possibly wrapped state (a replica and
    an int8_ef residual are both derived state)."""
    if isinstance(state, precision.EFState):
        return state.table
    return state.table if isinstance(state, CachedState) else state


# --- the device half ----------------------------------------------------------

def _u64_order(pairs: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` int32 (lo, hi) pairs as int64 values whose signed order
    is the pairs' unsigned 64-bit order (the hi word's sign bit flipped)."""
    hi = (pairs[..., 1].to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000
    lo = pairs[..., 0].to(torch.int64) & 0xFFFFFFFF
    hi = torch.where(hi >= 2**31, hi - 2**32, hi)
    return hi * 2**32 + lo


def lookup(cache_keys: torch.Tensor, query: torch.Tensor,
           valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query key's replica position and hit flag: ``(pos [n] int64,
    hit [n] bool)``. ``cache_keys`` is the sorted ``[K]`` (``[K, 2]``)
    key set, ``query`` ``[n]`` (``[n, 2]``), ``valid`` masks the entries
    that are keys at all (padding never hits). A left binary search over
    the sorted keys (pairs in their unsigned order), the position clamped
    to ``K - 1`` and checked for equality: static shapes."""
    k = cache_keys.shape[0]
    if cache_keys.dim() == 2:
        ck, q = _u64_order(cache_keys), _u64_order(query)
        pos = torch.clamp_max(torch.searchsorted(ck, q), k - 1)
        at = cache_keys.index_select(0, pos)
        hit = (at == query).all(dim=-1) & valid
        return pos, hit
    ck = cache_keys.to(query.dtype)
    pos = torch.clamp_max(torch.searchsorted(ck, query.contiguous()), k - 1)
    hit = (ck.index_select(0, pos) == query) & valid
    return pos, hit


def served_rows(rows: torch.Tensor, pos: torch.Tensor,
                hit: torch.Tensor) -> torch.Tensor:
    """The replica's rows for the hits, zero rows elsewhere: one launch of
    the row-gather kernel (K1) over the replica."""
    ids = torch.where(hit, pos, torch.full_like(pos, -1))
    return gather_rows(rows.contiguous(), ids)


def mask_hits(flat: torch.Tensor, hit: torch.Tensor,
              sentinel) -> torch.Tensor:
    """The hits replaced by the plane's invalid sentinel, so the residue
    rides the exchange unchanged (a mask, never a dynamic split)."""
    s = torch.full((), sentinel, dtype=flat.dtype, device=flat.device)
    if flat.dim() == 2:
        return torch.where(hit[:, None], s, flat)
    return torch.where(hit, s, flat)


def _all_gather_rows(mesh, *ts: torch.Tensor) -> list:
    """Every process's ``ts`` (tensors of one leading size), in rank
    order: ``[P, *t.shape]`` each, bit for bit, by one all-gather of
    their raw bytes side by side."""
    from .. import distributed
    n = ts[0].shape[0]
    raw = [t.contiguous().view(torch.uint8).reshape(n, -1) for t in ts]
    got = distributed.all_gather(torch.cat(raw, dim=1), mesh)
    out, c = [], 0
    for t, r in zip(ts, raw):
        w = r.shape[1]
        out.append(got[..., c:c + w].contiguous().view(t.dtype).reshape(
            (got.shape[0],) + tuple(t.shape)))
        c += w
    return out


def _spans(mesh) -> bool:
    return mesh is not None and mesh.spans_processes


def cache_pre_reduce(pos: torch.Tensor, hit: torch.Tensor,
                     grads: torch.Tensor, k: int, parts: int,
                     groups: int = 1, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K cached keys' ``(gradient sum [K, dim], count [K] int32)`` over
    the global batch: every sender pre-reduces its slice of the exchange's
    split (``alltoall.split_slice``, so no entry counts twice), then the
    partial sums add over the senders in mesh order (JAX's psum). On a
    ``mesh`` across processes ``pos``, ``hit`` and ``grads`` are this
    process's batch (``groups`` the mesh's data rows): its senders' sums
    are all-gathered in rank order first, so every process adds every
    sender's, the one-process sum bit for bit."""
    if _spans(mesh):
        groups //= mesh.process_count
    binpos = torch.where(hit, pos, torch.full_like(pos, k))
    sl_bin, m = a2a.split_slice(binpos, parts, k, groups)
    sl_g = a2a.split_slice_rows(grads, parts, groups)
    s = sl_bin.shape[0]
    dim = grads.shape[-1]
    flat_bin = (sl_bin + torch.arange(s, device=pos.device)[:, None]
                * (k + 1)).reshape(-1)
    summed = torch.zeros((s * (k + 1), dim), dtype=grads.dtype,
                         device=grads.device)
    summed.index_add_(0, flat_bin, sl_g.reshape(-1, dim))
    counts = torch.zeros(s * (k + 1), dtype=torch.int32, device=pos.device)
    counts.index_add_(0, flat_bin, (sl_bin < k).reshape(-1).to(torch.int32))
    summed = summed.view(s, k + 1, dim)[:, :k]
    counts = counts.view(s, k + 1)[:, :k]
    if _spans(mesh):
        summed, counts = _all_gather_rows(mesh, summed, counts)
        s *= mesh.process_count
        summed = summed.reshape(s, k, dim)
        counts = counts.reshape(s, k)
    total, total_c = summed[0], counts[0]
    for p in range(1, s):
        total = total + summed[p]
        total_c = total_c + counts[p]
    return total, total_c


def update_replica(optimizer, cache: HotCacheState, summed: torch.Tensor,
                   counts: torch.Tensor) -> HotCacheState:
    """The summed update applied to the replica's rows and slots, in
    place; rows of zero count stay bit-identical (the touched-rows-only
    contract)."""
    new_w, new_s = table_lib.optimizer_block_update(
        optimizer, cache.rows, cache.slots, summed, counts)
    touched = counts > 0
    cache.rows.copy_(torch.where(touched[:, None], new_w, cache.rows))
    for name, cur in cache.slots.items():
        m = touched.reshape((-1,) + (1,) * (cur.dim() - 1))
        cur.copy_(torch.where(m, new_s[name], cur))
    return cache


def write_back(table: Any, cache: HotCacheState, phys: torch.Tensor,
               counts: torch.Tensor) -> None:
    """The owners' rows and slots set from the replica where its count is
    not zero, in place: ``phys`` is each replica key's row in the stacked
    shards held (``-1`` for padding and for rows another process holds).
    A static-shape scatter (``hash_table._scatter_plan``)."""
    ok = (phys >= 0) & (counts > 0)
    plan = hash_lib._scatter_plan(ok, torch.where(ok, phys, 0))
    hash_lib._commit(table.weights, cache.rows, plan)
    for name, t in table.slots.items():
        hash_lib._commit(t, cache.slots[name], plan)


def record_cache_stats(hit: torch.Tensor, valid: torch.Tensor, *,
                       entry_bytes: int, record: bool, mesh=None) -> None:
    """Gated ``cache_hits``, ``cache_misses`` and ``ici_bytes_saved``
    (module note); the senders' slices cover the batch once, so these are
    the batch's totals (summed over the processes of a ``mesh`` across
    them, ``alltoall.record_stat``)."""
    if not record:
        return
    hits = hit.sum()
    a2a.record_stat("cache_hits", hits, record, mesh)
    a2a.record_stat("cache_misses", valid.sum() - hits, record, mesh)
    a2a.record_stat("ici_bytes_saved", hits * int(entry_bytes), record,
                    mesh)


# --- building the replica (host side, outside the step) -----------------------

def _pad_key(wide: bool, key_dtype: torch.dtype) -> int:
    return hash_lib.empty_key(torch.int32 if wide else key_dtype)


def empty_cache_like(table_state: Any, k: int, *, wide: bool = False,
                     key_dtype: torch.dtype = torch.int32) -> HotCacheState:
    """An all-padding replica (no hits: the plane is ``a2a`` until the
    first refresh admits keys) on the table's device."""
    dev = table_state.weights.device
    kshape = (k, 2) if wide else (k,)
    kd = torch.int32 if wide else key_dtype
    return HotCacheState(
        keys=torch.full(kshape, _pad_key(wide, kd), dtype=kd, device=dev),
        rows=torch.zeros((k, table_state.weights.shape[1]),
                         dtype=table_state.weights.dtype, device=dev),
        slots={name: torch.zeros((k,) + tuple(t.shape[1:]), dtype=t.dtype,
                                 device=dev)
               for name, t in table_state.slots.items()})


def attach_empty(table_state: Any, spec) -> Any:
    """``table_state`` in a :class:`CachedState` with an all-padding
    replica when ``spec`` is on the cached plane (else as it is): the one
    place the replica's pad sentinel and key dtype are derived."""
    if not getattr(spec, "is_cached", False) \
            or isinstance(table_state, CachedState):
        return table_state
    is_hash = hasattr(table_state, "keys")
    wide = bool(is_hash and table_state.keys.dim() == 2)
    return CachedState(
        table=table_state,
        cache=empty_cache_like(
            table_state, spec.cache_k, wide=wide,
            key_dtype=table_state.keys.dtype if is_hash and not wide
            else torch.int32))


def _sort_for_device(keys: np.ndarray, wide: bool) -> np.ndarray:
    """The host sort :func:`lookup` searches: signed ascending for narrow
    keys, unsigned 64-bit for wide (joined int64) keys."""
    if wide:
        return keys[np.argsort(keys.view(np.uint64), kind="stable")]
    return np.sort(keys, kind="stable")


def _as_matrix(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1)


def _gather_table(table, spec, keys: torch.Tensor):
    """``(rows, slots, found)`` of the replica keys on an array table: one
    K1 launch a field over the stacked shards held (each key at its
    owner's row; padding, out-of-range keys and keys of shards another
    process holds give zero rows, not found)."""
    from .sharded_table import held_rows
    ids = held_rows(spec, table, keys)
    rows = gather_rows(table.weights, ids)
    slots = {name: gather_rows(_as_matrix(t), ids).reshape(
        (keys.shape[0],) + tuple(t.shape[1:]))
        for name, t in table.slots.items()}
    return rows, slots, ids >= 0


def _gather_hash(table, spec, keys: torch.Tensor):
    """``(rows, slots, found)`` of the replica keys on a hash table: every
    shard held probes the keys it owns with the probe-gather kernel (K2),
    one launch a field, and the owners' rows add up (the others are
    zero)."""
    from .sharded_hash import _mask_non_owned
    c = table.capacity_per_shard
    bsz, _nb, chain = hash_lib.table_layout(c, spec.max_probes)
    empty = hash_lib.empty_key(table.keys.dtype)
    rows = None
    slots: Dict[str, torch.Tensor] = {}
    found = None
    for j, s in enumerate(table.held):
        q = _mask_non_owned(spec, keys, s).contiguous()
        tk = table.keys[j * c:(j + 1) * c]
        r, hit = probe_gather(tk, table.weights[j * c:(j + 1) * c], q,
                              chain=chain, bucket=bsz, empty=empty)
        rows = r if rows is None else rows + r
        found = hit if found is None else found | hit
        for name, t in table.slots.items():
            block = _as_matrix(t[j * c:(j + 1) * c])
            sr, _ = probe_gather(tk, block, q, chain=chain, bucket=bsz,
                                 empty=empty)
            sr = sr.reshape((keys.shape[0],) + tuple(t.shape[1:]))
            slots[name] = sr if name not in slots else slots[name] + sr
    return rows, slots, found


def _merge_owned(mesh, rows: torch.Tensor, slots: Dict[str, torch.Tensor],
                 found: torch.Tensor):
    """Across processes: each key's rows and slots from the process that
    found it (one owner a key; where none did, the zero rows every
    process holds) and ``found`` over all of them, the same bits on every
    process (one all-gather); in one process as they are."""
    if not _spans(mesh):
        return rows, slots, found
    names = list(slots)
    got = _all_gather_rows(mesh, found.to(torch.uint8), rows,
                          *[slots[n] for n in names])
    hit = got[0].bool()
    merged = [t[0] for t in got[1:]]
    for p in range(1, mesh.process_count):
        for i, t in enumerate(got[1:]):
            m = hit[p].reshape((-1,) + (1,) * (t.dim() - 2))
            merged[i] = torch.where(m, t[p], merged[i])
    return merged[0], dict(zip(names, merged[1:])), hit.any(dim=0)


def build_cache(table_state: Any, candidates: np.ndarray, k: int, *,
                spec, out: Optional[HotCacheState] = None,
                mesh=None) -> HotCacheState:
    """Admit up to ``k`` candidate keys (host keys ranked by the caller:
    joined int64 for wide tables): pad, sort, gather their rows and slots.
    Hash candidates absent from the table are dropped and the rest
    gathered again (a replica must never shadow the init-row contract of
    an unseen key); array keys are always present. ``out``: a replica of
    the same K whose buffers take the result in place (a captured step
    keeps them); else new ones. On a ``mesh`` across processes every
    process passes the same candidates and gets the same replica: each
    key's rows come from its owner's process (:func:`_merge_owned`), so
    the drop of absent keys is decided alike everywhere."""
    from .sharded_hash import HashShardingSpec
    is_hash = isinstance(spec, HashShardingSpec)
    wide = bool(is_hash and spec.wide)
    dev = table_state.weights.device
    cand = np.asarray(candidates).ravel()[:k]
    if wide:
        pad = np.int64(np.uint64(0x8000000080000000))   # the EMPTY pair
    else:
        kd = np.dtype(str(table_state.keys.dtype).replace("torch.", "")) \
            if is_hash else np.dtype(np.int32)
        pad = np.iinfo(kd).min

    def _pack(keys64: np.ndarray):
        if wide:
            full = np.full((k,), pad, np.int64)
            full[:keys64.size] = keys64.astype(np.int64)
            full = _sort_for_device(full, wide=True)
            return full, hash_lib.split64(full)
        full = np.full((k,), pad, kd)
        full[:keys64.size] = keys64.astype(kd)
        full = _sort_for_device(full, wide=False)
        return full, full

    gather = _gather_hash if is_hash else _gather_table
    packed, device_keys = _pack(cand)
    for _ in range(2):
        dk = torch.from_numpy(np.ascontiguousarray(device_keys)).to(dev)
        rows, slots, found = _merge_owned(
            mesh, *gather(table_state, spec, dk))
        found_np = found.cpu().numpy()
        if (found_np | (packed == pad)).all():
            break
        packed, device_keys = _pack(packed[found_np])
    if out is None:
        return HotCacheState(keys=dk, rows=rows, slots=slots)
    out.keys.copy_(dk)
    out.rows.copy_(rows)
    for name, t in out.slots.items():
        t.copy_(slots[name])
    return out


# --- admission (host side) ------------------------------------------------------

# a bounded vocabulary up to this many rows keeps exact float32 counts
# (<= 256 MB of host memory); larger or unbounded key spaces use the dict
DENSE_SKETCH_MAX = 1 << 26


class FreqSketch:
    """Decayed per-key frequency counts that drive admission (JAX's, in
    numpy): a flat float32 array for a bounded vocabulary up to
    :data:`DENSE_SKETCH_MAX` rows (``update`` one ``np.add.at``), else a
    dict of exact counts pruned below ``prune_below`` and cut to its
    hottest half past ``max_entries``. Both decay by ``decay`` once a
    refresh window."""

    # nominal CPython bytes of one dict entry (the memory gauges)
    DICT_ENTRY_NOMINAL_BYTES = 100
    # entries counted a batch at most: a stride sample keeps the ranks
    SAMPLE_CAP = 16384

    def __init__(self, decay: float = 0.8, prune_below: float = 0.5,
                 max_entries: int = 1 << 20,
                 dense_vocab: Optional[int] = None):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay_factor = float(decay)
        self.prune_below = float(prune_below)
        self.max_entries = int(max_entries)
        self._counts: Dict[int, float] = {}
        self._sample_phase = 0
        self._dense: Optional[np.ndarray] = None
        if dense_vocab is not None and 0 < dense_vocab <= DENSE_SKETCH_MAX:
            self._dense = np.zeros(int(dense_vocab), np.float32)

    def __len__(self) -> int:
        if self._dense is not None:
            return int(np.count_nonzero(self._dense))
        return len(self._counts)

    def approx_bytes(self) -> int:
        """Host memory the sketch holds: exact for the dense array,
        nominal a dict entry."""
        if self._dense is not None:
            return int(self._dense.nbytes)
        return len(self._counts) * self.DICT_ENTRY_NOMINAL_BYTES

    def update(self, keys) -> None:
        """Count one batch's keys (stride-sampled past
        :attr:`SAMPLE_CAP` entries, the phase rotating a call so that a
        structured layout's every residue is visited)."""
        flat = np.asarray(keys).ravel()
        if flat.size > self.SAMPLE_CAP:
            stride = flat.size // self.SAMPLE_CAP + 1
            phase = self._sample_phase % stride
            self._sample_phase += 1
            flat = flat[phase::stride]
        if self._dense is not None:
            np.add.at(self._dense, flat.astype(np.int64), 1.0)
            return
        u, c = np.unique(flat, return_counts=True)
        counts = self._counts
        get = counts.get
        for key, n in zip(u.tolist(), c.tolist()):
            counts[key] = get(key, 0.0) + n
        if len(counts) > self.max_entries:
            ks = np.fromiter(counts.keys(), np.int64, len(counts))
            vs = np.fromiter(counts.values(), np.float64, len(counts))
            keep = self.max_entries // 2
            sel = np.argpartition(-vs, keep - 1)[:keep]
            self._counts = dict(zip(ks[sel].tolist(), vs[sel].tolist()))

    def decay(self) -> None:
        f = self.decay_factor
        if self._dense is not None:
            self._dense *= f
            self._dense[self._dense < self.prune_below] = 0.0
            return
        floor = self.prune_below
        self._counts = {key: v * f for key, v in self._counts.items()
                        if v * f >= floor}

    def topk(self, k: int) -> np.ndarray:
        """The ``k`` highest-count keys (count descending, key ascending
        on ties), int64; a zero count never qualifies."""
        if self._dense is not None:
            d = self._dense
            nz = np.flatnonzero(d)
            k_eff = min(k, nz.size)
            if k_eff == 0:
                return np.empty((0,), np.int64)
            vals = d[nz]
            sel = np.argpartition(-vals, k_eff - 1)[:k_eff] \
                if k_eff < nz.size else np.arange(nz.size)
            idx = nz[sel]
            order = np.lexsort((idx, -d[idx]))
            return idx[order].astype(np.int64)
        items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return np.asarray([key for key, _ in items[:k]], np.int64)


class HotCacheManager:
    """One cached variable's admission driver: :meth:`observe` each
    stepped batch, :meth:`refresh` the replica every ``refresh_every``
    steps, outside the step (the ``Trainer`` does both for every
    ``"a2a+cache"`` variable)::

        mgr.observe(batch_ids)
        if mgr.due:
            state = mgr.refresh(state)   # the same CachedState, refilled
    """

    def __init__(self, *, spec, k: int = DEFAULT_CACHE_K,
                 refresh_every: int = 64, decay: float = 0.8,
                 name: str = "", mesh=None):
        from .sharded_hash import HashShardingSpec
        self.spec = spec
        # a mesh across processes: refreshes gather from every process
        self.mesh = mesh
        self.name = name
        self.k = int(k)
        self.refresh_every = max(1, int(refresh_every))
        self._is_hash = isinstance(spec, HashShardingSpec)
        self._wide = bool(self._is_hash and spec.wide)
        self.sketch = FreqSketch(
            decay=decay,
            dense_vocab=None if self._is_hash else spec.padded_vocab)
        self._owns_sketch = True
        self._since = 0
        self.refreshes = 0
        self.last_replica_bytes = 0
        self.last_refresh_s = 0.0
        observability.register_memory_source("hot_cache", name or "cache",
                                             self)

    def memory_stats(self) -> Dict[str, float]:
        """The sketch's host memory and the replica's device bytes (keys,
        rows, slots) at the last refresh."""
        return {
            "replica_bytes": float(self.last_replica_bytes),
            "sketch_bytes": float(self.sketch.approx_bytes()),
            "sketch_keys": float(len(self.sketch)),
            "refreshes": float(self.refreshes),
        }

    def share_sketch(self, other: "HotCacheManager") -> None:
        """Count into ``other``'s sketch: twins fed by one id column
        (``name`` and ``name:linear``) pay the count once; the sharer no
        longer decays it and advances its clock with :meth:`tick`."""
        self.sketch = other.sketch
        self._owns_sketch = False

    def tick(self) -> None:
        """Advance the refresh clock without counting (the column went
        into a shared sketch this step)."""
        self._since += 1

    def _valid_keys(self, ids) -> np.ndarray:
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        arr = np.asarray(ids)
        if self._wide and arr.ndim >= 2 and arr.shape[-1] == 2:
            # a trailing dim of 2 on a wide table is a (lo, hi) pair axis
            arr = hash_lib.join64(arr.reshape(-1, 2))
        arr = arr.ravel().astype(np.int64)
        if not self._is_hash:
            return arr[(arr >= 0) & (arr < self.spec.padded_vocab)]
        if self._wide:
            # the EMPTY band: hi word == INT32_MIN
            return arr[(arr >> np.int64(32))
                       != np.int64(np.iinfo(np.int32).min)]
        return arr[(arr != np.iinfo(np.int32).min)
                   & (arr != np.iinfo(np.int64).min)]

    def observe(self, ids) -> None:
        keys = self._valid_keys(ids)
        if keys.size:
            self.sketch.update(keys)
        self._since += 1

    @property
    def due(self) -> bool:
        return self._since >= self.refresh_every

    def refresh(self, state: CachedState) -> CachedState:
        """Admit the current top K into ``state``'s replica, in place: a
        re-gather from the authoritative table, never a write-back.
        Returns ``state``."""
        import time
        t0 = time.perf_counter()
        with scope.span("cache.refresh"):
            self._since = 0
            self.refreshes += 1
            cand = self.sketch.topk(self.k)
            if self._owns_sketch:
                self.sketch.decay()
            cache = build_cache(state.table, cand, self.k, spec=self.spec,
                                out=state.cache, mesh=self.mesh)
            self.last_replica_bytes = int(
                cache.keys.nbytes + cache.rows.nbytes
                + sum(v.nbytes for v in cache.slots.values()))
        self.last_refresh_s = time.perf_counter() - t0
        return state
