"""Hash-table embedding variant for unbounded key spaces
(``openembedding_tpu/hash_table.py``), single device.

A static-capacity open-addressing table: ``keys`` holds the EMPTY sentinel
(``INT32_MIN``) in free slots, ``weights`` and optimizer ``slots`` are
parallel ``[capacity, ...]`` tensors as in the array table. The slot space
is cut into buckets of 128 slots; a key hashes to a start bucket and may
overflow into the next buckets of its chain (``max_probes / 128`` buckets),
so a lookup compares one contiguous, bucket-aligned window of keys. Slots
are never freed, so a key only sits in bucket ``b + j`` when buckets
``b .. b + j - 1`` were full when it was inserted, and the window scan is
exact.

Keys are ``[capacity]`` int32 (``key_dtype="int32"``), ``[capacity]``
int64 (``key_dtype="int64"``, EMPTY = ``INT64_MIN``) or, the default for
hash variables, ``[capacity, 2]`` int32 (lo, hi) pairs that carry the full
64-bit key space (``key_dtype="wide"``; a slot is free when its hi word is
EMPTY). The functions here compute exactly what the JAX package's do:
``probe_starts`` gives the same start slot and ``find_or_insert`` places
keys in the same slots as the JAX one-device table, so a state copied from
either package answers the same. torch has no general uint32 arithmetic:
the 32-bit mixing runs in int64 and masks to 32 bits, and products are
split so that no intermediate passes 2^63; the 64-bit mixing of int64
keys multiplies in int64, whose wrapping product has the bits of JAX's
uint64 one.

Pulls go through the probe-gather kernel of ``ops/probe_gather.py`` (K2).
The read-only pull (the serving contract, ``initializer=None``) gives
zero rows for missing keys; the training pull gives a missing key its
deterministic init row, drawn from the table's threefry key
(``init_rng``) folded with the key, by the init-rows kernel of
``ops/init_rows.py`` (KI): the same rows JAX's ``init_rows`` draws.
``apply_gradients`` (the push) dedups, finds or inserts its keys through
the find-or-insert kernels of ``ops/find_or_insert.py`` (K3), gives the
inserted keys those init rows, runs the optimizer over the touched rows
and writes them back, with static shapes and no device-to-host read.
An int64 key's init row folds its low 32 bits only (``jax.random.fold_in``
casts its data to uint32), so keys ``2^40 + 1`` and ``1`` draw the same
row, as in JAX.
``find_or_insert``, ``insert_rows`` and ``apply_gradients`` update the
table in place (the JAX functions return new arrays): a checkpoint load
streams many chunks into one table, and a copy per chunk would double the
table's memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import table as table_lib
from .meta import EmbeddingVariableMeta
from .ops import dedup
from .ops.find_or_insert import find_or_insert as _find_or_insert_kernel
from .ops.init_rows import init_rows as _init_rows_kernel
from .ops.probe_gather import probe_gather
from .optim.initializers import (Initializer, make_initializer,
                                 threefry_key)
from .optim.optimizers import make_optimizer
from .table import resolve_dtype
from .utils import observability
from .utils.device import DeviceLike, resolve_device

BUCKET = 128              # slots per bucket
DEFAULT_MAX_PROBES = 256  # probed slots per lookup (2-bucket chain)

_MASK32 = 0xFFFFFFFF


KEY_DTYPES = ("wide", "int32", "int64")


def empty_key(dtype) -> int:
    """The EMPTY sentinel of a key dtype (torch or numpy): its minimum."""
    if isinstance(dtype, torch.dtype):
        return int(torch.iinfo(dtype).min)
    return int(np.iinfo(dtype).min)


def is_wide(keys) -> bool:
    """[n, 2] (lo, hi) pair keys vs plain [n] keys."""
    return keys.ndim == 2


# --- wide (64-bit) keys as int32 pairs ----------------------------------------

def split64(keys64: np.ndarray) -> np.ndarray:
    """Host helper: int64 numpy keys -> [..., 2] int32 (lo, hi) pairs."""
    k = np.asarray(keys64, np.int64)
    return np.stack([(k & 0xFFFFFFFF).astype(np.uint32).view(np.int32),
                     (k >> 32).astype(np.int32)], axis=-1)


def join64(pairs: np.ndarray) -> np.ndarray:
    """Host helper: [..., 2] int32 pairs -> int64 numpy keys."""
    p = np.asarray(pairs)
    lo = p[..., 0].view(np.uint32).astype(np.uint64)
    hi = p[..., 1].astype(np.int64)
    return (hi << np.int64(32)) | lo.astype(np.int64)


def widen_ids(ids: torch.Tensor) -> torch.Tensor:
    """Narrow integer ids (any shape) -> ``[..., 2]`` int32 (lo, hi) pairs.

    Each id becomes the pair encoding of its sign-extended 64-bit value;
    the narrow dtype's own minimum (the framework-wide invalid id) maps to
    the EMPTY pair, so invalid ids stay invalid across the widening.
    """
    empty = empty_key(torch.int32)
    if ids.element_size() == 8:
        ids = ids.to(torch.int64)
        lo = ids & _MASK32
        lo = torch.where(lo >= 2**31, lo - 2**32, lo).to(torch.int32)
        hi = (ids >> 32).to(torch.int32)
        invalid = ids == torch.iinfo(torch.int64).min
    else:
        ids = ids.to(torch.int32)
        lo = ids
        hi = ids >> 31             # arithmetic: 0 or -1 (sign extension)
        invalid = ids == empty
    pair = torch.stack([lo, hi], dim=-1)
    return torch.where(invalid[..., None], torch.full_like(pair, empty), pair)


def pair_mod(pairs: torch.Tensor, g: int) -> torch.Tensor:
    """``join64(pairs) mod g`` in [0, g): the shard-owner rule for wide keys
    (the same value as the narrow rule ``id % g`` on the joined key)."""
    if not 0 < g < (1 << 15):
        raise ValueError(f"shard count {g} out of range [1, 2^15)")
    hi = pairs[..., 1].to(torch.int64)
    lo = pairs[..., 0].to(torch.int64) & _MASK32
    return ((hi % g) * ((1 << 32) % g) + lo % g) % g


# --- probe geometry and hashing -----------------------------------------------

def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """``u * c mod 2^32`` for int64 ``u`` in [0, 2^32): the product is split
    at 16 bits of ``c`` so that no intermediate passes 2^48."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _shr64(u: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits (uint64 ``u >> r``)."""
    return (u >> r) & ((1 << (64 - r)) - 1)


def _signed64(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _mix64(keys: torch.Tensor) -> torch.Tensor:
    """64-bit avalanche (the splitmix64/murmur3 finalizer) of int64 keys,
    as the int64 of the uint64 result's bits: int64 products wrap as
    uint64 ones do."""
    u = keys.to(torch.int64)
    u = (u ^ _shr64(u, 33)) * _signed64(0xFF51AFD7ED558CCD)
    u = (u ^ _shr64(u, 33)) * _signed64(0xC4CEB9FE1A85EC53)
    return u ^ _shr64(u, 33)


def _umod64(u: torch.Tensor, d: int) -> torch.Tensor:
    """``uint64(u) % d`` for int64 bits ``u`` and ``0 < d < 2^31``, from
    the two 32-bit halves."""
    hi = _shr64(u, 32)
    lo = u & _MASK32
    return ((hi % d) * ((1 << 32) % d) + lo % d) % d


def _mix(keys: torch.Tensor) -> torch.Tensor:
    """Avalanche of int32 keys (32-bit murmur3 finalizer, as int64 values
    in [0, 2^32)) or of int64 keys (:func:`_mix64`'s bits)."""
    if keys.element_size() == 8:
        return _mix64(keys)
    u = keys.to(torch.int64) & _MASK32
    u = _mul32(u ^ (u >> 16), 0x85EBCA6B)
    u = _mul32(u ^ (u >> 13), 0xC2B2AE35)
    return u ^ (u >> 16)


def _mix_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche over a key pair, as int64 values in [0, 2^32)."""
    a = lo.to(torch.int64) & _MASK32
    b = hi.to(torch.int64) & _MASK32
    h = a ^ _mul32(b, 0x9E3779B9)
    h = _mul32(h ^ (h >> 16), 0x85EBCA6B)
    h = h ^ b
    h = _mul32(h ^ (h >> 13), 0xC2B2AE35)
    return h ^ (h >> 16)


def table_layout(capacity: int, max_probes: int) -> Tuple[int, int, int]:
    """(bucket_size, num_buckets, chain_buckets) of a table's slot space.
    Tables smaller than ``BUCKET`` are one whole-table bucket."""
    b = min(BUCKET, capacity)
    if capacity % b:
        raise ValueError(
            f"hash-table capacity {capacity} is not a multiple of the "
            f"bucket size {b}; use round_capacity() when allocating")
    nb = capacity // b
    chain = max(1, min(max_probes // b, nb))
    return b, nb, chain


def round_capacity(capacity: int) -> int:
    """Round a requested capacity up to the bucket granularity."""
    if capacity >= BUCKET:
        return -(-capacity // BUCKET) * BUCKET
    return capacity


def probe_window(capacity: int, max_probes: int) -> int:
    """Total probed slots per lookup (chain_buckets * bucket_size)."""
    b, _nb, chain = table_layout(capacity, max_probes)
    return b * chain


def window_starts(keys: torch.Tensor, num_buckets: int, chain: int,
                  bucket: int) -> torch.Tensor:
    """First probe slot per key (int64), bucket-aligned:
    ``mix(key) % (num_buckets - chain + 1) * bucket``, so the whole chain
    fits without wrapping."""
    span = num_buckets - chain + 1
    if not is_wide(keys) and keys.element_size() == 8:
        # JAX takes the uint64 mix modulo the span in uint64
        return _umod64(_mix64(keys), span) * bucket
    mixed = _mix_pair(keys[:, 0], keys[:, 1]) if is_wide(keys) \
        else _mix(keys)
    return (mixed % span) * bucket


def probe_starts(keys: torch.Tensor, capacity: int,
                 max_probes: int) -> torch.Tensor:
    """First probe SLOT per key, as ``hash_table.probe_starts`` computes it
    (int64 here, int32 there)."""
    b, nb, chain = table_layout(capacity, max_probes)
    return window_starts(keys, nb, chain, b)


def check_key_dtype(table_keys: torch.Tensor,
                    query: torch.Tensor) -> torch.Tensor:
    """Cast query keys to the table's key dtype, refusing silent truncation
    and a wide/narrow shape mismatch (``hash_table.check_key_dtype``): an
    int64 table takes int32 queries, sign-extended; an int32 table
    refuses int64 ones."""
    if is_wide(table_keys) != is_wide(query):
        raise ValueError(
            f"key-shape mismatch: table keys {tuple(table_keys.shape)} vs "
            f"query {tuple(query.shape)} — wide (64-bit pair) tables take "
            "[n, 2] int32 queries (hash_table.split64)")
    if query.dtype.is_floating_point or query.dtype == torch.bool:
        raise TypeError(f"hash keys must be integers, got {query.dtype}")
    if query.element_size() > table_keys.element_size():
        raise ValueError(
            f"query keys are {query.dtype} but the table stores "
            f"{table_keys.dtype} keys; create the table with "
            "key_dtype='wide' (pair keys) for the 64-bit key space")
    return query.to(table_keys.dtype)


def _wide_query(keys: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Validate + flatten a wide-table query to [n, 2] pairs."""
    if indices.ndim < 2 or indices.shape[-1] != 2:
        raise ValueError(
            f"key-shape mismatch: wide (64-bit pair) tables take [..., 2] "
            f"int32 queries (hash_table.split64), got "
            f"{tuple(indices.shape)}")
    return check_key_dtype(keys, indices.reshape(-1, 2))


# --- state ---------------------------------------------------------------------

@dataclasses.dataclass
class HashTableState:
    """One hash table: keys, weights, optimizer slots, the threefry key of
    its per-key init rows (two uint32 words, held on the host so that a
    launch reads no device value; an offload cache holds them in a ``[2]``
    int32 device tensor instead, which its eviction rewrites in place and
    the init-rows kernel reads, ``offload.ShardedOffloadedTable.adopt``),
    and the count of keys an insert could not place (a probe-window
    overflow)."""

    keys: torch.Tensor                    # [capacity] or [capacity, 2]
    weights: torch.Tensor                 # [capacity, dim]
    slots: Dict[str, torch.Tensor]        # each [capacity, ...]
    init_rng: Any                         # jax.random key words
    insert_failures: torch.Tensor         # int64 scalar on the device

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def dim(self) -> int:
        return self.weights.shape[1]

    @property
    def wide(self) -> bool:
        return is_wide(self.keys)

    def live(self) -> torch.Tensor:
        """[capacity] bool: slots that hold a key."""
        empty = empty_key(self.keys.dtype)
        return (self.keys[:, 1] if self.wide else self.keys) != empty

    def num_used(self) -> int:
        return int(self.live().sum())


def create_hash_table(meta: EmbeddingVariableMeta,
                      optimizer: Any,
                      *,
                      capacity: int,
                      rng: Optional[Tuple[int, int]] = None,
                      key_dtype: str = "int32",
                      device: DeviceLike = None) -> HashTableState:
    """An empty hash table on ``device`` (cuda unless named), capacity
    rounded up to the bucket granularity. ``rng``: the two words of the
    threefry key its init rows fold each key into (default
    ``jax.random.PRNGKey(0)``'s). ``key_dtype``: ``"wide"`` for
    [capacity, 2] pair keys, ``"int32"`` or ``"int64"`` for plain keys
    (EMPTY the dtype's minimum)."""
    if key_dtype not in KEY_DTYPES:
        raise ValueError(f"unknown hash key_dtype {key_dtype!r}; known: "
                         f"{KEY_DTYPES}")
    device = resolve_device(device)
    optimizer = make_optimizer(optimizer)
    capacity = round_capacity(capacity)
    dtype = resolve_dtype(meta)
    dim = meta.embedding_dim
    shape = (capacity, 2) if key_dtype == "wide" else (capacity,)
    kdt = torch.int64 if key_dtype == "int64" else torch.int32
    keys = torch.full(shape, empty_key(kdt), dtype=kdt, device=device)
    weights = torch.zeros((capacity, dim), dtype=dtype, device=device)
    slots = optimizer.init_slots(capacity, dim, dtype, device)
    return HashTableState(keys=keys, weights=weights, slots=slots,
                          init_rng=threefry_key(rng),
                          insert_failures=torch.zeros(
                              (), dtype=torch.int64, device=device))


def init_rows(initializer: Any, base_rng: Tuple[int, int],
              keys: torch.Tensor, dim: int, dtype: torch.dtype
              ) -> torch.Tensor:
    """Deterministic initializer row per key (``[n]`` int32 or int64, or
    ``[n, 2]`` pairs): the key folded into ``base_rng``, wide keys both
    words, so their rows depend on the full 64-bit key; an int64 key
    folds its low 32 bits, as ``jax.random.fold_in`` does. ``[n, dim]`` of ``dtype``; one
    init-rows kernel launch on a CUDA device."""
    n = keys.shape[0]
    out = torch.zeros((n, dim), dtype=dtype, device=keys.device)
    skip = torch.zeros(n, dtype=torch.bool, device=keys.device)
    return _init_rows_kernel(out, keys.contiguous(), skip, base_rng,
                             make_initializer(initializer))


# --- probe and insert ----------------------------------------------------------

def _bucket_rows(table_keys: torch.Tensor, nb: int, bsz: int,
                 bkts: torch.Tensor) -> torch.Tensor:
    """Key rows of buckets ``bkts`` (any shape): ``bkts.shape + (bsz,)``
    (+ ``(2,)`` for pair keys)."""
    view = table_keys.view((nb, bsz) + tuple(table_keys.shape[1:]))
    return view[bkts]


def _match(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """rows [n, W(, 2)] against query [n(, 2)] -> [n, W] bool."""
    if is_wide(query):
        return ((rows[..., 0] == query[:, None, 0])
                & (rows[..., 1] == query[:, None, 1]))
    return rows == query[:, None]


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when there is none)."""
    return torch.argmax(mask.to(torch.uint8), dim=1)


def find_rows(table_keys: torch.Tensor, query: torch.Tensor,
              max_probes: int = DEFAULT_MAX_PROBES) -> torch.Tensor:
    """Slot index (int64) for each query key, or -1 when absent or EMPTY.
    Gathers each query's window of bucket rows, then the first match."""
    query = check_key_dtype(table_keys, query)
    capacity = table_keys.shape[0]
    n = query.shape[0]
    bsz, nb, chain = table_layout(capacity, max_probes)
    h = window_starts(query, nb, chain, bsz)
    bkts = (h // bsz)[:, None] + torch.arange(chain, device=h.device)
    rows = _bucket_rows(table_keys, nb, bsz, bkts)
    rows = rows.reshape((n, chain * bsz) + tuple(table_keys.shape[1:]))
    match = _match(rows, query)
    empty = empty_key(table_keys.dtype)
    valid = (query[:, 1] if is_wide(query) else query) != empty
    hit = match.any(dim=1) & valid
    return torch.where(hit, h + _first(match), -1)


def _scatter_plan(ok: torch.Tensor, slot: torch.Tensor):
    """Where each entry of a sync-free scatter writes.

    Boolean-mask indexing reads its size back to the host, so every entry
    writes: an ``ok`` entry its own ``slot``; any other entry copies an
    ``ok`` entry, slot and value, the ok entries taken in turn (rank
    ``p mod n_ok``), so no slot receives two different values and none
    takes many writes (``index_copy_`` keeps an arbitrary one of
    duplicates). Returns ``(src, dst, any_ok)``: entry ``p`` writes
    ``values[src[p]]`` to ``dst[p]``; with no ok entry all write slot 0's
    own value back (:func:`_commit`).
    """
    n = ok.shape[0]
    pos = torch.arange(n, device=ok.device)
    rank = torch.cumsum(ok, 0) - 1
    n_ok = rank[-1] + 1
    ok_pos = torch.zeros(n + 1, dtype=torch.int64, device=ok.device)
    ok_pos.scatter_(0, torch.where(ok, rank, n), pos)
    src = torch.where(ok, pos, ok_pos[pos % torch.clamp_min(n_ok, 1)])
    any_ok = n_ok > 0
    dst = torch.where(any_ok, slot.index_select(0, src), 0)
    return src, dst, any_ok


def _commit(table: torch.Tensor, values: torch.Tensor, plan) -> None:
    """``table[dst] = values[src]`` by the plan of :func:`_scatter_plan`,
    in place, cast to the table's dtype."""
    src, dst, any_ok = plan
    rows = values.index_select(0, src).to(table.dtype)
    rows = torch.where(any_ok, rows, table[:1])
    table.index_copy_(0, dst, rows)


def find_or_insert(table_keys: torch.Tensor, new_keys: torch.Tensor,
                   valid: torch.Tensor,
                   max_probes: int = DEFAULT_MAX_PROBES
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Find each (unique) key's slot, inserting missing keys IN PLACE:
    :func:`find_or_insert_reference`'s answer and placement. CPU tensors
    run that plain version; CUDA tensors the K3 kernels of
    ``ops/find_or_insert.py``, which resolve every key by a window scan
    and rank only the keys that missed. Returns ``(table_keys, slot [n]
    (-1 = failed), inserted [n], failed [n])``."""
    return _find_or_insert_kernel(table_keys, new_keys, valid, max_probes)


def find_or_insert_reference(table_keys: torch.Tensor,
                             new_keys: torch.Tensor, valid: torch.Tensor,
                             max_probes: int = DEFAULT_MAX_PROBES
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor, torch.Tensor]:
    """Find each (unique) key's slot, inserting missing keys IN PLACE: the
    plain version, in PyTorch operations on any device.

    One pass per chain level: every unplaced key probes its level-j bucket,
    matches an existing entry, or else contenders for the same bucket are
    ranked (stable sort by bucket id) and rank r takes the bucket's
    (r+1)-th free slot; keys ranked past the free count overflow to the
    next level. Step for step the JAX algorithm, so keys land in the same
    slots. No step reads the device back (the placed keys are written by
    :func:`_scatter_plan`'s rule). Returns ``(table_keys, slot [n] (-1 =
    failed), inserted [n], failed [n])``.
    """
    capacity = table_keys.shape[0]
    n = new_keys.shape[0]
    dev = table_keys.device
    empty = empty_key(table_keys.dtype)
    wide = is_wide(table_keys)
    bsz, nb, chain = table_layout(capacity, max_probes)
    b0 = window_starts(new_keys, nb, chain, bsz) // bsz
    ids = torch.arange(n, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    done = ~valid
    inserted = torch.zeros(n, dtype=torch.bool, device=dev)
    if n == 0:
        return table_keys, slot, inserted, inserted.clone()
    for j in range(chain):
        bj = b0 + j
        start = bj * bsz
        rows = _bucket_rows(table_keys, nb, bsz, bj)
        match = _match(rows, new_keys)
        emptym = (rows[..., 1] if wide else rows) == empty
        active = valid & ~done
        # already present (keys are unique: at most one slot matches)
        hitm = active & match.any(dim=1)
        slot = torch.where(hitm, start + _first(match), slot)
        done = done | hitm
        active = active & ~hitm
        # rank contenders within each bucket
        bid = torch.where(active, bj, nb)
        order = torch.argsort(bid, stable=True)
        sorted_bid = bid[order]
        # a group starts at the first sorted position of its bucket id
        group_start = torch.searchsorted(sorted_bid, sorted_bid)
        rank = torch.empty_like(ids).scatter_(0, order, ids - group_start)
        # rank r takes the (r+1)-th free slot of the bucket; the count of
        # free slots up to each slot runs down the [bsz, n] transpose, one
        # thread a key (a scan along each 128-slot row is far slower)
        cum = torch.cumsum(emptym.t(), dim=0, dtype=torch.int32).t()
        place = active & (rank < cum[:, -1])
        pslot = start + _first((cum == rank[:, None] + 1) & emptym)
        _commit(table_keys, new_keys, _scatter_plan(place, pslot))
        slot = torch.where(place, pslot, slot)
        done = done | place
        inserted = inserted | place
    failed = valid & ~done
    return table_keys, slot, inserted, failed


def _flat_keys(state: HashTableState, indices: torch.Tensor):
    """A query as flat keys of the table's dtype and their validity (not
    EMPTY): ``[n, 2]`` pairs on a wide table, ``[n]`` keys otherwise."""
    empty = empty_key(state.keys.dtype)
    if state.wide:
        flat = _wide_query(state.keys, indices)
        return flat, flat[:, 1] != empty
    flat = check_key_dtype(state.keys, indices.reshape(-1))
    return flat, flat != empty


def insert_rows(state: HashTableState,
                keys: torch.Tensor,
                weights: torch.Tensor,
                slot_rows: Optional[Dict[str, torch.Tensor]] = None,
                max_probes: int = DEFAULT_MAX_PROBES) -> HashTableState:
    """Set rows (and optimizer-state rows) for keys, inserting missing
    keys: the checkpoint load path. Updates ``state`` in place and returns
    it. ``keys`` must be unique; EMPTY keys are skipped; keys that find no
    free slot in their window are counted in ``insert_failures``."""
    keys, valid = _flat_keys(state, keys)
    if keys.shape[0] == 0:
        return state
    _, slot, _inserted, failed = find_or_insert(state.keys, keys, valid,
                                                max_probes)
    plan = _scatter_plan(valid & (slot >= 0), slot)
    _commit(state.weights, weights, plan)
    for name, rows in (slot_rows or {}).items():
        _commit(state.slots[name], rows, plan)
    state.insert_failures += failed.sum()
    return state


def pull(state: HashTableState, indices: torch.Tensor,
         initializer: Any = None,
         max_probes: int = DEFAULT_MAX_PROBES) -> torch.Tensor:
    """Rows for keys of any shape (``[..., 2]`` pairs on a wide table).

    A stored key gives its row. A missing key gives its deterministic
    init row (:func:`init_rows`), or a zero row with ``initializer=None``
    (the read-only serving contract). EMPTY keys give zero rows. Nothing
    is inserted: the push inserts, with the same init row. On a CUDA table
    one probe-gather kernel launch, plus one init-rows launch when an
    initializer is given.
    """
    flat, valid = _flat_keys(state, indices)
    lead = indices.shape[:-1] if state.wide else indices.shape
    bsz, _nb, chain = table_layout(state.capacity, max_probes)
    flat = flat.contiguous()
    rows, hit = probe_gather(state.keys, state.weights, flat,
                             chain=chain, bucket=bsz,
                             empty=empty_key(state.keys.dtype))
    if initializer is not None:
        _init_rows_kernel(rows, flat, hit | ~valid, state.init_rng,
                          make_initializer(initializer))
    return rows.reshape(tuple(lead) + (state.dim,))


def push_dedup(state: HashTableState, indices: torch.Tensor,
               grads: torch.Tensor, *,
               dedup_capacity: Optional[int] = None,
               in_counts: Optional[torch.Tensor] = None):
    """The push's first stage: the batch's keys deduplicated into a
    buffer of ``dedup_capacity`` keys (None: the batch's size; past it the
    largest keys are dropped, as in JAX) by :func:`dedup.unique_pairs`,
    or ``unique_indices`` for int32 and int64 keys (EMPTY keys not
    valid), and their gradients summed; ``in_counts`` gives pre-reduced
    entries' multiplicities. Returns ``(uniq, valid, summed, counts)``."""
    empty = empty_key(state.keys.dtype)
    flat, _ = _flat_keys(state, indices)
    n = dedup_capacity or flat.shape[0]
    if state.wide:
        uniq, inverse, valid = dedup.unique_pairs(flat, n, fill_value=empty)
    else:
        uniq, inverse, valid = dedup.unique_indices(flat, n,
                                                    fill_value=empty)
    summed, counts = dedup.combine_gradients(
        grads.reshape(-1, state.dim), inverse, n,
        None if in_counts is None else in_counts.reshape(-1))
    return uniq, valid, summed, counts


def push_update(state: HashTableState, optimizer: Any,
                initializer: Initializer, uniq: torch.Tensor,
                valid: torch.Tensor, summed: torch.Tensor,
                counts: torch.Tensor, slot: torch.Tensor,
                inserted: torch.Tensor) -> None:
    """The push's last stage, in place: gather the stored rows and slots
    of the placed keys, give the inserted ones their init row (one
    init-rows kernel launch), run the optimizer over the block and write
    it back by :func:`_scatter_plan`'s rule. ``slot`` and ``inserted``
    come from :func:`find_or_insert` on ``uniq``."""
    ok = valid & (slot >= 0)
    safe = torch.where(ok, slot, 0)
    w = state.weights.index_select(0, safe)
    _init_rows_kernel(w, uniq, ~inserted, state.init_rng, initializer)
    s = {k: v.index_select(0, safe) for k, v in state.slots.items()}
    new_w, new_s = table_lib.optimizer_block_update(optimizer, w, s,
                                                    summed, counts)
    plan = _scatter_plan(ok, safe)
    _commit(state.weights, new_w, plan)
    for k in state.slots:
        _commit(state.slots[k], new_s[k], plan)


def apply_gradients(state: HashTableState,
                    optimizer: Any,
                    initializer: Any,
                    indices: torch.Tensor,
                    grads: torch.Tensor,
                    *,
                    dedup_capacity: Optional[int] = None,
                    max_probes: int = DEFAULT_MAX_PROBES,
                    in_counts: Optional[torch.Tensor] = None
                    ) -> HashTableState:
    """Push and update in place: sum duplicate keys' gradients, insert
    missing keys, update the touched rows and their slots.

    The hash twin of ``table.apply_gradients``, step for step JAX's:
    :func:`push_dedup`, :func:`find_or_insert`, :func:`push_update` (the
    gather, the init rows of inserted keys, the optimizer, the scatter).
    EMPTY keys are dropped; keys that find no free slot in their window
    are dropped and counted in ``insert_failures``. ``dedup_capacity`` and
    ``in_counts``: as in :func:`push_dedup`. No step reads the device
    back. It opens the stages ``push.dedup``, ``push.find`` and
    ``push.update`` of an armed step program (``utils/observability.py``
    ``stage``). Returns ``state``.
    """
    if indices.numel() == 0:
        return state
    observability.stage("push.dedup")
    uniq, valid, summed, counts = push_dedup(
        state, indices, grads, dedup_capacity=dedup_capacity,
        in_counts=in_counts)
    observability.stage("push.find")
    _, slot, inserted, failed = find_or_insert(state.keys, uniq, valid,
                                               max_probes)
    observability.stage("push.update")
    push_update(state, make_optimizer(optimizer),
                make_initializer(initializer), uniq, valid, summed, counts,
                slot, inserted)
    state.insert_failures += failed.sum()
    return state
