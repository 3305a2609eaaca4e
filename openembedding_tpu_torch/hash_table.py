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

Keys are ``[capacity]`` int32 (``key_dtype="int32"``) or, the default for
hash variables, ``[capacity, 2]`` int32 (lo, hi) pairs that carry the full
64-bit key space (``key_dtype="wide"``; a slot is free when its hi word is
EMPTY). The functions here compute exactly what the JAX package's do:
``probe_starts`` gives the same start slot and ``find_or_insert`` places
keys in the same slots as the JAX one-device table, so a state copied from
either package answers the same. torch has no general uint32 arithmetic:
the 32-bit mixing runs in int64 and masks to 32 bits, and products are
split so that no intermediate passes 2^63.

The read-only pull (the serving contract: missing keys give zero rows)
goes through the probe-gather kernel of ``ops/probe_gather.py``. What the
training slice brings raises ``NotImplementedError``: a pull with an
initializer (deterministic per-key init rows) and ``apply_gradients``;
int64-key tables raise as well. ``find_or_insert`` and ``insert_rows``
update the table in place (the JAX functions return new arrays): a
checkpoint load streams many chunks into one table, and a copy per chunk
would double the table's memory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .meta import EmbeddingVariableMeta
from .ops.probe_gather import probe_gather
from .optim.optimizers import make_optimizer
from .table import resolve_dtype
from .utils.device import DeviceLike, resolve_device

BUCKET = 128              # slots per bucket
DEFAULT_MAX_PROBES = 256  # probed slots per lookup (2-bucket chain)

_MASK32 = 0xFFFFFFFF


def _not_ported(what: str, item: str) -> NotImplementedError:
    from .embedding import not_ported
    return not_ported(what, item)


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


def _mix(keys: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche (murmur3 finalizer) of int32 keys, as int64 values
    in [0, 2^32). int64-key tables are not ported."""
    if keys.element_size() == 8:
        raise _not_ported("int64 hash keys (key_dtype='int64')",
                          "int64 hash keys")
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
    mixed = _mix_pair(keys[:, 0], keys[:, 1]) if is_wide(keys) \
        else _mix(keys)
    return (mixed % (num_buckets - chain + 1)) * bucket


def probe_starts(keys: torch.Tensor, capacity: int,
                 max_probes: int) -> torch.Tensor:
    """First probe SLOT per key, as ``hash_table.probe_starts`` computes it
    (int64 here, int32 there)."""
    b, nb, chain = table_layout(capacity, max_probes)
    return window_starts(keys, nb, chain, b)


def check_key_dtype(table_keys: torch.Tensor,
                    query: torch.Tensor) -> torch.Tensor:
    """Cast query keys to the table's key dtype, refusing silent truncation
    and a wide/narrow shape mismatch."""
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
    """One hash table: keys, weights, optimizer slots, and the count of
    keys an insert could not place (a probe-window overflow)."""

    keys: torch.Tensor                    # [capacity] or [capacity, 2]
    weights: torch.Tensor                 # [capacity, dim]
    slots: Dict[str, torch.Tensor]        # each [capacity, ...]
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
                      key_dtype: str = "int32",
                      device: DeviceLike = None) -> HashTableState:
    """An empty hash table on ``device`` (cuda unless named), capacity
    rounded up to the bucket granularity. ``key_dtype``: ``"wide"`` for
    [capacity, 2] pair keys, ``"int32"`` for plain keys."""
    if key_dtype == "int64":
        raise _not_ported("int64 hash keys (key_dtype='int64')",
                          "int64 hash keys")
    if key_dtype not in ("wide", "int32"):
        raise ValueError(f"unknown hash key_dtype {key_dtype!r}; known: "
                         "('wide', 'int32', 'int64')")
    device = resolve_device(device)
    optimizer = make_optimizer(optimizer)
    capacity = round_capacity(capacity)
    dtype = resolve_dtype(meta)
    dim = meta.embedding_dim
    shape = (capacity, 2) if key_dtype == "wide" else (capacity,)
    keys = torch.full(shape, empty_key(torch.int32), dtype=torch.int32,
                      device=device)
    weights = torch.zeros((capacity, dim), dtype=dtype, device=device)
    slots = optimizer.init_slots(capacity, dim, dtype, device)
    return HashTableState(keys=keys, weights=weights, slots=slots,
                          insert_failures=torch.zeros(
                              (), dtype=torch.int64, device=device))


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


def find_or_insert(table_keys: torch.Tensor, new_keys: torch.Tensor,
                   valid: torch.Tensor,
                   max_probes: int = DEFAULT_MAX_PROBES
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Find each (unique) key's slot, inserting missing keys IN PLACE.

    One pass per chain level: every unplaced key probes its level-j bucket,
    matches an existing entry, or else contenders for the same bucket are
    ranked (stable sort by bucket id) and rank r takes the bucket's
    (r+1)-th free slot; keys ranked past the free count overflow to the
    next level. Step for step the JAX algorithm, so keys land in the same
    slots. Returns ``(table_keys, slot [n] (-1 = failed), inserted [n],
    failed [n])``.
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
        seg = torch.ones(n, dtype=torch.bool, device=dev)
        seg[1:] = sorted_bid[1:] != sorted_bid[:-1]
        group_start = torch.cummax(torch.where(seg, ids, 0), dim=0).values
        rank = torch.empty_like(ids)
        rank[order] = ids - group_start
        # rank r takes the (r+1)-th free slot of the bucket
        cum = torch.cumsum(emptym, dim=1)
        place = active & (rank < cum[:, -1])
        pslot = start + _first((cum == rank[:, None] + 1) & emptym)
        table_keys[pslot[place]] = new_keys[place]
        slot = torch.where(place, pslot, slot)
        done = done | place
        inserted = inserted | place
    failed = valid & ~done
    return table_keys, slot, inserted, failed


def insert_rows(state: HashTableState,
                keys: torch.Tensor,
                weights: torch.Tensor,
                slot_rows: Optional[Dict[str, torch.Tensor]] = None,
                max_probes: int = DEFAULT_MAX_PROBES) -> HashTableState:
    """Set rows (and optimizer-state rows) for keys, inserting missing
    keys: the checkpoint load path. Updates ``state`` in place and returns
    it. ``keys`` must be unique; EMPTY keys are skipped; keys that find no
    free slot in their window are counted in ``insert_failures``."""
    empty = empty_key(state.keys.dtype)
    if state.wide:
        keys = _wide_query(state.keys, keys)
        valid = keys[:, 1] != empty
    else:
        keys = check_key_dtype(state.keys, keys.reshape(-1))
        valid = keys != empty
    _, slot, _inserted, failed = find_or_insert(state.keys, keys, valid,
                                                max_probes)
    ok = valid & (slot >= 0)
    dst = slot[ok]
    state.weights[dst] = weights[ok].to(state.weights.dtype)
    for name, rows in (slot_rows or {}).items():
        state.slots[name][dst] = rows[ok].to(state.slots[name].dtype)
    state.insert_failures += failed.sum()
    return state


def pull(state: HashTableState, indices: torch.Tensor,
         initializer: Any = None,
         max_probes: int = DEFAULT_MAX_PROBES) -> torch.Tensor:
    """Rows for keys of any shape (``[..., 2]`` pairs on a wide table):
    the read-only contract, ``initializer=None``, where missing and EMPTY
    keys give zero rows. One probe-gather kernel launch on a CUDA table."""
    if initializer is not None:
        raise _not_ported("a hash pull with an initializer (per-key init "
                          "rows for missing keys)", "training step")
    if state.wide:
        flat = _wide_query(state.keys, indices)
        out_shape = tuple(indices.shape[:-1]) + (state.dim,)
    else:
        flat = check_key_dtype(state.keys, indices.reshape(-1))
        out_shape = tuple(indices.shape) + (state.dim,)
    bsz, _nb, chain = table_layout(state.capacity, max_probes)
    rows, _hit = probe_gather(state.keys, state.weights, flat.contiguous(),
                              chain=chain, bucket=bsz,
                              empty=empty_key(state.keys.dtype))
    return rows.reshape(out_shape)
