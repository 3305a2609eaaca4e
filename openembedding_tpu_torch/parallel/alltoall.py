"""Owner-routed exchange between the shards of one process's mesh
(``openembedding_tpu/parallel/alltoall.py``, the ``a2a`` plane).

In JAX each device of the mesh takes a slice of the batch (the model-axis
peers of a data row split their common copy), dedups it, buckets the
unique keys by owner shard into fixed-capacity blocks, and a grid
all-to-all routes each block to its owner: keys out, rows (pull) or
pre-reduced ``(grad, count)`` pairs (push) back. The owner resolves rows
locally and, on push, merges its peers' pre-reduces (counts summed, not
recounted).

In the port the mesh lives in one process (``parallel/mesh.py``), so
every sender's buffers are one stacked tensor: a sender's ``[S, cap,
...]`` send buffer is row ``p`` of ``[S_src, S_dst, cap, ...]``, and the
grid all-to-all is one transpose to ``[S_dst, S_src, cap, ...]``
(:func:`grid_all_to_all`), never ``S^2`` small copies. Dedup, bucketing
and the residue bookkeeping run for all senders at once, with the JAX
functions' results row by row: ``jnp.unique``'s buffers, the stable
owner sort's bucket slots, the same capacity (:func:`bucket_capacity`).

The exchange stays exact for any key distribution. Entries past a
bucket's capacity stay pending for a further round. JAX loops
(``lax.while_loop``) until a globally summed pending count is zero; a
step captured as a CUDA graph cannot branch on a device count, so the
port runs the static worst case, ``ceil(m / cap)`` rounds for a slice of
``m`` entries (:func:`max_rounds`; one round when ``cap >= m``, as in
JAX). A round with nothing pending sends only padding and adds zero rows
to rows already filled, so the pull's result is JAX's for any skew. The
push routes its residue the same way and merges every round's entries
before one apply per owner, ordered by sender: the owner sees each key
once per sender with all contributions, in sender order, as JAX's routed
exchange and its all-gather fallback both give them, so the same keys,
counts and sums reach the optimizer.

The gated counters ``a2a_extra_entries_pull`` and
``a2a_extra_entries_push`` (entries not routed in round 1) go to
``utils/observability.GLOBAL`` under ``evaluate_performance()``
(:func:`record_stat`); inside a captured step they accumulate on the
device and :func:`flush_stats` moves them to the host.

Compressed wires (``parallel/precision.py``): ``exchange_pull(wire_dtype=
torch.bfloat16)`` narrows the owners' rows before the response leg and
keeps them narrow through the row assembly; ``exchange_push(wire_dtype=)``
narrows the pre-reduced gradients; ``exchange_push(ef_state=)`` sends them
as int8 with a per-row scale that rides the integer key/count buffer as
one more channel (its float32 bits), and returns each sender's new
residual (:func:`_quantize_ef`). A 16-bit payload crosses as its raw
words (:func:`pin_wire`). :data:`WIRE` keeps the bytes and dtypes of the
last exchange's legs, read from the buffers themselves, so a test or the
card's smoke run can check what crossed; :data:`EXCHANGES` counts the
exchanges dispatched.

Across processes (a mesh from ``distributed.create_global_mesh``), each
process holds its own positions' senders and owners only: a stacked
buffer has one row a local position, ``[L, S, cap, ...]``. The blocks
between local positions still move by the transpose; those for another
process's positions cross through one ``all_to_all_single`` a leg
(``distributed.all_to_all``), received in sender order, so every owner
merges its senders in the global order of one process's mesh. The
statistics JAX sums over the whole mesh are summed over the processes
first, and every process records the total, as every JAX process sees
the same replicated value. ``WIRE`` also keeps the bytes that crossed
to other processes (``cross``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import observability

# device accumulators of the gated counters, filled by captured steps
_PENDING: Dict[Tuple[str, torch.device], torch.Tensor] = {}

# the last exchange's legs, by verb: {"keys": bytes, "payload": bytes,
# "payload_dtype": str, "rounds": n} (host bookkeeping of buffer sizes)
WIRE: Dict[str, Dict[str, object]] = {}
# exchanges dispatched, by verb (host counts: a captured step counts once)
EXCHANGES: Dict[str, int] = {"pull": 0, "push": 0}


def pin_wire(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit float payload as its raw 16-bit words (JAX's bitcast to
    uint16; int16 here, the same bits, since torch's uint16 lacks the
    copy kernels a transpose needs): what crosses is 2 bytes an element,
    whatever a later refactor does to the casts around it."""
    return x.view(torch.int16)


def unpin_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`pin_wire` (exact bit reinterpretation)."""
    return x.view(dtype)


def _procs(mesh) -> int:
    return mesh.process_count if mesh is not None else 1


def _note_wire(verb: str, keys: torch.Tensor, payload: torch.Tensor,
               payload_dtype: torch.dtype, rounds: int, mesh=None) -> None:
    p = _procs(mesh)
    nbytes = int(keys.nbytes) + int(payload.nbytes)
    WIRE[verb] = {"keys": int(keys.nbytes) * rounds,
                  "payload": int(payload.nbytes) * rounds,
                  "payload_dtype": str(payload_dtype).replace("torch.", ""),
                  "rounds": rounds,
                  # each leg sends every other process its equal block
                  "cross": nbytes // p * (p - 1) * rounds}


def record_stat(counter: str, value: torch.Tensor, record: bool,
                mesh=None) -> None:
    """Gated host accumulation of a routed-exchange statistic (JAX's
    ``record_stat``): ``record`` is the caller's snapshot of
    ``observability.evaluate_performance()``. Off by default: it reads the
    device back. Eagerly the count goes to ``observability.GLOBAL`` at
    once; while a CUDA graph is captured it adds into a device
    accumulator (created by an eager call first, as a captured step's
    warm-up is) that :func:`flush_stats` reads. On a mesh across
    processes the count is summed over them first: a collective that
    runs only where ``record`` is set, so every process must set
    ``observability.evaluate_performance()`` alike (the ``Trainer``
    checks it when it builds a step on such a mesh)."""
    if not record:
        return
    if _procs(mesh) > 1:
        from .. import distributed
        value = distributed.all_reduce(value.to(torch.int64).reshape(1),
                                       mesh)[0]
    key = (counter, value.device)
    if value.is_cuda and torch.cuda.is_current_stream_capturing():
        acc = _PENDING.get(key)
        if acc is None:
            raise RuntimeError(
                f"{counter}: no device accumulator; run the exchange once "
                "eagerly with evaluate_performance() on before capturing")
        acc.add_(value.to(torch.int64))
        return
    if key not in _PENDING:
        _PENDING[key] = torch.zeros((), dtype=torch.int64,
                                    device=value.device)
    if observability.evaluate_performance():
        observability.GLOBAL.add(counter, int(value))


def record_float_stat(counter: str, value: torch.Tensor,
                      record: bool, mesh=None) -> None:
    """:func:`record_stat` for float telemetry of the int8_ef push
    (``quant_error_max``, ``quant_residual_norm``): ``value`` holds one
    number a sender, each added to ``observability.GLOBAL`` (a sum over
    senders and steps, as JAX's per-device callbacks give it) and
    observed in the histogram registry; inside a capture their sum
    accumulates on the device for :func:`flush_stats`. On a mesh across
    processes every process records every sender's number, in sender
    order, gathered by a collective that, as :func:`record_stat`'s, runs
    only where ``record`` is set."""
    if not record:
        return
    if _procs(mesh) > 1:
        from .. import distributed
        value = distributed.all_gather(value.reshape(-1), mesh).reshape(-1)
    key = (counter, value.device)
    if value.is_cuda and torch.cuda.is_current_stream_capturing():
        acc = _PENDING.get(key)
        if acc is None:
            raise RuntimeError(
                f"{counter}: no device accumulator; run the exchange once "
                "eagerly with evaluate_performance() on before capturing")
        acc.add_(value.to(torch.float64).sum())
        return
    if key not in _PENDING:
        _PENDING[key] = torch.zeros((), dtype=torch.float64,
                                    device=value.device)
    if observability.evaluate_performance():
        from ..analysis import scope
        for v in value.reshape(-1).tolist():
            observability.GLOBAL.add(counter, float(v))
            scope.HISTOGRAMS.observe(counter, float(v))


def flush_stats() -> Dict[str, float]:
    """Move the device accumulators of captured steps into
    ``observability.GLOBAL`` (a read of the device); returns what moved."""
    moved: Dict[str, float] = {}
    for (counter, _dev), acc in _PENDING.items():
        v = acc.item()
        if v:
            acc.zero_()
            observability.GLOBAL.add(counter, v)
            moved[counter] = moved.get(counter, 0) + v
    return moved


def linear_shard_id(coords: Sequence[int], sizes: Sequence[int]) -> int:
    """The shard ordinal of mesh position ``coords``, row-major over
    ``sizes`` (JAX's ``linear_shard_id``, on the host)."""
    idx = 0
    for c, size in zip(coords, sizes):
        idx = idx * size + int(c)
    return idx


def bucket_capacity(slice_size: int, num_shards: int,
                    capacity: int = 0, slack: float = 2.0) -> int:
    """Per-destination bucket size, as in JAX: ``capacity`` if given
    (capped at the slice), else ``max(32, ceil(mean * slack))`` rounded up
    to 8 and capped at the slice."""
    if capacity:
        return min(capacity, slice_size)
    mean = math.ceil(slice_size / num_shards)
    c = max(32, math.ceil(mean * slack))
    c = min(slice_size, -(-c // 8) * 8)
    return max(c, 1)


def max_rounds(slice_size: int, capacity: int) -> int:
    """The worst-case number of rounds for a slice of ``slice_size``
    entries and buckets of ``capacity``: every entry owned by one shard."""
    return max(1, -(-slice_size // capacity))


def bucketize(owner: torch.Tensor, num_shards: int, capacity: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each entry's flat send-buffer slot ``owner * capacity + pos`` for
    ``owner`` of shape ``[..., m]`` (one row a sender), values in ``[0,
    num_shards]`` (``num_shards``: not sent). Returns ``(dest, ok)`` of
    int64 and bool: ``dest == num_shards * capacity`` where not sent this
    round. A stable sort by owner, rank within the group, row by row, as
    JAX's ``bucketize``; past-capacity ranks stay pending."""
    owner = owner.to(torch.int64)
    m = owner.shape[-1]
    clamped = torch.clamp_max(owner, num_shards)
    sorted_owner, order = torch.sort(clamped, dim=-1, stable=True)
    shards = torch.arange(num_shards + 1, device=owner.device)
    counts = (clamped[..., None] == shards).sum(dim=-2)
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_sorted = torch.arange(m, device=owner.device) \
        - torch.gather(starts, -1, sorted_owner)
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    ok = (owner < num_shards) & (pos < capacity)
    dest = torch.where(ok, owner * capacity + pos, num_shards * capacity)
    return dest, ok


def fill_buckets(values: torch.Tensor, dest: torch.Tensor, num_shards: int,
                 capacity: int, fill) -> torch.Tensor:
    """Scatter ``[P, m, ...]`` values into the ``[P, num_shards, capacity,
    ...]`` send buffers of ``P`` senders (slots nobody writes hold
    ``fill``)."""
    p, m = dest.shape
    tail = tuple(values.shape[2:])
    width = num_shards * capacity + 1       # one scratch slot a sender
    out = torch.full((p * width,) + tail, fill, dtype=values.dtype,
                     device=values.device)
    flat = dest + torch.arange(p, device=dest.device)[:, None] * width
    out.index_copy_(0, flat.reshape(-1), values.reshape((p * m,) + tail))
    return out.view((p, width) + tail)[:, :-1].reshape(
        (p, num_shards, capacity) + tail)


def grid_all_to_all(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The grid all-to-all of ``S`` shards: ``x[src, dst]`` (each local
    sender's per-destination blocks, ``[L, S, ...]``) becomes ``y[dst,
    src]`` (``[L, S, ...]``, the blocks each local shard receives, in
    sender order). In one process (``L = S``) one transpose; on a mesh
    across ``P`` processes the blocks for each process gather into one
    send buffer of ``[P, L, L, ...]`` and cross in one all-to-all."""
    p = _procs(mesh)
    if p == 1:
        return x.transpose(0, 1).contiguous()
    from .. import distributed
    ln = x.shape[0]
    tail = tuple(x.shape[2:])
    rest = tuple(range(3, 3 + len(tail)))
    # send[q, b, a] = x[a, q * L + b]: process q's block, by its owners
    send = x.reshape((ln, p, ln) + tail).permute((1, 2, 0) + rest)
    recv = distributed.all_to_all(send, mesh)   # [P_src, L_dst, L_src]
    return recv.permute((1, 0, 2) + rest).reshape((ln, p * ln) + tail)


def grid_info(mesh, shard_axes: Sequence[str], model_axis: str,
              batch_sharded: bool):
    """``(grid_axes, grid_sizes, split_axes, split_sizes)`` for one
    exchange, as in JAX: keys are routed over the table's shard axes, and
    the batch is divided among the axes it is replicated over (the model
    axis when batch-sharded over data, else the whole grid)."""
    grid_axes = tuple(shard_axes)
    grid_sizes = tuple(mesh.shape[a] for a in grid_axes)
    split_axes = (model_axis,) if batch_sharded else grid_axes
    split_sizes = tuple(mesh.shape[a] for a in split_axes)
    return grid_axes, grid_sizes, split_axes, split_sizes


def split_slice(flat: torch.Tensor, num_parts: int, fill,
                groups: int = 1) -> Tuple[torch.Tensor, int]:
    """Every sender's slice at once: ``flat`` ``[n]`` (or ``[n, k]`` wide
    keys) is ``groups`` equal group slices (the data rows of a
    batch-sharded batch), each padded with ``fill`` to a multiple of
    ``num_parts`` and cut into parts of ``m = ceil(n_group / num_parts)``.
    Returns ``([groups * num_parts, m(, k)], m)``: row ``g * num_parts +
    part`` is JAX's ``split_slice`` on device ``(g, part)``."""
    n = flat.shape[0]
    if n % groups:
        raise ValueError(f"{n} entries do not split into {groups} equal "
                         "batch slices (the batch must divide the data "
                         "axis)")
    ng = n // groups
    m = -(-ng // num_parts)
    tail = tuple(flat.shape[1:])
    padded = torch.full((groups, m * num_parts) + tail, fill,
                        dtype=flat.dtype, device=flat.device)
    padded[:, :ng] = flat.reshape((groups, ng) + tail)
    return padded.view((groups * num_parts, m) + tail), m


def split_slice_rows(rows: torch.Tensor, num_parts: int,
                     groups: int = 1) -> torch.Tensor:
    """Row variant of :func:`split_slice` (zero padding)."""
    sl, _ = split_slice(rows, num_parts, 0, groups)
    return sl


def unslice(rows: torch.Tensor, n: int, groups: int) -> torch.Tensor:
    """Inverse of :func:`split_slice` on ``[groups * parts, m, ...]``
    rows: each group's parts back in order (JAX's tiled all-gather over
    the split axes), the padding dropped, ``[n, ...]``."""
    tail = tuple(rows.shape[2:])
    per = rows.reshape((groups, -1) + tail)
    return per[:, :n // groups].reshape((n,) + tail)


def segment_offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    """Static exclusive prefix sums over per-segment entry counts."""
    out = [0]
    for s in sizes:
        out.append(out[-1] + int(s))
    return tuple(out)


def carve_segments(rows: torch.Tensor, sizes: Sequence[int]) -> list:
    """Split ``rows`` ``[sum(sizes), ...]`` back into per-segment blocks."""
    offs = segment_offsets(sizes)
    return [rows[offs[i]:offs[i + 1]] for i in range(len(sizes))]


# --- dedup of every sender's slice ---------------------------------------------

_MASK32 = 0xFFFFFFFF


def _unique_rows_of(x: torch.Tensor, fill
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(row, size=m, fill_value=fill, return_inverse=True)``
    for each row of ``x`` ``[P, m]``: ``(uniq [P, m], inverse [P, m]
    int64)``, the distinct values ascending, then ``fill``."""
    p, m = x.shape
    srt, order = torch.sort(x, dim=1)
    head = torch.ones((p, m), dtype=torch.bool, device=x.device)
    head[:, 1:] = srt[:, 1:] != srt[:, :-1]
    ordinal = torch.cumsum(head, dim=1) - 1
    inverse = torch.empty_like(ordinal).scatter_(1, order, ordinal)
    uniq = torch.full_like(x, fill)
    # every entry writes its value to its group's slot; duplicates agree
    uniq.scatter_(1, ordinal, srt)
    return uniq, inverse


def _unique_composite(sl: torch.Tensor, fill
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`unique_per_sender` for ``[P, m, K]`` rows of any integer
    dtype: JAX's ``unique_rows`` ranking (K stable sorts, minor column
    first), row by row."""
    p, m, k = sl.shape
    order = torch.arange(m, device=sl.device).expand(p, m)
    for c in range(k):
        col = torch.gather(sl[..., c], 1, order)
        order = torch.gather(order, 1,
                             torch.sort(col, dim=1, stable=True).indices)
    srt = _take_rows(sl, order)
    head = torch.ones((p, m), dtype=torch.bool, device=sl.device)
    head[:, 1:] = (srt[:, 1:] != srt[:, :-1]).any(dim=-1)
    ordinal = torch.cumsum(head, dim=1) - 1
    inverse = torch.empty_like(ordinal).scatter_(1, order, ordinal)
    uniq = torch.full_like(sl, fill)
    # every row writes its group's slot; duplicates agree
    uniq.scatter_(1, ordinal[..., None].expand(p, m, k), srt)
    return uniq, inverse


def unique_per_sender(sl: torch.Tensor, fill: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each sender's dedup: ``[P, m]`` keys, ``[P, m, 2]`` int32 (lo, hi)
    pairs ranked as JAX's ``unique_rows`` ranks them (hi major, lo
    minor, both signed), or any ``[P, m, K]`` composite rows (the grouped
    plane's tagged streams) ranked the same way, last column major."""
    if sl.dim() == 2:
        return _unique_rows_of(sl, fill)
    if sl.shape[-1] != 2 or sl.dtype != torch.int32:
        return _unique_composite(sl, fill)
    w = sl.to(torch.int64)
    packed = w[..., 1] * 2**32 + (w[..., 0] + 2**31)
    u, inverse = _unique_rows_of(packed, fill * 2**32 + (fill + 2**31))
    uniq = torch.stack([(u & _MASK32) - 2**31, u >> 32],
                       dim=-1).to(torch.int32)
    return uniq, inverse


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows`` ``[P, k, dim]`` taken at ``idx`` ``[P, j]`` row by row."""
    p, k = rows.shape[:2]
    flat = idx + torch.arange(p, device=idx.device)[:, None] * k
    return rows.reshape((p * k,) + tuple(rows.shape[2:])).index_select(
        0, flat.reshape(-1)).reshape(tuple(idx.shape)
                                     + tuple(rows.shape[2:]))


# --- the exchanges --------------------------------------------------------------

def exchange_pull(flat_idx: torch.Tensor,
                  resolve_fn: Callable[[torch.Tensor], torch.Tensor],
                  owner_fn: Callable[[torch.Tensor], torch.Tensor],
                  *,
                  sentinel: int,
                  dim: int,
                  dtype: torch.dtype,
                  num_shards: int,
                  groups: int = 1,
                  capacity: int = 0,
                  slack: float = 2.0,
                  record_stats: bool = False,
                  wire_dtype: Optional[torch.dtype] = None,
                  mesh=None) -> torch.Tensor:
    """Owner-routed lookup of ``flat_idx`` ``[n]`` (or ``[n, k]`` composite
    keys: wide pairs, the grouped plane's tagged streams) -> rows ``[n,
    dim]`` of ``dtype``. EXACT for any skew.

    ``groups`` batch slices (the data rows of a batch-sharded batch, else
    1) are each split among ``num_shards / groups`` senders (JAX's split
    axes). ``owner_fn(keys [..])`` gives each key's shard (``num_shards``
    = do not send: padding, invalid ids); ``resolve_fn(req)`` takes the
    owners' requests ``[S_owner, S * cap(, 2)]`` (each owner's row in
    sender order, padding ``sentinel``) and returns their rows ``[S_owner,
    S * cap, dim]``, zero rows for padding and keys the owner does not
    own. Rounds: :func:`max_rounds`, module note.

    ``wire_dtype`` (bfloat16): the owners' rows narrow before the
    response leg (the one lossy point, one round-to-nearest cast a row)
    and stay narrow, as their raw words, through the row assembly; they
    widen to ``dtype`` at the end. None leaves the exchange as it was.

    ``mesh`` across processes: ``flat_idx`` is this process's batch, the
    slices of its own data rows, and ``resolve_fn`` its own owners'
    (module note)."""
    s = num_shards
    parts = s // groups
    n = flat_idx.shape[0]
    groups, ln = _local_split(s, groups, mesh)
    EXCHANGES["pull"] += 1
    sl, m = split_slice(flat_idx, parts, sentinel, groups)
    uniq, inverse = unique_per_sender(sl, sentinel)
    cap = bucket_capacity(m, s, capacity, slack)
    pending = owner_fn(uniq).to(torch.int64)
    acc_dtype = dtype if wire_dtype is None else wire_dtype
    acc = torch.zeros((ln, m, dim), dtype=acc_dtype, device=flat_idx.device)
    kw = tuple(sl.shape[2:])
    rounds = max_rounds(m, cap)
    for r in range(rounds):
        dest, ok = bucketize(pending, s, cap)
        send = fill_buckets(uniq, dest, s, cap, sentinel)
        req = grid_all_to_all(send, mesh)           # [L_own, S_src, cap]
        rows = resolve_fn(req.reshape((ln, s * cap) + kw))
        if wire_dtype is not None:
            rows = pin_wire(rows.to(wire_dtype))
        resp = grid_all_to_all(rows.reshape(ln, s, cap, dim), mesh)
        if r == 0:
            _note_wire("pull", send, resp, acc_dtype, rounds, mesh)
        if wire_dtype is not None:
            resp = unpin_wire(resp, wire_dtype)
        got = _take_rows(resp.reshape(ln, s * cap, dim),
                         torch.where(ok, dest, 0))
        acc = acc + torch.where(ok[..., None], got, torch.zeros_like(got))
        pending = torch.where(ok, s, pending)
        if r == 0:
            record_stat("a2a_extra_entries_pull", (pending < s).sum(),
                        record_stats, mesh)
    slice_rows = _take_rows(acc, inverse)
    if wire_dtype is not None:
        # the assembly moves the pinned 16-bit words; widening is exact
        assembled = unslice(pin_wire(slice_rows), n, groups)
        return unpin_wire(assembled, wire_dtype).to(dtype)
    return unslice(slice_rows, n, groups)


def _local_split(num_shards: int, groups: int, mesh) -> Tuple[int, int]:
    """``(groups, senders)`` of this process: its batch slices (its data
    rows when batch-sharded) and its positions. A mesh across processes
    needs a batch-sharded exchange: each process holds its own rows."""
    p = _procs(mesh)
    if p == 1:
        return groups, num_shards
    if groups % p or num_shards % p:
        raise ValueError(
            f"an exchange over {p} processes splits the batch over the data "
            f"axis ({groups} batch slices, {num_shards} shards): pass each "
            "process's own rows, batch-sharded")
    return groups // p, num_shards // p


def exchange_push(flat_idx: torch.Tensor,
                  grads: torch.Tensor,
                  apply_fn: Callable,
                  owner_fn: Callable[[torch.Tensor], torch.Tensor],
                  *,
                  sentinel: int,
                  num_shards: int,
                  groups: int = 1,
                  capacity: int = 0,
                  slack: float = 2.0,
                  record_stats: bool = False,
                  wire_dtype: Optional[torch.dtype] = None,
                  ef_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  mesh=None):
    """Owner-routed push: each sender pre-reduces its slice (dedup, sum,
    count), routes ``(key, count)`` and the summed gradient to the
    owners, and ``apply_fn(keys [S_owner, K(, 2)], grads [S_owner, K,
    dim], counts [S_owner, K])`` merges them on each owner (padding
    entries carry ``sentinel`` keys and garbage counts, which the appliers
    drop by the invalid-key contract). Returns what ``apply_fn``
    returns. Every round's entries reach one apply, in sender order
    (module note), so each key's optimizer step runs once per step with
    all contributions, for any skew.

    ``wire_dtype`` (bfloat16): the pre-reduced gradients cross narrowed
    and widen before ``apply_fn``; keys and counts stay integers.
    ``ef_state = (prev_keys [S, m0(, 2)], prev_resid [S, m0, dim])``: the
    int8 error-feedback push (:func:`_quantize_ef`); returns ``(result,
    (keys [S, m(, 2)], resid [S, m, dim]))``, each sender's new residual.
    Padding entries' received scales are zeroed by key validity before
    the multiply, so no garbage bit pattern reaches an applier. ``mesh``
    as in :func:`exchange_pull`: ``apply_fn`` gets this process's owners'
    entries, ``[L, K, ...]``."""
    s = num_shards
    parts = s // groups
    dim = grads.shape[-1]
    groups, ln = _local_split(s, groups, mesh)
    EXCHANGES["push"] += 1
    sl, m = split_slice(flat_idx, parts, sentinel, groups)
    g2 = split_slice_rows(grads.reshape(-1, dim), parts, groups)
    uniq, inverse = unique_per_sender(sl, sentinel)
    wide = uniq.dim() == 3
    quant = ef_state is not None
    if quant:
        valid = (uniq[..., -1] if wide else uniq) != sentinel
        # the int8_ef totals: each sender's gradients added onto the
        # residual it carried for the key, in entry order after it (the
        # order XLA's program adds them in: it folds the add of the carry
        # into the pre-reduce's scatter-add)
        summed = _carried_residual(uniq, valid, ef_state).to(
            grads.dtype).reshape(ln * m, dim)
    else:
        summed = torch.zeros((ln * m, dim), dtype=grads.dtype,
                             device=grads.device)
    # each sender's combine_gradients: sums in entry order, counts
    flat_inv = (inverse + torch.arange(ln, device=inverse.device)[:, None]
                * m).reshape(-1)
    summed.index_add_(0, flat_inv, g2.reshape(-1, dim))
    counts = torch.zeros(ln * m, dtype=torch.int32, device=grads.device)
    counts.index_add_(0, flat_inv, torch.ones_like(counts))
    summed = summed.view(ln, m, dim)
    cap = bucket_capacity(m, s, capacity, slack)
    owners = owner_fn(uniq).to(torch.int64)
    ku = uniq if wide else uniq[..., None]
    kw = ku.shape[-1]
    cols = [ku, counts.view(ln, m, 1).to(ku.dtype)]
    if quant:
        q8, scale, new_ef = _quantize_ef(uniq, summed, valid, record_stats,
                                         mesh)
        # the f32 scale's bits ride the integer buffer as one more channel
        cols.append(scale.view(torch.int32).to(ku.dtype)[..., None])
        payload = q8
    elif wire_dtype is not None:
        payload = pin_wire(summed.to(wire_dtype))
    else:
        payload = summed
    kc = torch.cat(cols, dim=-1)
    pending = owners
    got_kc, got_g = [], []
    rounds = max_rounds(m, cap)
    for r in range(rounds):
        dest, ok = bucketize(pending, s, cap)
        if r == 0 and cap < m:
            record_stat("a2a_extra_entries_push",
                        ((owners < s) & ~ok).sum(), record_stats, mesh)
        got_kc.append(grid_all_to_all(fill_buckets(kc, dest, s, cap,
                                                   sentinel), mesh))
        got_g.append(grid_all_to_all(fill_buckets(payload, dest, s, cap,
                                                  0), mesh))
        if r == 0:
            _note_wire("push", got_kc[0], got_g[0],
                       torch.int8 if quant else (wire_dtype or grads.dtype),
                       rounds, mesh)
        pending = torch.where(ok, s, pending)
    # [L_own, S_src, rounds, cap, ...]: each owner's entries by sender
    rkc = torch.stack(got_kc, dim=2).reshape(ln, -1, kc.shape[-1])
    rg = torch.stack(got_g, dim=2).reshape(ln, -1, dim)
    keys = rkc[..., :kw] if wide else rkc[..., 0]
    if quant:
        rscale = rkc[..., kw + 1].to(torch.int32).view(torch.float32)
        kvalid = (keys[..., -1] if wide else keys) != sentinel
        rscale = torch.where(kvalid, rscale, torch.zeros_like(rscale))
        g = rg.to(summed.dtype) * rscale[..., None]
    elif wire_dtype is not None:
        g = unpin_wire(rg, wire_dtype).to(summed.dtype)
    else:
        g = rg
    out = apply_fn(keys, g, rkc[..., kw].to(torch.int32))
    return (out, new_ef) if quant else out


_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _mix_pairs(k: torch.Tensor) -> torch.Tensor:
    """JAX's 32-bit multiplicative mix of ``[..., 2]`` (lo, hi) words,
    ``((lo * 0x85EBCA6B) ^ (hi * 0xC2B2AE35)) mod 2^32`` read as int32,
    here in int64 arithmetic masked to 32 bits (its signed value)."""
    lo = (k[..., 0].to(torch.int64) & _MASK32) * 0x85EBCA6B & _MASK32
    hi = (k[..., 1].to(torch.int64) & _MASK32) * 0xC2B2AE35 & _MASK32
    x = lo ^ hi
    return torch.where(x >= 2**31, x - 2**32, x)


def _match_prev_keys(uniq: torch.Tensor, pk: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each sender's current keys ``[S, m(, 2)]`` against its
    previous ones ``[S, m0(, 2)]``: ``(candidate index into pk [S, m],
    exact-equality flag [S, m])``. A stable sort of the previous keys
    (wide pairs by :func:`_mix_pairs`), a left binary search, an exact
    check of every word: two previous keys whose mix collides can hide
    the second's residual (forfeited), never corrupt one."""
    wide = uniq.dim() == 3
    cur = _mix_pairs(uniq) if wide else uniq
    prev = _mix_pairs(pk) if wide else pk
    order = torch.argsort(prev, dim=-1, stable=True)
    prev_sorted = torch.gather(prev, -1, order)
    pos = torch.searchsorted(prev_sorted.contiguous(), cur.contiguous())
    cand = torch.gather(order, -1, torch.clamp(pos, 0, pk.shape[1] - 1))
    hit_rows = _take_rows(pk, cand) if wide else torch.gather(pk, -1, cand)
    eq = (hit_rows == uniq).all(dim=-1) if wide else hit_rows == uniq
    return cand, eq


def _carried_residual(uniq: torch.Tensor, valid: torch.Tensor,
                      ef_state) -> torch.Tensor:
    """``[S, m, dim]``: the residual each sender stored last step for each
    of its current keys (``ef_state = (prev_keys, prev_resid)``), zero
    where the key is new, forfeited or padding."""
    pk, pr = ef_state
    s, m = uniq.shape[:2]
    if not pk.shape[1]:
        return torch.zeros((s, m, pr.shape[-1]), dtype=pr.dtype,
                           device=pr.device)
    cand, eq = _match_prev_keys(uniq, pk.to(uniq.dtype))
    hit = eq & valid
    return torch.where(hit[..., None], _take_rows(pr, cand),
                       torch.zeros((), dtype=pr.dtype, device=pr.device))


def _quantize_ef(uniq: torch.Tensor, total: torch.Tensor,
                 valid: torch.Tensor, record_stats: bool, mesh=None):
    """int8 error-feedback quantization of every sender's residual-carried
    pre-reduced rows ``total`` (:func:`_carried_residual` plus the
    gradients; JAX's, a sender a row). Returns ``(q8, scale, (keys,
    resid))``: the int8 payload ``clip(round(total / scale), -127, 127)``
    (round half to even), the per-row scales ``absmax / 127`` (1 where a
    row is zero; computed as XLA computes it, a multiply by the float32
    reciprocal) and the new residual ``total - q8 * scale`` (zero on
    padding, rounded once as XLA's fused multiply-subtract), exactly the
    error the owner sees."""
    t32 = total.to(torch.float32)
    absmax = t32.abs().amax(dim=-1)
    # JAX writes absmax / 127.0; XLA folds a division by a constant into
    # a multiply by its float32 reciprocal, which is what its programs
    # compute (every quotient, where a true division differs in ~4 %)
    scale = torch.where(absmax > 0, absmax * _INV127,
                        torch.ones_like(absmax))
    q8 = torch.clamp(torch.round(t32 / scale[..., None]), -127, 127
                     ).to(torch.int8)
    # total - q8 * scale rounded once, as XLA's fused multiply-subtract
    # computes it: the product is exact in float64 (8 + 24 bits), and so
    # is the difference (|total - q8 * scale| <= scale / 2)
    err = (t32.to(torch.float64)
           - q8.to(torch.float64) * scale.to(torch.float64)[..., None])
    resid = torch.where(valid[..., None], err.to(torch.float32),
                        torch.zeros((), dtype=torch.float32,
                                    device=t32.device))
    flat = resid.reshape(resid.shape[0], -1)
    record_float_stat("quant_error_max", flat.abs().amax(dim=-1),
                      record_stats, mesh)
    record_float_stat("quant_residual_norm",
                      torch.sqrt((flat * flat).sum(dim=-1)), record_stats,
                      mesh)
    return q8, scale, (uniq, resid)


def routing_overflow(indices, num_shards: int, slice_parts: int,
                     owner_of, capacity: int = 0, slack: float = 2.0) -> int:
    """Host-side diagnostic: how many uniques spill past round 1's buckets
    (JAX's ``routing_overflow``): 0 means one round for this batch shape
    and key distribution; more means extra rounds, never data loss."""
    flat = np.asarray(indices).ravel()
    n = flat.shape[0]
    m = -(-n // slice_parts)
    cap = bucket_capacity(m, num_shards, capacity, slack)
    dropped = 0
    for p in range(slice_parts):
        sl = flat[p * m:(p + 1) * m]
        uniq = np.unique(sl)
        owners = np.asarray(owner_of(uniq))
        keep = owners < num_shards
        counts = np.bincount(owners[keep], minlength=num_shards)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped
