"""Static-shape index dedup and gradient combine (``openembedding_tpu/ops/dedup.py``).

The JAX package dedups a push's ids with ``jnp.unique(size=capacity,
fill_value=FILL)``: a fixed-capacity buffer of the unique ids, ascending,
padded with ``FILL``, plus an ``inverse`` map, so the push program keeps
static shapes. The port builds the same buffers from ``torch.sort``, an
adjacent difference, a ``cumsum`` and two scatters, with no
device-to-host read: ``torch.unique`` reads its output size back to the
host on a CUDA tensor, a sync on every push.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# padding sentinel for empty unique slots (an id equal to it is invalid)
FILL = -2**31


def unique_indices(indices: torch.Tensor, capacity: Optional[int] = None,
                   fill_value: int = FILL
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate a flat index vector into a fixed-capacity buffer.

    Returns ``(uniq [capacity], inverse [n] int64, valid [capacity])``:
    ``uniq`` holds the distinct ids ascending, then ``fill_value``
    padding; ``uniq[inverse[i]] == indices[i]``; ``valid`` is ``uniq !=
    fill_value``. Equal to ``jnp.unique(indices, size=capacity,
    fill_value=fill_value, return_inverse=True)``, including its overflow:
    with more than ``capacity`` distinct ids the largest ones fall off the
    buffer and their entries get ``inverse >= capacity``
    (:func:`combine_gradients` drops them, :func:`overflow_count` counts
    them). The default capacity (the batch size) is always exact.
    """
    indices = indices.reshape(-1)
    n = indices.shape[0]
    if capacity is None:
        capacity = n
    # one scratch slot past the buffer takes the writes that are cut off
    buf = torch.full((capacity + 1,), fill_value, dtype=indices.dtype,
                     device=indices.device)
    uniq = buf[:capacity]
    if n == 0:
        return uniq, torch.zeros(0, dtype=torch.int64,
                                 device=indices.device), uniq != fill_value
    srt, order = torch.sort(indices)
    head = torch.ones(n, dtype=torch.bool, device=indices.device)
    head[1:] = srt[1:] != srt[:-1]
    ordinal = torch.cumsum(head, 0) - 1           # group of each sorted id
    inverse = torch.empty(n, dtype=torch.int64, device=indices.device)
    inverse.index_copy_(0, order, ordinal)
    # every id writes its value to its group's slot (equal values, so
    # the duplicates agree); groups past the buffer, to the scratch slot
    buf.scatter_(0, torch.clamp_max(ordinal, capacity), srt)
    return uniq, inverse, uniq != fill_value


def unique_rows(rows: torch.Tensor, capacity: Optional[int] = None,
                fill_value: int = FILL
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate composite keys: ``[n, K]`` integer rows, ``K >= 2``.

    Returns ``(uniq [capacity, K], inverse [n] int64, valid [capacity])``
    as the JAX function does: rows ranked lexicographically by K stable
    sorts (minor column first, major last), padding rows equal to
    ``fill_value`` in every column, and a group whose LAST column is
    ``fill_value`` not valid. Groups past ``capacity`` fall off the buffer
    with ``inverse >= capacity``, as in :func:`unique_indices`.
    """
    n, k = rows.shape
    if capacity is None:
        capacity = n
    dev = rows.device
    buf = torch.full((capacity + 1, k), fill_value, dtype=rows.dtype,
                     device=dev)
    uniq = buf[:capacity]
    if n == 0:
        return uniq, torch.zeros(0, dtype=torch.int64, device=dev), \
            torch.zeros(capacity, dtype=torch.bool, device=dev)
    order = torch.arange(n, device=dev)
    for c in range(k):
        order = order[torch.sort(rows[order, c], stable=True).indices]
    srt = rows[order]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = (srt[1:] != srt[:-1]).any(dim=1)
    ordinal = torch.cumsum(head, 0) - 1
    inverse = torch.empty(n, dtype=torch.int64, device=dev)
    inverse.index_copy_(0, order, ordinal)
    # the first row of each group writes its slot; the others, and groups
    # past the buffer, write the scratch row
    dst = torch.where(head, torch.clamp_max(ordinal, capacity), capacity)
    buf.index_copy_(0, dst, srt)
    return uniq, inverse, uniq[:, -1] != fill_value


def unique_pairs(pairs: torch.Tensor, capacity: Optional[int] = None,
                 fill_value: int = FILL
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate wide keys, ``[n, 2]`` int32 (lo, hi) rows: the result of
    :func:`unique_rows` from one sort. ``hi * 2^32 + (lo + 2^31)`` in int64
    orders the pairs as JAX's two stable sorts do (packing ``lo`` as
    unsigned would not), so :func:`unique_indices` on it gives the same
    buffer, inverse and overflow."""
    if pairs.dtype != torch.int32 or pairs.dim() != 2 \
            or pairs.shape[1] != 2:
        raise ValueError(f"unique_pairs takes [n, 2] int32 pairs, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    wide = pairs.to(torch.int64)
    packed = wide[:, 1] * 2**32 + (wide[:, 0] + 2**31)
    fill = fill_value * 2**32 + (fill_value + 2**31)
    u, inverse, _ = unique_indices(packed, capacity, fill)
    uniq = torch.stack([(u & 0xFFFFFFFF) - 2**31, u >> 32],
                       dim=1).to(torch.int32)
    return uniq, inverse, uniq[:, 1] != fill_value


def combine_gradients(grads: torch.Tensor, inverse: torch.Tensor,
                      capacity: int,
                      in_counts: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum duplicate ids' gradients into the unique buffer, with counts.

    ``grads`` is ``[n, dim]``; returns ``(summed [capacity, dim], counts
    [capacity] int32)``. ``in_counts`` ([n]) gives each entry's
    multiplicity when the gradients are already sums (the owner side of an
    exchange). Entries with ``inverse >= capacity`` are dropped, as the
    JAX scatter's ``mode="drop"`` drops them.
    """
    n, dim = grads.shape
    slot = torch.clamp_max(inverse, capacity)          # capacity: dropped
    summed = torch.zeros((capacity + 1, dim), dtype=grads.dtype,
                         device=grads.device)
    summed.index_add_(0, slot, grads)
    add = torch.ones(n, dtype=torch.int32, device=grads.device) \
        if in_counts is None else in_counts.to(torch.int32)
    counts = torch.zeros(capacity + 1, dtype=torch.int32,
                         device=grads.device)
    counts.index_add_(0, slot, add)
    return summed[:capacity], counts[:capacity]


def overflow_count(inverse: torch.Tensor, capacity: int) -> torch.Tensor:
    """Number of batch entries whose unique slot overflowed ``capacity``
    (a device scalar; reading it is the caller's sync)."""
    return torch.sum(inverse >= capacity)
