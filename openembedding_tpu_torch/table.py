"""Single-shard embedding table (``openembedding_tpu/table.py``).

The table is a dense ``[capacity, dim]`` tensor plus named optimizer slot
tensors co-indexed with it. ``pull`` is one row gather through the CUDA
kernel of ``ops/gather.py`` (the plain version on CPU tensors), with the
framework-wide invalid-index contract: ids ``< 0`` or ``>= capacity`` give
zero rows. ``apply_gradients`` is the push: dedup, combine, gather the
touched rows, update them, scatter them back, step for step the JAX
program, in PyTorch ops with static shapes (no device-to-host read); it
opens the stages ``push.dedup`` and ``push.update`` of an armed step
program (``utils/observability.py`` ``stage``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .meta import EmbeddingVariableMeta
from .ops import dedup
from .ops.gather import gather_rows
from .optim.initializers import make_initializer
from .optim.optimizers import SparseOptimizer, make_optimizer
from .utils import observability
from .utils.device import DeviceLike, resolve_device

DEFAULT_INITIALIZER = {"category": "uniform", "minval": -1e-3, "maxval": 1e-3}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def resolve_dtype(meta: EmbeddingVariableMeta) -> torch.dtype:
    return _DTYPES[meta.datatype]


@dataclasses.dataclass
class TableState:
    """One table's weights + optimizer slots."""

    weights: torch.Tensor                 # [capacity, dim]
    slots: Dict[str, torch.Tensor]        # each [capacity, ...]

    @property
    def capacity(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.weights.shape[1]


def create_table(meta: EmbeddingVariableMeta,
                 optimizer: Any,
                 initializer: Any = None,
                 *,
                 rng=None,
                 capacity: Optional[int] = None,
                 device: DeviceLike = None) -> TableState:
    """Materialize a table (weights initialized, slots at their init value)
    on ``device`` (cuda unless named). ``rng``: the threefry key the
    weights are drawn from (two uint32 words; None: ``PRNGKey(0)``), as
    JAX's ``create_table(rng=)`` draws them, so the table is the same on
    every device."""
    device = resolve_device(device)
    optimizer = make_optimizer(optimizer)
    initializer = make_initializer(initializer or DEFAULT_INITIALIZER)
    if capacity is None:
        capacity = meta.vocabulary_size
    dtype = resolve_dtype(meta)
    weights = initializer.init(rng, (capacity, meta.embedding_dim), dtype,
                               device)
    slots = optimizer.init_slots(capacity, meta.embedding_dim, dtype, device)
    return TableState(weights=weights, slots=slots)


def pull(state: TableState, indices: torch.Tensor) -> torch.Tensor:
    """Rows for (possibly duplicated) indices of any shape; output shape
    ``indices.shape + (dim,)``, zero rows for invalid ids."""
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    rows = gather_rows(state.weights, indices.reshape(-1).contiguous())
    return rows.reshape(tuple(indices.shape) + (state.dim,))


def optimizer_block_update(optimizer: SparseOptimizer,
                           weights: torch.Tensor,
                           slots: Dict[str, torch.Tensor],
                           summed: torch.Tensor,
                           counts: torch.Tensor):
    """One optimizer step over a gathered ``[U, D]`` row block: the maths
    runs at >= float32 even for bfloat16 tables, and the results are cast
    back to each array's storage dtype."""
    compute = torch.promote_types(weights.dtype, torch.float32)
    new_w, new_s = optimizer.update_rows(
        weights.to(compute),
        {k: v.to(torch.promote_types(v.dtype, torch.float32))
         for k, v in slots.items()},
        summed.to(compute), counts)
    new_w = new_w.to(weights.dtype)
    new_s = {k: new_s[k].to(slots[k].dtype) for k in new_s}
    return new_w, new_s


def apply_gradients(state: TableState,
                    optimizer: Any,
                    indices: torch.Tensor,
                    grads: torch.Tensor,
                    *,
                    dedup_capacity: Optional[int] = None,
                    in_counts: Optional[torch.Tensor] = None) -> TableState:
    """Push and update in place: sum duplicate ids' gradients, update the
    touched rows and their slots, leave every other row as it was.

    ``indices`` has any shape, ``grads`` that shape plus ``[dim]``.
    Negative ids, ids ``>= capacity`` and the dedup buffer's padding are
    dropped (the JAX scatter's ``mode="drop"``). The dedup buffer holds
    ``dedup_capacity`` distinct ids (None: the batch's size, which no
    batch overflows); past it the largest ids and their gradients are
    dropped, as JAX drops them. ``in_counts`` ([n]) gives each entry's
    multiplicity when its gradient is already a sum (the owner side of
    the ``a2a`` push, ``parallel/alltoall.py``). Returns ``state``, whose
    tensors now hold the new rows (the JAX function returns a new state;
    its train step donates the old one).
    """
    optimizer = make_optimizer(optimizer)
    dim = state.dim
    flat_idx = indices.reshape(-1)
    flat_grads = grads.reshape(-1, dim)
    if flat_idx.shape[0] == 0:
        return state
    capacity = dedup_capacity or flat_idx.shape[0]

    observability.stage("push.dedup")
    uniq, inverse, valid = dedup.unique_indices(flat_idx, capacity)
    summed, counts = dedup.combine_gradients(
        flat_grads, inverse, capacity,
        None if in_counts is None else in_counts.reshape(-1))
    # JAX keeps ids >= capacity valid and drops them at the scatter; here
    # they drop before the gather, so they never read or write a real row
    valid = valid & (uniq >= 0) & (uniq < state.capacity)
    safe = torch.where(valid, uniq, torch.zeros_like(uniq)).to(torch.int64)
    observability.stage("push.update")
    w = state.weights.index_select(0, safe)
    s = {k: v.index_select(0, safe) for k, v in state.slots.items()}
    new_w, new_s = optimizer_block_update(optimizer, w, s, summed, counts)

    # Every buffer entry writes one row. The valid entries are one run of
    # the ascending buffer, [first, first + n_valid); a dropped entry
    # copies a valid entry of that run, row and values, spread over the
    # run so that no row takes many writes. A row is never written with
    # two different values (index_copy_ keeps an arbitrary one of
    # duplicates). With no valid entry all write row 0 back unchanged.
    first = torch.argmax(valid.to(torch.int32))
    n_valid = torch.clamp_min(valid.sum(), 1)
    pos = torch.arange(capacity, device=safe.device)
    src = torch.where(valid, pos, first + pos % n_valid)
    dst = safe.index_select(0, src)

    def commit(table, new, old):
        new = torch.where(valid.reshape((-1,) + (1,) * (new.dim() - 1)),
                          new, old)
        table.index_copy_(0, dst, new.index_select(0, src))

    commit(state.weights, new_w, w)
    for k in state.slots:
        commit(state.slots[k], new_s[k], s[k])
    return state
