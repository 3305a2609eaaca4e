"""Single-shard embedding table (``openembedding_tpu/table.py``).

The table is a dense ``[capacity, dim]`` tensor plus named optimizer slot
tensors co-indexed with it. ``pull`` is one row gather through the CUDA
kernel of ``ops/gather.py`` (the plain version on CPU tensors), with the
framework-wide invalid-index contract: ids ``< 0`` or ``>= capacity`` give
zero rows. ``apply_gradients`` arrives with the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .meta import EmbeddingVariableMeta
from .ops.gather import gather_rows
from .optim.initializers import make_initializer
from .optim.optimizers import make_optimizer
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
                 generator: Optional[torch.Generator] = None,
                 capacity: Optional[int] = None,
                 device: DeviceLike = None) -> TableState:
    """Materialize a table (weights initialized, slots at their init value)
    on ``device`` (cuda unless named). ``generator`` must live on that
    device; None draws from a fresh generator seeded 0."""
    device = resolve_device(device)
    optimizer = make_optimizer(optimizer)
    initializer = make_initializer(initializer or DEFAULT_INITIALIZER)
    if capacity is None:
        capacity = meta.vocabulary_size
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dtype = resolve_dtype(meta)
    weights = initializer.init(generator, (capacity, meta.embedding_dim),
                               dtype, device)
    slots = optimizer.init_slots(capacity, meta.embedding_dim, dtype, device)
    return TableState(weights=weights, slots=slots)


def pull(state: TableState, indices: torch.Tensor) -> torch.Tensor:
    """Rows for (possibly duplicated) indices of any shape; output shape
    ``indices.shape + (dim,)``, zero rows for invalid ids."""
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    rows = gather_rows(state.weights, indices.reshape(-1).contiguous())
    return rows.reshape(tuple(indices.shape) + (state.dim,))
