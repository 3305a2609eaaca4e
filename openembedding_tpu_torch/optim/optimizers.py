"""Row-sparse embedding optimizers (``openembedding_tpu/optim/optimizers.py``).

This slice serves, so it needs an optimizer's state layout, not its
update: ``slot_shapes``, ``slot_init``, ``slot_dtype`` and ``init_slots``
size the slot tensors a checkpoint carries. ``default`` (stateless, what
serving runs) and ``adagrad`` (the headline training optimizer, whose
``accum`` slot a trainer's checkpoint holds) are ported. ``update_rows``
and the other seven categories arrive with the training slice (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..utils.config import coerce_fields

Slots = Dict[str, torch.Tensor]

# categories of the JAX package that the training slice ports
_LATER = ("adadelta", "adam", "adamax", "ftrl", "rmsprop", "sgd", "test")


class SparseOptimizer:
    """Base class for row-sparse optimizers (static config)."""

    category: str = ""

    def slot_shapes(self, dim: int) -> Dict[str, Tuple[int, ...]]:
        """Per-row trailing shapes of each state slot."""
        return {}

    def slot_init(self, name: str) -> float:
        return 0.0

    def slot_dtype(self, name: str, table_dtype: torch.dtype) -> torch.dtype:
        """Storage dtype for a slot: at least float32 whatever the table
        dtype (bf16 tables keep f32 optimizer statistics)."""
        return torch.promote_types(table_dtype, torch.float32)

    def init_slots(self, num_rows: int, dim: int, dtype: torch.dtype,
                   device) -> Slots:
        return {
            name: torch.full((num_rows,) + tuple(shape), self.slot_init(name),
                             dtype=self.slot_dtype(name, dtype),
                             device=device)
            for name, shape in self.slot_shapes(dim).items()
        }

    def update_rows(self, weights, slots, grads, counts):
        raise NotImplementedError(
            f"{self.category}.update_rows arrives with the training slice "
            "(ROADMAP.md Queue 1)")

    def state_dim(self, dim: int) -> int:
        return sum(math.prod(s) if s else 1
                   for s in self.slot_shapes(dim).values())

    def to_config(self) -> dict:
        out = {"category": self.category}
        out.update(dataclasses.asdict(self))
        return out


@dataclasses.dataclass(frozen=True)
class Default(SparseOptimizer):
    """Stateless; lr=0 (serving / frozen) or plain SGD when lr != 0."""

    learning_rate: float = 0.0
    category = "default"


@dataclasses.dataclass(frozen=True)
class Adagrad(SparseOptimizer):
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    epsilon: float = 1e-7
    category = "adagrad"

    def slot_shapes(self, dim):
        return {"accum": (dim,)}

    def slot_init(self, name):
        return self.initial_accumulator_value


_REGISTRY = {cls.category: cls for cls in (Default, Adagrad)}


def make_optimizer(config: Any) -> SparseOptimizer:
    """Build an optimizer from a SparseOptimizer, config dict, or name.

    Unknown categories raise ``ValueError`` naming the known ones; the
    JAX package's categories that are not ported yet raise
    ``NotImplementedError``.
    """
    if isinstance(config, SparseOptimizer):
        return config
    if isinstance(config, str):
        config = {"category": config}
    config = dict(config)
    category = config.pop("category")
    if category in _LATER:
        raise NotImplementedError(
            f"optimizer {category!r} arrives with the training slice "
            f"(ROADMAP.md Queue 1); ported: {sorted(_REGISTRY)}")
    if category not in _REGISTRY:
        raise ValueError(f"unknown optimizer category {category!r}; "
                         f"known: {sorted(set(_REGISTRY) | set(_LATER))}")
    cls = _REGISTRY[category]
    return cls(**coerce_fields(cls, config))
