"""Row-sparse embedding optimizers (``openembedding_tpu/optim/optimizers.py``).

The JAX package's nine categories, with the same config fields, slot
layout and ``update_rows`` arithmetic, expression for expression, so that
rounding stays close: ``default`` (stateless), ``adadelta``, ``adagrad``,
``adam`` (with per-row ``beta_1_t``/``beta_2_t`` power slots of shape
``(1,)``), ``adamax``, ``ftrl`` (square roots where
``learning_rate_power == -0.5``), ``rmsprop``, ``sgd`` (momentum and
nesterov) and the deterministic ``test`` optimizer, which divides by the
duplicate count.

``update_rows`` takes a ``[U, D]`` block of gathered rows, their slots,
the summed gradients and the duplicate counts, and returns new weights and
slots; ``table.optimizer_block_update`` runs it at >= float32 and casts
back to each array's storage dtype. Only touched rows are updated (no
state decay for untouched rows), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..utils.config import coerce_fields

Slots = Dict[str, torch.Tensor]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root. PyTorch's vectorized float32 sqrt on
    the CPU is one unit in the last place off for about 1 % of inputs
    (XLA's and CUDA's are exact), and FTRL's difference of two roots
    magnifies that; the float64 root rounds to the exact float32 one."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


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

    def update_rows(self, weights: torch.Tensor, slots: Slots,
                    grads: torch.Tensor, counts: torch.Tensor
                    ) -> Tuple[torch.Tensor, Slots]:
        """Apply one step to a [U, D] block of rows. Returns new (weights,
        slots)."""
        raise NotImplementedError

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

    def update_rows(self, weights, slots, grads, counts):
        if self.learning_rate != 0:
            weights = weights - self.learning_rate * grads
        return weights, slots


@dataclasses.dataclass(frozen=True)
class Adadelta(SparseOptimizer):
    learning_rate: float = 0.001
    rho: float = 0.95
    epsilon: float = 1e-7
    category = "adadelta"

    def slot_shapes(self, dim):
        return {"accum": (dim,), "accum_update": (dim,)}

    def update_rows(self, weights, slots, grads, counts):
        accum = slots["accum"] * self.rho + grads * grads * (1 - self.rho)
        update = grads * _sqrt(slots["accum_update"] + self.epsilon) \
            / _sqrt(accum + self.epsilon)
        accum_update = slots["accum_update"] * self.rho \
            + update * update * (1 - self.rho)
        weights = weights - self.learning_rate * update
        return weights, {"accum": accum, "accum_update": accum_update}


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

    def update_rows(self, weights, slots, grads, counts):
        accum = slots["accum"] + grads * grads
        weights = weights - self.learning_rate * grads \
            / (_sqrt(accum) + self.epsilon)
        return weights, {"accum": accum}


@dataclasses.dataclass(frozen=True)
class Adam(SparseOptimizer):
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7
    category = "adam"

    def slot_shapes(self, dim):
        # beta powers are per-row scalars
        return {"m": (dim,), "v": (dim,), "beta_1_t": (1,),
                "beta_2_t": (1,)}

    def slot_init(self, name):
        return 1.0 if name in ("beta_1_t", "beta_2_t") else 0.0

    def update_rows(self, weights, slots, grads, counts):
        beta_1_t = slots["beta_1_t"] * self.beta_1
        beta_2_t = slots["beta_2_t"] * self.beta_2
        lr_t = self.learning_rate * _sqrt(1 - beta_2_t) / (1 - beta_1_t)
        m = slots["m"] * self.beta_1 + grads * (1 - self.beta_1)
        v = slots["v"] * self.beta_2 + grads * grads * (1 - self.beta_2)
        weights = weights - lr_t * m / (_sqrt(v) + self.epsilon)
        return weights, {"m": m, "v": v, "beta_1_t": beta_1_t,
                         "beta_2_t": beta_2_t}


@dataclasses.dataclass(frozen=True)
class Adamax(SparseOptimizer):
    learning_rate: float = 0.001
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7
    category = "adamax"

    def slot_shapes(self, dim):
        return {"m": (dim,), "v": (dim,), "beta_1_t": (1,)}

    def slot_init(self, name):
        return 1.0 if name == "beta_1_t" else 0.0

    def update_rows(self, weights, slots, grads, counts):
        beta_1_t = slots["beta_1_t"] * self.beta_1
        lr_t = self.learning_rate / (1 - beta_1_t)
        m = slots["m"] * self.beta_1 + grads * (1 - self.beta_1)
        v = torch.maximum(torch.abs(grads), slots["v"] * self.beta_2)
        weights = weights - lr_t * m / (v + self.epsilon)
        return weights, {"m": m, "v": v, "beta_1_t": beta_1_t}


@dataclasses.dataclass(frozen=True)
class Ftrl(SparseOptimizer):
    learning_rate: float = 0.001
    initial_accumulator_value: float = 0.1
    l1_regularization_strength: float = 0.0
    l2_regularization_strength: float = 0.0
    l2_shrinkage_regularization_strength: float = 0.0
    learning_rate_power: float = -0.5
    beta: float = 0.0
    category = "ftrl"

    def slot_shapes(self, dim):
        return {"accum": (dim,), "linear": (dim,)}

    def slot_init(self, name):
        return self.initial_accumulator_value if name == "accum" else 0.0

    def update_rows(self, weights, slots, grads, counts):
        # TF-compatible FTRL with l2_shrinkage and a generic
        # learning_rate_power
        lr = self.learning_rate
        adjusted_l2 = self.l2_regularization_strength + self.beta / lr / 2
        g = grads + 2 * self.l2_shrinkage_regularization_strength * weights
        accum_new = slots["accum"] + grads * grads
        p = -self.learning_rate_power
        if self.learning_rate_power == -0.5:
            pow_new, pow_old = _sqrt(accum_new), \
                _sqrt(slots["accum"])
        else:
            pow_new, pow_old = accum_new ** p, slots["accum"] ** p
        sigma = (pow_new - pow_old) / lr
        linear = slots["linear"] + g - sigma * weights
        quadratic = pow_new / lr + 2 * adjusted_l2
        l1 = self.l1_regularization_strength
        l1_reg_adjust = torch.clamp(linear, -l1, l1)
        weights = (l1_reg_adjust - linear) / quadratic
        return weights, {"accum": accum_new, "linear": linear}


@dataclasses.dataclass(frozen=True)
class RMSprop(SparseOptimizer):
    learning_rate: float = 0.001
    rho: float = 0.9
    momentum: float = 0.0
    epsilon: float = 1e-7
    category = "rmsprop"

    def slot_shapes(self, dim):
        return {"accum": (dim,), "moment": (dim,)}

    def update_rows(self, weights, slots, grads, counts):
        accum = slots["accum"] * self.rho + grads * grads * (1 - self.rho)
        moment = slots["moment"] * self.momentum \
            + self.learning_rate * grads / _sqrt(accum + self.epsilon)
        weights = weights - moment
        return weights, {"accum": accum, "moment": moment}


@dataclasses.dataclass(frozen=True)
class SGD(SparseOptimizer):
    learning_rate: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    category = "sgd"

    def slot_shapes(self, dim):
        return {"moment": (dim,)}

    def update_rows(self, weights, slots, grads, counts):
        moment = slots["moment"] * self.momentum + self.learning_rate * grads
        if self.nesterov:
            weights = weights - (moment * self.momentum
                                 + self.learning_rate * grads)
        else:
            weights = weights - moment
        return weights, {"moment": moment}


@dataclasses.dataclass(frozen=True)
class Test(SparseOptimizer):
    """Deterministic flip-state optimizer for tests: the state flips
    between ``init`` and ``flip - state`` each update, and weights +=
    lr * grad / count + new state, so the expected value is computable by
    the caller."""

    learning_rate: float = 0.1
    flip: float = 10000.0
    init: float = 0.0
    category = "test"

    def slot_shapes(self, dim):
        return {"flip_state": (1,)}

    def slot_init(self, name):
        return self.init

    def update_rows(self, weights, slots, grads, counts):
        state = self.flip - slots["flip_state"]
        counts = torch.clamp_min(counts, 1).to(weights.dtype)[:, None]
        weights = weights + self.learning_rate * grads / counts + state
        return weights, {"flip_state": state}


_REGISTRY = {
    cls.category: cls
    for cls in (Default, Adadelta, Adagrad, Adam, Adamax, Ftrl, RMSprop,
                SGD, Test)
}


def make_optimizer(config: Any) -> SparseOptimizer:
    """Build an optimizer from a SparseOptimizer, config dict, or name.

    Unknown categories raise ``ValueError`` naming the known ones.
    """
    if isinstance(config, SparseOptimizer):
        return config
    if isinstance(config, str):
        config = {"category": config}
    config = dict(config)
    category = config.pop("category")
    if category not in _REGISTRY:
        raise ValueError(f"unknown optimizer category {category!r}; "
                         f"known: {sorted(_REGISTRY)}")
    cls = _REGISTRY[category]
    return cls(**coerce_fields(cls, config))
