"""Dense optimizers for the model's parameters, in optax's form.

Counterparts of the ``optax`` transforms the JAX package's trainer takes:
``optax.adagrad`` (``scale_by_rss`` then ``scale_by_learning_rate``) and
``optax.sgd`` without momentum. An optimizer works on a dict of named
parameter tensors with explicit state, a dict of tensors under the same
names: ``init(params)`` makes the state, ``apply(params, grads, state)``
updates parameters and state in place. The expressions are optax's, so
the rounding stays close: Adagrad's accumulator starts at
``initial_accumulator_value`` and its ``eps`` sits inside the root, unlike
``torch.optim.Adagrad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adagrad:
    """``optax.adagrad``: ``s += g²``; ``u = where(s > 0, rsqrt(s + eps),
    0) · g``; ``p += -lr · u``. The state holds ``s`` per parameter
    (optax's ``ScaleByRssState.sum_of_squares``)."""

    learning_rate: float
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params: Params) -> Params:
        return {k: torch.full_like(v, self.initial_accumulator_value)
                for k, v in params.items()}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: Params) -> None:
        for k, p in params.items():
            g, s = grads[k], state[k]
            s.copy_(torch.square(g) + s)
            scale = torch.where(s > 0, torch.rsqrt(s + self.eps),
                                torch.zeros_like(s))
            p.copy_(p + -self.learning_rate * (scale * g))


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd`` without momentum: ``p += -lr · g``; no state."""

    learning_rate: float

    def init(self, params: Params) -> Params:
        return {}

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: Params) -> None:
        for k, p in params.items():
            p.copy_(p + -self.learning_rate * grads[k])


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Adagrad:
    return Adagrad(learning_rate, initial_accumulator_value, eps)


def sgd(learning_rate: float) -> SGD:
    return SGD(learning_rate)
