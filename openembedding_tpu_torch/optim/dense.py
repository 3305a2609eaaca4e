"""Dense optimizers for the model's parameters, in optax's form.

Counterparts of the ``optax`` transforms the JAX package's trainer takes:
``optax.adagrad`` (``scale_by_rss`` then ``scale_by_learning_rate``),
``optax.adam`` (``scale_by_adam`` then ``scale_by_learning_rate``) and
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


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam``: ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² +
    b2·nu``, ``count += 1``; ``u = (mu / (1 - b1^count)) / (sqrt(nu / (1 -
    b2^count) + eps_root) + eps)``; ``p += -lr · u``. The state holds
    ``count`` (an int32 device scalar, as optax's), and ``mu/<name>`` and
    ``nu/<name>`` per parameter (``ScaleByAdamState``). The bias
    correction is computed on the device from ``count``, so a step reads
    nothing back and stays capturable.

    Not bit-equal to optax: ``b^count`` is a float32 ``pow``, which
    neither XLA nor PyTorch rounds correctly (they differ by an ulp for
    ~16 % of counts), and XLA on the CPU fuses each moment update into one
    multiply-add, which the port rounds twice. Parameters agree within
    ~1 float32 ulp over thousands of updates (``tests/test_torch_hybrid.py``
    holds 5 updates within rtol 1e-6)."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params: Params) -> Params:
        device = next(iter(params.values())).device if params else None
        state = {"count": torch.zeros((), dtype=torch.int32, device=device)}
        for k, v in params.items():
            state["mu/" + k] = torch.zeros_like(v)
            state["nu/" + k] = torch.zeros_like(v)
        return state

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: Params) -> None:
        # ``_foreach`` ops: a few launches for all parameters, not a few
        # per parameter (the step's dense-kept tables are many)
        count = state["count"]
        top = torch.iinfo(count.dtype).max
        count.copy_(torch.where(count < top, count + 1, count))
        steps = count.to(torch.float32)
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        mus = [state["mu/" + k] for k in names]
        nus = [state["nu/" + k] for k in names]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - self.b1))
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - self.b2)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, sq)
        u = torch._foreach_div(mus, 1 - torch.pow(self.b1, steps))
        den = torch._foreach_div(nus, 1 - torch.pow(self.b2, steps))
        torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        torch._foreach_mul_(u, -self.learning_rate)
        torch._foreach_add_(ps, u)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Adagrad:
    return Adagrad(learning_rate, initial_accumulator_value, eps)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> Adam:
    return Adam(learning_rate, b1, b2, eps, eps_root)


def sgd(learning_rate: float) -> SGD:
    return SGD(learning_rate)
