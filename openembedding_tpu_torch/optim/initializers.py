"""Row initializers for embedding tables (``openembedding_tpu/optim/initializers.py``).

``constant``, ``uniform`` (minval/maxval) and ``normal`` (mean/stddev, with
the +/-2 stddev truncated variant), with the JAX package's config dicts.
Draws come from an explicit ``torch.Generator`` on the target device, so a
table initializes where it lives. They cannot match ``jax.random`` bit for
bit: tests that compare the two packages copy the initial state over
(``interop.py``) instead of comparing draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..utils.config import coerce_fields


class Initializer:
    """Base class. ``init(generator, shape, dtype, device)`` makes rows."""

    category: str = ""

    def init(self, generator: Optional[torch.Generator], shape,
             dtype: torch.dtype, device) -> torch.Tensor:
        raise NotImplementedError

    def to_config(self) -> dict:
        out = {"category": self.category}
        out.update(dataclasses.asdict(self))
        return out


@dataclasses.dataclass(frozen=True)
class Constant(Initializer):
    value: float = 0.0
    category = "constant"

    def init(self, generator, shape, dtype, device):
        del generator
        return torch.full(shape, self.value, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Uniform(Initializer):
    minval: float = -1.0
    maxval: float = 1.0
    category = "uniform"

    def init(self, generator, shape, dtype, device):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        x.uniform_(self.minval, self.maxval, generator=generator)
        return x.to(dtype)


@dataclasses.dataclass(frozen=True)
class Normal(Initializer):
    mean: float = 0.0
    stddev: float = 1.0
    truncated: bool = False
    category = "normal"

    def init(self, generator, shape, dtype, device):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        if self.truncated:
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
        else:
            x.normal_(0.0, 1.0, generator=generator)
        return (x * self.stddev + self.mean).to(dtype)


_REGISTRY = {
    "constant": Constant,
    "uniform": Uniform,
    "normal": Normal,
}


def make_initializer(config: Any) -> Initializer:
    """Build an initializer from an Initializer, config dict, or name."""
    if isinstance(config, Initializer):
        return config
    if isinstance(config, str):
        config = {"category": config}
    config = dict(config)
    category = config.pop("category")
    if category not in _REGISTRY:
        raise ValueError(f"unknown initializer category {category!r}; "
                         f"known: {sorted(_REGISTRY)}")
    cls = _REGISTRY[category]
    return cls(**coerce_fields(cls, config))
