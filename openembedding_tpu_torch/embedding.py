"""Embedding specs and a collection of tables on one device
(``openembedding_tpu/embedding.py``).

``EmbeddingSpec`` keeps the JAX package's fields and validation, so a
model's spec list reads the same in both packages. ``EmbeddingCollection``
is the single-device case of the JAX collection: variable ids by
registration order, the same ``model_meta`` JSON, ``init`` and ``pull``.
What this slice does not run raises ``NotImplementedError`` naming its
ROADMAP.md item: hash tables (``input_dim=-1``), pooled sequence features,
and every exchange plane but the one-shard ``a2a``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .meta import EmbeddingVariableMeta, ModelMeta, ModelVariableMeta
from .optim.initializers import make_initializer
from .optim.optimizers import make_optimizer
from . import table as table_lib
from .utils.device import DeviceLike, resolve_device

POOLINGS = ("sum", "mean", "sqrtn")
_LAYOUTS = ("mod", "div")
_PRECISIONS = ("f32", "bf16", "int8_ef")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for what a later slice of the port brings; ``item`` names
    its ROADMAP.md Queue 1 entry."""
    return NotImplementedError(
        f"{what} is not in the torch port yet (ROADMAP.md Queue 1, {item})")


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one embedding variable (the JAX package's
    ``EmbeddingSpec``, same fields and defaults)."""

    name: str
    input_dim: int                   # -1 => unbounded hash-key space
    output_dim: int
    dtype: str = "float32"
    optimizer: Any = None            # None => collection default
    initializer: Any = None          # None => collection default
    num_shards: int = -1             # -1 => one shard per device
    hash_capacity: int = 2**20
    layout: str = "mod"
    key_dtype: Optional[str] = None  # None resolves to "wide" for hash
    plane: str = "a2a"
    a2a_capacity: int = 0
    a2a_slack: float = 2.0
    cache_k: int = 0
    exchange_precision: str = "f32"
    push_precision: str = "f32"
    cache_refresh_every: int = 64
    cache_decay: float = 0.8
    pooling: Optional[str] = None

    def __post_init__(self):
        if self.key_dtype is None:
            object.__setattr__(self, "key_dtype",
                               "wide" if self.input_dim == -1 else "int32")
        if self.pooling is not None and self.pooling not in POOLINGS:
            raise ValueError(
                f"embedding {self.name!r}: unknown pooling "
                f"{self.pooling!r}; known: {POOLINGS}")
        if self.layout not in _LAYOUTS:
            raise ValueError(f"embedding {self.name!r}: unknown layout "
                             f"{self.layout!r}; known: {_LAYOUTS}")
        for knob in ("exchange_precision", "push_precision"):
            if getattr(self, knob) not in _PRECISIONS:
                raise ValueError(
                    f"embedding {self.name!r}: unknown {knob} "
                    f"{getattr(self, knob)!r}; known: {_PRECISIONS}")
        if self.use_hash:
            raise not_ported(f"hash variable {self.name!r} (input_dim=-1)",
                             "hash-table serving path")
        if self.pooling is not None:
            raise not_ported(f"pooled variable {self.name!r}",
                             "ragged and hybrid features")
        if self.plane != "a2a" or self.num_shards not in (-1, 1) \
                or self.exchange_precision != "f32" \
                or self.push_precision != "f32":
            raise not_ported(
                f"variable {self.name!r} on plane {self.plane!r} with "
                f"num_shards={self.num_shards}, precisions "
                f"{self.exchange_precision}/{self.push_precision}",
                "multi-shard exchange planes")

    @property
    def use_hash(self) -> bool:
        return self.input_dim == -1

    def meta(self) -> EmbeddingVariableMeta:
        return EmbeddingVariableMeta(datatype=self.dtype,
                                     embedding_dim=self.output_dim,
                                     vocabulary_size=self.input_dim)


class EmbeddingCollection:
    """All sparse variables of one model, on one device.

    ``states`` (from :meth:`init` or ``checkpoint.load_checkpoint``) is a
    plain dict ``name -> TableState``. ``default_optimizer`` is the
    stateless ``default`` until the training slice ports ``sgd`` (the JAX
    collection's default).
    """

    num_shards = 1

    def __init__(self, specs, device: DeviceLike = None,
                 default_optimizer: Any = None,
                 default_initializer: Any = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)
        if default_optimizer is None:
            default_optimizer = {"category": "default"}
        if default_initializer is None:
            default_initializer = dict(table_lib.DEFAULT_INITIALIZER)
        self.specs: Dict[str, EmbeddingSpec] = {}
        self._variable_ids: Dict[str, int] = {}
        self._optimizers = {}
        self._initializers = {}
        for i, spec in enumerate(specs):
            if spec.name in self.specs:
                raise ValueError(f"duplicate embedding name {spec.name!r}")
            self.specs[spec.name] = spec
            self._variable_ids[spec.name] = i
            self._optimizers[spec.name] = make_optimizer(
                spec.optimizer if spec.optimizer is not None
                else default_optimizer)
            self._initializers[spec.name] = make_initializer(
                spec.initializer if spec.initializer is not None
                else default_initializer)

    # --- introspection -----------------------------------------------------
    def variable_id(self, name: str) -> int:
        return self._variable_ids[name]

    def optimizer(self, name: str):
        return self._optimizers[name]

    def initializer(self, name: str):
        return self._initializers[name]

    def model_meta(self, model_sign: str = "",
                   model_uri: str = "") -> ModelMeta:
        variables = [
            ModelVariableMeta(meta=self.specs[name].meta(),
                              variable_id=self._variable_ids[name],
                              name=name)
            for name in self.specs
        ]
        variables.sort(key=lambda v: v.variable_id)
        meta = ModelMeta(model_sign=model_sign, model_uri=model_uri,
                         variables=variables, num_shards=self.num_shards)
        meta.extra["variable_num_shards"] = {
            name: self.num_shards for name in self.specs}
        return meta

    # --- state lifecycle ---------------------------------------------------
    def generator(self, name: str) -> torch.Generator:
        """The generator that initializes ``name``: on the collection's
        device, seeded from the collection seed and the variable id."""
        g = torch.Generator(device=self.device)
        seq = np.random.SeedSequence([self.seed, self._variable_ids[name]])
        g.manual_seed(int(seq.generate_state(1, np.uint64)[0] >> 1))
        return g

    def init(self, only: Optional[Any] = None) -> Dict[str, Any]:
        """Materialize every variable (``only`` restricts to some names)."""
        states = {}
        for name, spec in self.specs.items():
            if only is not None and name not in only:
                continue
            states[name] = table_lib.create_table(
                spec.meta(), self._optimizers[name],
                self._initializers[name], generator=self.generator(name),
                device=self.device)
        return states

    # --- data plane --------------------------------------------------------
    def pull(self, states: Dict[str, Any], inputs: Dict[str, Any], *,
             batch_sharded: bool = True, read_only: bool = False,
             serving_rows: bool = False) -> Dict[str, torch.Tensor]:
        """Rows for every input column: ``name -> indices.shape + (dim,)``.

        Inputs are integer tensors or numpy arrays of any shape; they move
        to the collection's device. ``batch_sharded``, ``read_only`` and
        ``serving_rows`` keep the JAX signature; on one device with array
        tables they select nothing (they matter for hash tables, pooling
        and the exchange planes).
        """
        del batch_sharded, read_only, serving_rows
        rows = {}
        for name, idx in inputs.items():
            if not isinstance(idx, torch.Tensor):
                idx = torch.from_numpy(np.array(idx, copy=True))
            if idx.dtype.is_floating_point or idx.dtype == torch.bool:
                raise TypeError(f"{name!r}: indices must be integers, got "
                                f"{idx.dtype}")
            rows[name] = table_lib.pull(states[name],
                                        idx.to(self.device,
                                               non_blocking=True))
        return rows
