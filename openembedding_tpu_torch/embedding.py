"""Embedding specs and a collection of tables on one device
(``openembedding_tpu/embedding.py``).

``EmbeddingSpec`` keeps the JAX package's fields and validation, so a
model's spec list reads the same in both packages. ``EmbeddingCollection``
is the single-device case of the JAX collection: variable ids by
registration order, the same ``model_meta`` JSON, ``init`` and ``pull``,
for array tables and for hash tables (``input_dim=-1``) with ``"wide"``
pair keys or ``"int32"`` keys. Hash pulls are read-only here (missing keys
give zero rows). What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP.md item: a hash pull with an
initializer (the training contract), ``key_dtype="int64"``, pooled
sequence features, the hot-row cache (``cache_k``), and every exchange
plane but the one-shard ``a2a``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .meta import (UNBOUNDED_VOCAB, EmbeddingVariableMeta, ModelMeta,
                   ModelVariableMeta)
from .optim.initializers import make_initializer
from .optim.optimizers import make_optimizer
from . import hash_table as hash_lib
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
        if self.use_hash and self.key_dtype == "int64":
            raise not_ported(f"hash variable {self.name!r} with "
                             "key_dtype='int64'", "int64 hash keys")
        if self.use_hash and self.key_dtype not in ("wide", "int32"):
            raise ValueError(f"embedding {self.name!r}: unknown key_dtype "
                             f"{self.key_dtype!r}; known: ('wide', "
                             "'int32', 'int64')")
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
        if self.cache_k:
            raise not_ported(f"hot-row cache of {self.name!r} "
                             f"(cache_k={self.cache_k})",
                             "multi-shard exchange planes")

    @property
    def use_hash(self) -> bool:
        return self.input_dim == -1

    def meta(self) -> EmbeddingVariableMeta:
        vocab = UNBOUNDED_VOCAB if self.use_hash else self.input_dim
        return EmbeddingVariableMeta(datatype=self.dtype,
                                     embedding_dim=self.output_dim,
                                     vocabulary_size=vocab)


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
        """Materialize every variable (``only`` restricts to some names).
        Hash variables start empty, ``round_capacity(hash_capacity)``
        slots."""
        states = {}
        for name, spec in self.specs.items():
            if only is not None and name not in only:
                continue
            if spec.use_hash:
                states[name] = hash_lib.create_hash_table(
                    spec.meta(), self._optimizers[name],
                    capacity=spec.hash_capacity, key_dtype=spec.key_dtype,
                    device=self.device)
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
        """Rows for every input column: ``name -> rows``, shaped
        ``indices.shape + (dim,)`` (``indices.shape[:-1] + (dim,)`` for
        pair keys on a wide hash variable).

        Inputs are integer tensors or numpy arrays of any shape; they move
        to the collection's device. ``read_only`` selects the serving
        contract for hash variables (missing keys give zero rows); a hash
        pull without it needs per-key init rows, which the training slice
        brings. ``batch_sharded`` and ``serving_rows`` keep the JAX
        signature and select nothing on one device without pooling.
        """
        del batch_sharded, serving_rows
        rows = {}
        for name, idx in inputs.items():
            spec = self.specs[name]
            idx = self._widen(spec, idx)
            if not isinstance(idx, torch.Tensor):
                idx = torch.from_numpy(np.array(idx, copy=True))
            if idx.dtype.is_floating_point or idx.dtype == torch.bool:
                raise TypeError(f"{name!r}: indices must be integers, got "
                                f"{idx.dtype}")
            idx = idx.to(self.device, non_blocking=True)
            if spec.use_hash:
                if spec.key_dtype == "wide" and not (
                        idx.ndim >= 2 and idx.shape[-1] == 2):
                    idx = hash_lib.widen_ids(idx)
                rows[name] = hash_lib.pull(
                    states[name], idx,
                    None if read_only else self._initializers[name])
            else:
                rows[name] = table_lib.pull(states[name], idx)
        return rows

    def _widen(self, spec: EmbeddingSpec, idx):
        """Host int64 ids for a hash variable, before they move to the
        device: (lo, hi) pairs for a wide variable, int32 for an int32 one;
        every other input passes.

        The JAX collection's rule (``EmbeddingCollection._widen``): a
        trailing dim of 2 IS a pair axis (pooled specs, whose ``[B, L=2]``
        matrices are sequences, are not ported, so the serving rule
        ``pair_ndim=2`` is the only one). Host int64 ids split on the host
        (``hash_table.split64``); host pair words typed int64, and int64
        ids for an int32-key table, must fit int32, never wrap. Narrow ids
        that reach the device widen there (``hash_table.widen_ids``, in
        :meth:`pull`).
        """
        if not spec.use_hash or isinstance(idx, torch.Tensor):
            return idx
        arr = np.asarray(idx)
        if arr.dtype.kind not in "iu" or arr.dtype.itemsize != 8:
            return arr
        pairs = arr.ndim >= 2 and arr.shape[-1] == 2
        if spec.key_dtype == "wide" and not pairs:
            return hash_lib.split64(arr)
        if arr.size and (arr.max() > np.iinfo(np.int32).max
                         or arr.min() < np.iinfo(np.int32).min):
            raise ValueError(
                f"embedding {spec.name!r}: ids exceed int32 — pass "
                "hash_table.split64(ids) pairs to a key_dtype='wide' "
                "variable, not raw 64-bit ids")
        return arr.astype(np.int32)
