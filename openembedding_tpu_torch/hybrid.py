"""The ``sparse_as_dense`` hybrid: small-vocabulary embeddings kept as
dense parameters (``openembedding_tpu/hybrid.py``).

A feature whose vocabulary is small (``input_dim <= sparse_as_dense_size``,
or below the batch size) costs less as a dense parameter than as a table
behind the pull and the push: the reference's "Cache" mode. Such a feature
becomes a ``Parameter`` of the model, updated by the dense optimizer on
every step (dense semantics: Adam keeps moving a row that an earlier
batch touched, which the sparse path never does), while the large tables
stay in the ``EmbeddingCollection``. ``Trainer(sparse_as_dense=...)``
wraps the model in :class:`HybridModel` and routes each batch column by
name.

The modules keep flax's names: ``HybridModel``'s children are ``inner``
and ``sparse_as_dense``, and ``DenseEmbeddings`` holds one table per
spec under the spec's name, so a flax tree ``{"inner": {...},
"sparse_as_dense": {name: table}}`` maps onto the port's parameters by
``interop.dense_params_from_flax``. As in flax, a table exists only for
the dense-kept columns of the batch ``init`` saw
(``models.deepctr.init_params(dense_ids=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from . import ragged
from . import table as table_lib
from .embedding import EmbeddingSpec
from .optim.initializers import make_initializer

DENSE_SCOPE = "sparse_as_dense"     # flax's name of the dense-kept tables


@dataclasses.dataclass(frozen=True)
class DenseFeatureSpec:
    """Static description of one dense-kept (sparse_as_dense) feature."""

    name: str
    input_dim: int
    output_dim: int
    dtype: str = "float32"
    initializer: Optional[tuple] = None  # frozen config items or None
    pooling: Optional[str] = None        # sequence combiner, as EmbeddingSpec


def _freeze_config(cfg) -> Optional[tuple]:
    if cfg is None:
        return None
    if isinstance(cfg, dict):
        return tuple(sorted(cfg.items()))
    return cfg


def _thaw_config(cfg):
    return dict(cfg) if isinstance(cfg, tuple) else cfg


def to_dense_spec(spec: EmbeddingSpec) -> DenseFeatureSpec:
    """The dense-kept form of an array spec; a hash variable raises (its
    key space is unbounded)."""
    if spec.use_hash:
        raise ValueError(
            f"hash variable {spec.name!r} cannot be kept dense "
            "(unbounded key space; the reference's threshold only ever "
            "converts bounded vocabs, exb.py:617-632)")
    return DenseFeatureSpec(
        name=spec.name, input_dim=spec.input_dim, output_dim=spec.output_dim,
        dtype=spec.dtype, initializer=_freeze_config(spec.initializer),
        pooling=spec.pooling)


def split_sparse_dense(specs: Sequence[EmbeddingSpec],
                       sparse_as_dense_size: int = 64,
                       batch_size: Optional[int] = None
                       ) -> Tuple[Tuple[EmbeddingSpec, ...],
                                  Tuple[DenseFeatureSpec, ...]]:
    """Partition specs into (collection, dense-kept) by vocabulary, the
    reference's rule: a bounded vocabulary ``<= sparse_as_dense_size``,
    or smaller than the global batch when it is given, is kept dense."""
    sparse, dense = [], []
    for spec in specs:
        small = (not spec.use_hash) and (
            spec.input_dim <= sparse_as_dense_size
            or (batch_size is not None and spec.input_dim < batch_size))
        (dense if small else sparse).append(spec)
    return tuple(sparse), tuple(to_dense_spec(s) for s in dense)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DenseEmbeddings(nn.Module):
    """The dense-kept tables, one ``Parameter`` ``[input_dim, output_dim]``
    per spec, named as the spec (flax's ``DenseEmbeddings``).

    The lookup keeps the framework's invalid-index contract: ids outside
    ``[0, input_dim)`` give zero rows and no gradient (``where``, then
    ``index_select``, then zero rows, as JAX's ``take`` under ``where``).
    A pooled spec pools its ``[B, L]`` rows with ``ragged.pool_rows``
    (padding ``-1``)."""

    def __init__(self, specs: Sequence[DenseFeatureSpec]):
        super().__init__()
        self.specs = tuple(specs)
        for s in self.specs:
            self.register_parameter(s.name, nn.Parameter(torch.empty(
                (s.input_dim, s.output_dim), dtype=_DTYPES[s.dtype])))

    def initializer(self, name: str):
        """The initializer of table ``name``: its spec's, else the tables'
        default (``table.DEFAULT_INITIALIZER``)."""
        spec = next(s for s in self.specs if s.name == name)
        return make_initializer(_thaw_config(spec.initializer)
                                or table_lib.DEFAULT_INITIALIZER)

    def forward(self, ids: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        rows = {}
        for s in self.specs:
            if s.name not in ids:
                continue
            table = getattr(self, s.name)
            idx = ids[s.name]
            flat = idx.reshape(-1)
            valid = (flat >= 0) & (flat < s.input_dim)
            r = table.index_select(0, torch.where(valid, flat, 0))
            r = torch.where(valid[:, None], r, torch.zeros_like(r))
            r = r.reshape(tuple(idx.shape) + (s.output_dim,))
            if s.pooling:
                r = ragged.pool_rows(r, idx, s.pooling, -1, s.input_dim)
            rows[s.name] = r
        return rows


class HybridModel(nn.Module):
    """The inner CTR model and the dense-kept tables in one module:
    ``forward(dense, rows, dense_ids)`` looks ``dense_ids`` up in the
    tables, merges them with the collection's ``rows`` and runs the
    inner model."""

    def __init__(self, inner: nn.Module,
                 dense_specs: Sequence[DenseFeatureSpec]):
        super().__init__()
        self.inner = inner
        self.add_module(DENSE_SCOPE, DenseEmbeddings(dense_specs))

    def forward(self, dense, rows: Dict[str, torch.Tensor],
                dense_ids: Dict[str, torch.Tensor]):
        drows = getattr(self, DENSE_SCOPE)(dense_ids)
        return self.inner(dense, {**rows, **drows})
