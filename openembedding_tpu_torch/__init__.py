"""openembedding_tpu_torch: the PyTorch + CUDA port of openembedding_tpu.

A second package beside the JAX one, which stays the reference. This
slice serves array tables: checkpoints in the JAX package's on-disk
layout load onto an NVIDIA GPU and answer REST lookups, every pull going
through the hand-written CUDA row-gather kernel (``ops/gather.py``,
``csrc/gather_rows.cu``). Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no device named they raise.
The package imports torch and numpy, never jax or openembedding_tpu.
"""

from .embedding import EmbeddingCollection, EmbeddingSpec
from .meta import (EmbeddingVariableMeta, ModelMeta, ModelStatus,
                   ModelVariableMeta)
from .table import TableState, create_table, pull

__all__ = [
    "EmbeddingCollection", "EmbeddingSpec", "EmbeddingVariableMeta",
    "ModelMeta", "ModelStatus", "ModelVariableMeta", "TableState",
    "create_table", "pull",
]
