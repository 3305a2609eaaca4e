"""openembedding_tpu_torch: the PyTorch + CUDA port of openembedding_tpu.

A second package beside the JAX one, which stays the reference. The port
serves: checkpoints in the JAX package's on-disk layout load onto an
NVIDIA GPU and answer REST lookups. Array tables pull through the
hand-written CUDA row-gather kernel (``ops/gather.py``,
``csrc/gather_rows.cu``), hash tables through the hand-written CUDA
probe-gather kernel (``ops/probe_gather.py``, ``csrc/probe_gather.cu``).
Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no device named they raise.
The package imports torch and numpy, never jax or openembedding_tpu.
"""

from .embedding import EmbeddingCollection, EmbeddingSpec
from .hash_table import HashTableState, create_hash_table
from .meta import (EmbeddingVariableMeta, ModelMeta, ModelStatus,
                   ModelVariableMeta)
from .table import TableState, create_table, pull

__all__ = [
    "EmbeddingCollection", "EmbeddingSpec", "EmbeddingVariableMeta",
    "HashTableState", "ModelMeta", "ModelStatus", "ModelVariableMeta",
    "TableState", "create_hash_table", "create_table", "pull",
]
