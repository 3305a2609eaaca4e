"""openembedding_tpu_torch: the PyTorch + CUDA port of openembedding_tpu.

A second package beside the JAX one, which stays the reference. The port
serves: checkpoints in the JAX package's on-disk layout load onto an
NVIDIA GPU and answer REST lookups. Array tables pull through the
hand-written CUDA row-gather kernel (``ops/gather.py``,
``csrc/gather_rows.cu``), hash tables through the hand-written CUDA
probe-gather kernel (``ops/probe_gather.py``, ``csrc/probe_gather.cu``).
And it trains models over array and hash tables (``training.Trainer``):
each step pulls through the row-gather kernel (array tables) or the
probe-gather kernel, with the init-rows kernel (``ops/init_rows.py``,
``csrc/init_rows.cu``) drawing missing keys' rows (hash tables), and
pushes the row gradients with static-shape PyTorch ops; sequence
features pool padded id matrices (``ragged.py``) and small vocabularies
can be kept as dense parameters (``hybrid.py``). Checkpoints chain deltas
of dirty chunks over a full base (``checkpoint_delta.py``), ``fit``
autosaves and resumes from them, and the serving registry hot-swaps
them in. Tables larger than the card keep their rows in a host store
behind a device hash cache (``offload.py``), prepared ahead of each
step; ``examples/`` holds the command-line drivers.
Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no device named they raise.
The package imports torch and numpy, never jax or openembedding_tpu.
"""

from .embedding import EmbeddingCollection, EmbeddingSpec
from .hash_table import HashTableState, create_hash_table
from .hybrid import (DenseEmbeddings, DenseFeatureSpec, HybridModel,
                     split_sparse_dense)
from .meta import (EmbeddingVariableMeta, ModelMeta, ModelStatus,
                   ModelVariableMeta)
from .ragged import pad_id_for, pad_ragged, pool_rows
from .table import TableState, create_table, pull
from .training import Trainer, TrainState

__all__ = [
    "DenseEmbeddings", "DenseFeatureSpec", "EmbeddingCollection",
    "EmbeddingSpec", "EmbeddingVariableMeta", "HashTableState",
    "HybridModel", "ModelMeta", "ModelStatus", "ModelVariableMeta",
    "TableState", "TrainState", "Trainer", "create_hash_table",
    "create_table", "pad_id_for", "pad_ragged", "pool_rows", "pull",
    "split_sparse_dense",
]
