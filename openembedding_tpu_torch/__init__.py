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
can be kept as dense parameters (``hybrid.py``). Tables shard over a
``(data, model)`` mesh of one process (``parallel/``: the ``a2a`` and
``psum`` planes, compressed wires, the grouped exchange, the pipelined
schedule, the hot-row cache) or of several processes, one a card
(``distributed.py`` over ``torch.distributed``). Checkpoints chain
deltas of dirty chunks over a full base (``checkpoint_delta.py``), on
one shard or a one-process mesh; ``fit`` autosaves and resumes from
them, and the serving registry, whole or as a shard group's slice,
hot-swaps them in. Tables larger than the card keep their rows in a host
store behind a device hash cache (``offload.py``), one shard or sharded
over a one-process mesh, prepared ahead of each step; ``examples/``
holds the command-line drivers.
Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no GPU and no device named they raise.
The package imports torch and numpy, never jax or openembedding_tpu.
"""

__version__ = "0.1.0"

from .meta import (META_FORMAT_VERSION, UNBOUNDED_VOCAB,
                   EmbeddingVariableMeta, ModelMeta, ModelStatus,
                   ModelVariableMeta)
from .table import TableState, apply_gradients, create_table, pull
from .hash_table import HashTableState, create_hash_table
from .optim.optimizers import SparseOptimizer, make_optimizer
from .optim.initializers import Initializer, make_initializer
from .embedding import EmbeddingCollection, EmbeddingSpec
from .fused import FusedMapper, make_fused_specs
from .hybrid import (DenseEmbeddings, DenseFeatureSpec, HybridModel,
                     split_sparse_dense)
from .ragged import pad_id_for, pad_ragged, pool_rows
from .offload import HostOffloadedTable, ShardedOffloadedTable
from .dirty import DirtyTracker
from . import distributed
from .training import Trainer, TrainState, binary_logloss

__all__ = [
    "DenseEmbeddings", "DenseFeatureSpec", "DirtyTracker",
    "EmbeddingCollection", "EmbeddingSpec", "EmbeddingVariableMeta",
    "FusedMapper", "HashTableState", "HostOffloadedTable", "HybridModel",
    "Initializer", "META_FORMAT_VERSION", "ModelMeta", "ModelStatus",
    "ModelVariableMeta", "ShardedOffloadedTable", "SparseOptimizer",
    "TableState", "TrainState", "Trainer", "UNBOUNDED_VOCAB",
    "__version__", "apply_gradients", "binary_logloss",
    "create_hash_table", "create_table", "distributed",
    "make_fused_specs", "make_initializer", "make_optimizer",
    "pad_id_for", "pad_ragged", "pool_rows", "pull",
    "split_sparse_dense",
]
