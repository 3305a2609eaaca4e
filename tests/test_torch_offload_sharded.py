"""Torch port, ``ShardedOffloadedTable`` over a one-process mesh against
the JAX package's on JAX's own 2 x 4 mesh (``tests/test_offload.py``'s
``TestShardedOffload``, ``TestPipelinedOffload`` and the module-level
cases after them all run there).

The cases are ``tests/test_torch_offload.py``'s and
``tests/test_torch_offload_trainer.py``'s, collected here again with their
modules' ``GRID`` set to ``(2, 4)``: JAX's tables on ``create_mesh(2, 4)``,
the port's on ``parallel.mesh.create_mesh(2, 4, device="cpu")``, the
cache a ``ShardedHashState`` of 8 stacked shards. Tolerances are the
modules' own: eviction against a plain table at rtol 1e-5, atol 1e-6;
persist, kill, restore and continue at rtol 1e-6, atol 1e-7; cache keys
slot for slot against JAX's.
"""

import pytest

import test_torch_offload as off
import test_torch_offload_trainer as offt
from openembedding_tpu_torch import offload as toff
from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.meta import EmbeddingVariableMeta
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.parallel.mesh import Mesh, create_mesh

from test_torch_offload import (  # noqa: F401 — collected here on 2 x 4
    test_check_overflow_prefers_live_cache_counter,
    test_eviction_parity_with_plain_table,
    test_gather_retry_when_evicted_mid_gather,
    test_overflow_check_every_n_batches, test_persist_compress_chain,
    test_persist_kill_restore_continue,
    test_restore_in_place_keeps_the_cache_tensors,
    test_stale_prepare_recomputed_at_apply)
from test_torch_offload_trainer import (  # noqa: F401
    test_hand_driven_prefetch_matches_fit,
    test_packed_insert_matches_unpacked_fallback,
    test_pipeline_parity_under_timing_fuzz,
    test_pipeline_survives_eviction_batches,
    test_pipelined_fit_matches_serial_steps,
    test_steady_state_makes_no_per_step_device_reads,
    test_trainer_integration)


@pytest.fixture(autouse=True)
def _grid_2x4(monkeypatch):
    monkeypatch.setattr(off, "GRID", (2, 4))
    monkeypatch.setattr(offt, "GRID", (2, 4))


def test_cache_is_sharded_like_the_collection():
    """On a 2 x 4 mesh the cache is 8 stacked shards under the
    collection's own spec for the table's ``embedding_spec()``; a mesh of
    one position keeps the one-device cache; a mesh across processes
    raises, giving the reference's reason; a ``Trainer`` whose collection
    shards the variable otherwise than the table's cache raises."""
    meta = EmbeddingVariableMeta(embedding_dim=4, vocabulary_size=1024)
    mesh = create_mesh(2, 4, device="cpu")
    t = toff.ShardedOffloadedTable("off", meta, off.SGD, vocab=1024,
                                   cache_capacity=256, mesh=mesh)
    coll = EmbeddingCollection((t.embedding_spec(),), mesh)
    assert t.sharded and coll.sharding_spec("off") == t.spec
    cache = t.create_cache()
    assert cache.num_shards == 8 and cache.keys.shape[0] == 8 * \
        t.spec.capacity_per_shard
    assert cache.init_rng.shape == (2,)        # held on the device
    one = toff.ShardedOffloadedTable("off", meta, off.SGD, vocab=1024,
                                     cache_capacity=256,
                                     mesh=create_mesh(1, 1, device="cpu"))
    assert not one.sharded and one.create_cache().keys.shape[0] == 256
    spanning = Mesh(["cpu"] * 4, 2, 2, process_count=2, process_index=0)
    with pytest.raises(NotImplementedError,
                       match="reference cannot run an offloaded table"):
        toff.ShardedOffloadedTable("off", meta, off.SGD, vocab=1024,
                                   cache_capacity=256, mesh=spanning)
    with pytest.raises(ValueError, match="shard"):
        tr.Trainer(tm.LogisticRegression(feature_names=("off",)),
                   EmbeddingCollection((t.embedding_spec(),),
                                       create_mesh(1, 2, device="cpu")),
                   dense.sgd(0.1), offload={"off": t})
    # the imported cases run on the 2 x 4 mesh
    assert "mesh" in off._port_where() and "mesh" in offt._port_where()
    assert off._mesh().devices.shape == (2, 4)
