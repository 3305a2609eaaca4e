"""Training across processes with the torch port (``examples/
multihost_train.py``, the reference's MPI/network examples): each
process joins the cluster, feeds its own batch shard, and the same step
runs everywhere over a ``(data, model)`` mesh that spans the processes.

One command a process (``--master`` is rank 0's ``host:port``)::

    python -m openembedding_tpu_torch.examples.multihost_train \\
        --master 127.0.0.1:29511 --num_workers 2 --worker_rank 0 &
    python -m openembedding_tpu_torch.examples.multihost_train \\
        --master 127.0.0.1:29511 --num_workers 2 --worker_rank 1

Without the flags a launcher's environment supplies them (``MASTER_ADDR``
and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets
them). ``--device``: cuda unless ``cpu`` is named (with no GPU and no
device named it raises). ``--backend``: ``gloo`` on the CPU and for
ranks that share a card, ``nccl`` where each rank has its own (the
default on a card).
"""

import argparse
import os
import sys


def _from_env(value, name: str, cast=str):
    if value is not None:
        return value
    if name not in os.environ:
        raise ValueError(f"pass the flag or set {name}: the cluster has no "
                         "other way to learn it")
    return cast(os.environ[name])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--master", default=None,
                   help="rank 0's host:port (None: MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num_workers", type=int, default=None)
    p.add_argument("--worker_rank", type=int, default=None)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch_per_host", type=int, default=256)
    p.add_argument("--data_axis", type=int, default=0,
                   help="0 = one data row per process")
    p.add_argument("--device", default=None,
                   help="cuda or cpu; with no GPU and no device named "
                        "it raises")
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="None: gloo on the CPU, nccl on a card")
    args = p.parse_args(argv)

    import numpy as np

    from .. import distributed
    from ..embedding import EmbeddingCollection
    from ..fused import make_fused_specs
    from ..models import deepctr
    from ..optim import dense
    from ..optim.initializers import prng_key
    from ..training import Trainer

    master = args.master
    if master is None:
        master = (f"{_from_env(None, 'MASTER_ADDR')}:"
                  f"{_from_env(None, 'MASTER_PORT')}")
    distributed.initialize(
        master, _from_env(args.num_workers, "WORLD_SIZE", int),
        _from_env(args.worker_rank, "RANK", int), backend=args.backend,
        device=args.device)
    try:
        rank = distributed.worker_rank()
        data_axis = args.data_axis or distributed.num_workers()
        mesh = distributed.create_global_mesh(data=data_axis)
        print(f"worker {rank}/{distributed.num_workers()}: mesh "
              f"{mesh.shape} on {mesh.device} ({distributed.backend()})",
              flush=True)
        features = tuple(f"c{i}" for i in range(8))
        specs, mapper = make_fused_specs(features, 1 << 16, 8)
        coll = EmbeddingCollection(specs, mesh)
        trainer = Trainer(deepctr.build_model("deepfm", features,
                                              embedding_dim=8), coll,
                          dense.adagrad(0.05))
        rng = np.random.RandomState(rank)  # each process reads its shard

        def host_batch():
            b = args.batch_per_host
            sparse = {f: rng.randint(0, 1 << 16, b).astype(np.int32)
                      for f in features}
            return mapper.fuse_batch({
                "label": (rng.rand(b) > 0.5).astype(np.float32),
                "dense": rng.randn(b, 13).astype(np.float32),
                "sparse": sparse})

        def global_batch():
            return distributed.local_batch_to_global(host_batch(), mesh)

        state = trainer.init(prng_key(0), global_batch())
        for i in range(args.steps):
            state, m = trainer.train_step(state, global_batch())
            if rank == 0 and (i + 1) % 5 == 0:
                print(f"step {i + 1}: loss={float(m['loss']):.5f}",
                      flush=True)
        distributed.barrier("done")
        if rank == 0:
            print("multihost training done", flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
