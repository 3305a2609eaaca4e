"""End-to-end serving demo of the torch port (``examples/
serving_cluster.py``): train, checkpoint, replica daemons, lookups.

    python -m openembedding_tpu_torch.examples.serving_cluster \\
        --replicas 2 --steps 20
    python -m openembedding_tpu_torch.examples.serving_cluster \\
        --shards 2 --replicas 2          # a 2 x 2 grid of processes

trains a small DeepFM on ``--device`` (cuda unless ``cpu`` is named; with
no GPU and no device named it raises), saves a version-stamped checkpoint,
boots N replica daemons of ``serving/ha.py`` on the same device (the
first loads the model, the rest restore it from a living peer), issues
lookups through the failover router and prints the cluster's liveness
and /metrics endpoints. ``--shards G`` serves from shard groups, for
models larger than one process: G groups of ``--replicas`` processes,
group ``k`` loading only the ids ≡ k (mod G), and a
``ShardedRoutingClient`` sends each group its ids and merges the rows.
"""

import argparse
import socket
import sys
import tempfile
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--shards", type=int, default=1,
                   help=">1: shard-group serving (each process holds the "
                        "ids of its group)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lookups", type=int, default=5)
    p.add_argument("--compress", default="",
                   help="binary data-plane codec ('' | zlib)")
    p.add_argument("--device", default=None,
                   help="cuda or cpu; with no GPU and no device named "
                        "it raises")
    args = p.parse_args(argv)
    from ..utils import compress as compress_lib
    compress_lib.check(args.compress)   # fail at parse time
    if args.shards < 1 or args.replicas < 1:
        raise ValueError("--shards and --replicas must be at least 1")

    import numpy as np

    from .. import checkpoint as ckpt
    from ..embedding import EmbeddingCollection
    from ..fused import make_fused_specs
    from ..models import deepctr
    from ..optim import dense
    from ..optim.initializers import prng_key
    from ..serving import ha
    from ..training import Trainer
    from ..utils.device import resolve_device

    # --- train + save ------------------------------------------------------
    device = resolve_device(args.device)
    features = tuple(f"c{i}" for i in range(8))
    specs, mapper = make_fused_specs(features, 4096, 8)
    coll = EmbeddingCollection(specs, device=device)
    trainer = Trainer(deepctr.build_model("deepfm", features,
                                          embedding_dim=8), coll,
                      dense.adagrad(0.05))
    rng = np.random.RandomState(0)

    def batch():
        sparse = {f: rng.randint(0, 4096, 256).astype(np.int32)
                  for f in features}
        return mapper.fuse_batch({
            "label": (rng.rand(256) > 0.5).astype(np.float32),
            "dense": rng.randn(256, 13).astype(np.float32),
            "sparse": sparse})

    state = trainer.init(prng_key(0), batch())
    state, _ = trainer.fit(state, (batch() for _ in range(args.steps)))
    sign = trainer.model_sign(state)
    model_dir = tempfile.mkdtemp(prefix="oe_serving_demo_")
    ckpt.save_checkpoint(model_dir, coll, state.emb, model_sign=sign)
    print(f"saved {sign} -> {model_dir}")

    # --- replica cluster ---------------------------------------------------
    procs = []
    try:
        if args.shards > 1:
            # shard groups x replicas: every process loads its slice
            eps = [[f"127.0.0.1:{_free_port()}"
                    for _ in range(args.replicas)]
                   for _ in range(args.shards)]
            for k, row in enumerate(eps):
                for ep in row:
                    procs.append(ha.spawn_replica(
                        int(ep.rsplit(":", 1)[1]),
                        load=[f"{sign}={model_dir}"], device=device.type,
                        compress=args.compress, shard_index=k,
                        shard_count=args.shards))
            flat_eps = [ep for row in eps for ep in row]
            for ep in flat_eps:
                assert ha.wait_ready(ep, sign=sign, timeout=300.0), \
                    f"replica {ep} failed"
            print(f"shard-group cluster up: {eps}")
            router = ha.ShardedRoutingClient(eps, compress=args.compress)
        else:
            ports = [_free_port() for _ in range(args.replicas)]
            flat_eps = eps = [f"127.0.0.1:{pt}" for pt in ports]
            procs.append(ha.spawn_replica(
                ports[0], load=[f"{sign}={model_dir}"], device=device.type,
                compress=args.compress))
            assert ha.wait_ready(eps[0], sign=sign, timeout=300.0), \
                "first replica failed"
            for pt in ports[1:]:
                procs.append(ha.spawn_replica(pt, peers=[eps[0]],
                                              device=device.type,
                                              compress=args.compress))
            for ep in eps[1:]:
                assert ha.wait_ready(ep, sign=sign, timeout=300.0), \
                    f"replica {ep} failed"
            print(f"cluster up: {eps}")
            router = ha.RoutingClient(eps, compress=args.compress)
        for n in router.nodes():
            print(f"  node {n['endpoint']}: alive={n['alive']} "
                  f"models={n['models']}")
        ids = np.arange(8, dtype=np.int64)
        for _ in range(args.lookups):
            rows = router.lookup(sign, "fields", ids)
            print(f"lookup fields[0:8] -> shape {rows.shape}, "
                  f"|row0|={np.abs(rows[0]).sum():.4f}")
            time.sleep(0.2)
        print(f"metrics: curl http://{flat_eps[0]}/metrics")
        print(f"cluster: curl http://"
              f"{flat_eps[1] if len(flat_eps) > 1 else flat_eps[0]}"
              "/cluster")
    finally:
        for pr in procs:
            pr.kill()
            pr.wait()
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
