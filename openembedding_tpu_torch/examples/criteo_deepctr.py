"""Criteo CTR training driver of the torch port (``examples/
criteo_deepctr.py``): the same flags with the same defaults, the same
printed lines, on one device.

    python -m openembedding_tpu_torch.examples.criteo_deepctr --model deepfm
    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --data train.tsv --format tsv
    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --save /tmp/ckpt --steps 100
    python -m openembedding_tpu_torch.examples.criteo_deepctr \\
        --load /tmp/ckpt --eval_steps 50

``--device`` is cuda unless ``cpu`` is named; with no GPU and no device
named it raises. The tables shard over the mesh JAX's driver builds from
``N`` devices, ``--data_parallel`` x ``N / data_parallel``, here a mesh
of one process whose ``N`` positions (``--devices``) all name the one
device (``parallel/mesh.py``); ``--plane`` takes every plane of JAX's
driver (``a2a``, ``psum``, ``a2a+cache`` with ``--cache_k``,
``a2a+grouped``, ``a2a+pipelined``, both, and the ``+bf16``/``+int8``
wires), and the EnvConfig ``exchange`` section's precisions reach every
spec as in JAX. The dense state is saved
as the ``TrainState``'s ``(params, opt_state)`` pair (``fit``'s
autosave form). Defaults train on synthetic zipfian Criteo-shaped data.
"""

import argparse
import itertools
import sys
import time

import numpy as np

PLANES = ["a2a", "psum", "a2a+cache", "a2a+grouped", "a2a+pipelined",
          "a2a+grouped+pipelined", "a2a+bf16", "a2a+int8",
          "a2a+grouped+bf16", "a2a+pipelined+bf16"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="deepfm",
                   choices=["lr", "wdl", "deepfm", "xdeepfm", "dcn"])
    p.add_argument("--data", default="", help="path to criteo csv/tsv; "
                   "empty = synthetic stream")
    p.add_argument("--format", default="csv",
                   choices=["csv", "tsv", "tfrecord"])
    p.add_argument("--readers", type=int, default=0, metavar="N",
                   help="stream --data through the parallel shard reader "
                        "pool (data/stream.py); tsv/tfrecord only. 0 = "
                        "the single-threaded readers")
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--eval_steps", type=int, default=0)
    p.add_argument("--embedding_dim", type=int, default=9)
    p.add_argument("--num_buckets", type=int, default=1 << 22,
                   help="hashed id space per the TSV path")
    p.add_argument("--optimizer", default="adagrad")
    p.add_argument("--learning_rate", type=float, default=0.01)
    p.add_argument("--dense_lr", type=float, default=1e-3)
    p.add_argument("--fused", action="store_true", default=True,
                   help="fuse the 26 features into one table (default)")
    p.add_argument("--no-fused", dest="fused", action="store_false")
    p.add_argument("--hash", action="store_true",
                   help="unbounded hash tables instead of bounded buckets")
    p.add_argument("--sparse_as_dense", type=int, default=0, metavar="N",
                   help="keep embeddings with vocab <= N as dense "
                        "parameters; needs --no-fused")
    p.add_argument("--plane", default="a2a", choices=PLANES,
                   help="sparse data plane: a2a (owner-routed exchange), "
                        "psum, a2a plus the hot-row replica cache, the "
                        "grouped exchange (one round a table group), the "
                        "pipelined schedule, or a compressed wire")
    p.add_argument("--cache_k", type=int, default=0,
                   help="a2a+cache replica rows per variable (0 = default)")
    p.add_argument("--hist_len", type=int, default=0, metavar="L",
                   help="add a variable-length behavior-history feature "
                        "(padded to L, mean-pooled). Synthetic data + "
                        "--no-fused only")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="mesh data-axis size")
    p.add_argument("--devices", type=int, default=0, metavar="N",
                   help="mesh positions, JAX's device count (default "
                        "--data_parallel): the mesh is data_parallel x "
                        "N / data_parallel, every position on --device")
    p.add_argument("--save", default="", help="checkpoint dir to write")
    p.add_argument("--save_compress", default="",
                   help="checkpoint block codec: '' | zlib | zstd-if-"
                        "installed")
    p.add_argument("--load", default="", help="checkpoint dir to read")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--retrace_budget", type=int, default=16,
                   help="step-program builds allowed after the two-step "
                        "warm-up; a trip prints a RuntimeWarning. -1 "
                        "disables the guard (analysis/retrace.py)")
    p.add_argument("--config", default="",
                   help="EnvConfig JSON file (OE_* env vars overlay it)")
    p.add_argument("--device", default=None,
                   help="cuda or cpu; with no GPU and no device named "
                        "it raises")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..utils import compress as compress_lib
    compress_lib.check(args.save_compress)  # fail now, not after training

    from .. import checkpoint as ckpt
    from ..analysis.retrace import RetraceGuard
    from ..data import criteo
    from ..embedding import EmbeddingCollection, EmbeddingSpec
    from ..fused import make_fused_specs
    from ..models import deepctr
    from ..optim import dense
    from ..optim.initializers import prng_key
    from ..parallel.mesh import create_mesh
    from ..training import Trainer
    from ..utils.device import resolve_device
    from ..utils.envconfig import EnvConfig
    from ..utils.observability import StreamingAUC, vtimer

    env_cfg = EnvConfig.load(path=args.config or None)
    reporter = env_cfg.apply_report()
    a2a_kw = env_cfg.a2a.spec_kwargs()
    exch_kw = env_cfg.exchange.spec_kwargs()
    if exch_kw != {"exchange_precision": "f32", "push_precision": "f32"}:
        a2a_kw = dict(a2a_kw, **exch_kw)

    device = resolve_device(args.device)
    n_dev = args.devices or args.data_parallel
    mesh = create_mesh(args.data_parallel, n_dev // args.data_parallel,
                       device=device)
    if mesh.size != n_dev:
        raise ValueError(f"{n_dev} devices not divisible by "
                         f"data={args.data_parallel}")
    print(f"mesh: {mesh.shape} on {device.type}")

    features = criteo.SPARSE_NAMES
    vocab = -1 if args.hash else args.num_buckets
    opt_config = {"category": args.optimizer,
                  "learning_rate": args.learning_rate}

    if args.fused:
        if args.sparse_as_dense:
            print("--sparse_as_dense needs --no-fused (a fused group is one "
                  "big table); ignoring")
        specs, mapper = make_fused_specs(
            features, vocab, args.embedding_dim, optimizer=opt_config,
            hash_capacity=1 << 22, plane=args.plane,
            cache_k=args.cache_k, **a2a_kw)
        dense_specs = ()
    else:
        specs = deepctr.make_feature_specs(
            features, vocab, args.embedding_dim, optimizer=opt_config,
            hash_capacity=1 << 22, plane=args.plane,
            cache_k=args.cache_k, **a2a_kw)
        mapper = None
        if args.sparse_as_dense:
            from ..hybrid import split_sparse_dense
            specs, dense_specs = split_sparse_dense(
                specs, args.sparse_as_dense, batch_size=args.batch_size)
            print(f"sparse_as_dense: {len(dense_specs)} dense-kept, "
                  f"{len(specs)} sharded")
        else:
            dense_specs = ()
    hist = args.hist_len and not args.fused and not args.data
    if args.hist_len and not hist:
        print("--hist_len needs --no-fused and synthetic data; ignoring")
    if hist:
        features = tuple(features) + ("hist",)
        specs = tuple(specs) + (
            EmbeddingSpec(name="hist", input_dim=vocab,
                          output_dim=args.embedding_dim,
                          optimizer=opt_config, pooling="mean",
                          hash_capacity=1 << 22, plane=args.plane,
                          cache_k=args.cache_k),
            EmbeddingSpec(name="hist:linear", input_dim=vocab, output_dim=1,
                          optimizer=opt_config, pooling="sum",
                          hash_capacity=1 << 22, plane=args.plane,
                          cache_k=args.cache_k))
    coll = EmbeddingCollection(specs, mesh)
    # torch modules take their input width up front (flax infers it)
    model = deepctr.build_model(
        args.model, features,
        **({} if args.model == "lr" else
           {"embedding_dim": args.embedding_dim}))
    trainer = Trainer(model, coll, dense.adam(args.dense_lr),
                      sparse_as_dense=dense_specs or None)

    streams = []   # open ShardStreams; closed after each consuming loop

    def close_streams():
        while streams:
            streams.pop().close()

    def batches(limit):
        if args.data:
            if args.readers > 0 and args.format in ("tsv", "tfrecord"):
                from ..data import stream as stream_lib
                reader = stream_lib.ShardStream(
                    args.data, batch_size=args.batch_size,
                    fmt=args.format, num_buckets=args.num_buckets,
                    readers=args.readers,
                    add_linear=mapper is None,
                    transform=(mapper.fuse_batch if mapper is not None
                               else None))
                streams.append(reader)
                if limit:
                    return itertools.islice(reader, limit)
                return reader
            if args.format == "tsv":
                reader = criteo.read_criteo_tsv(
                    args.data, args.batch_size,
                    num_buckets=args.num_buckets, max_batches=limit)
            elif args.format == "tfrecord":
                from ..data import tfrecord
                reader = tfrecord.read_criteo_tfrecord(
                    args.data, args.batch_size)
                if limit:
                    reader = itertools.islice(reader, limit)
            else:
                reader = criteo.read_criteo_csv(args.data, args.batch_size,
                                                max_batches=limit)
        else:
            reader = criteo.synthetic_criteo(args.batch_size,
                                             num_buckets=args.num_buckets,
                                             num_batches=limit)
        if mapper is not None:
            return (mapper.fuse_batch(b) for b in reader)
        reader = criteo.add_linear_columns(reader)
        if hist:
            from ..ragged import pad_id_for, pad_ragged
            pad = pad_id_for(coll.specs["hist"])  # EMPTY for --hash
            rng = np.random.RandomState(7)

            def with_hist(it):
                for b in it:
                    n = len(b["label"])
                    h = pad_ragged(
                        [rng.randint(0, max(args.num_buckets, 2),
                                     rng.randint(0, args.hist_len + 1))
                         for _ in range(n)], max_len=args.hist_len,
                        pad_id=pad)
                    b["sparse"] = {**b["sparse"], "hist": h,
                                   "hist:linear": h}
                    yield b
            reader = with_hist(reader)
        return reader

    it = iter(batches(args.steps + 1))
    first = next(it)
    state = trainer.init(prng_key(0), first)
    if args.load:
        import os
        if os.path.exists(f"{args.load}/{ckpt.DENSE_FILE}"):
            emb, (params, opt_state) = ckpt.load_checkpoint(
                args.load, coll,
                dense_state_template=(state.params, state.opt_state))
            state.emb, state.params, state.opt_state = emb, params, \
                opt_state
        else:
            print("warning: checkpoint has no dense state; MLP weights stay "
                  "freshly initialized")
            state.emb = ckpt.load_checkpoint(args.load, coll)
        print(f"loaded checkpoint from {args.load}")

    t0 = time.time()
    n = 0
    guard = None
    try:
        # chain, never list(it): the streaming path pulls lazily
        for i, b in enumerate(itertools.chain([first], it)):
            if i >= args.steps:
                break
            with vtimer("train_step"):
                state, m = trainer.train_step(state, b)
            n += 1
            if n == 2 and args.retrace_budget >= 0:
                # steady state starts after the two-step warm-up
                guard = RetraceGuard(budget=args.retrace_budget,
                                     name="criteo_deepctr loop",
                                     on_exceed="warn")
                guard.__enter__()
            if args.log_every and (i + 1) % args.log_every == 0:
                print(f"step {i+1}: loss={float(m['loss']):.5f}")
    finally:
        if guard is not None:
            guard.__exit__(None, None, None)
        close_streams()
    if guard is not None:
        print(f"retrace guard: {guard.compiles} post-warmup step-program "
              f"build(s) (budget {args.retrace_budget})")
    if n:
        float(m["loss"])     # wait for the last step
        dt = time.time() - t0
        print(f"trained {n} steps, {n * args.batch_size / dt:.0f} examples/s")

    if args.eval_steps:
        auc = StreamingAUC()
        try:
            for b in batches(args.eval_steps):
                scores = trainer.eval_step(state, b)
                auc.update(b["label"], scores.cpu().numpy())
        finally:
            close_streams()
        print(f"eval AUC over {args.eval_steps} batches: {auc.result():.4f}")

    if args.save:
        with vtimer("checkpoint_save"):
            ckpt.save_checkpoint(
                args.save, coll, state.emb,
                dense_state=(state.params, state.opt_state),
                model_sign=trainer.model_sign(state),
                compress=args.save_compress)
        print(f"saved checkpoint to {args.save}")
    if reporter is not None:
        reporter.report()
        reporter.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
