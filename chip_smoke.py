"""Smoke run of the torch port on one NVIDIA GPU: every kernel built from
``openembedding_tpu_torch/csrc``, held against its plain PyTorch version,
then the serving and training paths driven end to end at full width.

    python3 chip_smoke.py

(``python3 chip_smoke.py --ki`` runs KI's per-key cases alone, to compare
two versions of the kernel in turns within one call; see ``ki_only``.
``python3 chip_smoke.py --k3`` holds K3 against its plain version at the
benchmark's hash cell's shape and times it; see ``phase_find_kernels``.
``python3 chip_smoke.py --hybrid`` runs phase 11 alone, ``--delta``
phase 12, ``--ingest`` phase 13, ``--serving`` phase 14, ``--offload``
phase 15, ``--drivers`` phase 16, ``--sharded`` phase 17, ``--planes``
phase 18, ``--sharded --planes`` both, phase 18 on phase 17's ``a2a``
run, ``--multiprocess`` phase 19, ``--sharded-delta`` phase 20. None of
them prints a result line.)

Phase 19, after phase 18: ``deepfm_dim9`` (``a2a``, ``psum``,
``a2a+pipelined``), ``deepfm_dim9_hash`` (``a2a``, ``a2a+cache``),
``deepfm_dim9_zipf`` (``a2a+cache``, a refresh inside the run) and the
52 per-feature variables (``a2a+grouped``, ``a2a+grouped+pipelined``)
trained by two processes (``distributed.py`` over gloo, both on the one
card, spawned as fresh interpreters: ``--mp-worker``) on a 2 x 2 mesh
that spans them, held against one process's mesh on the same batches
through their part dumps (a cached run's replica keys and a hash run's
table keys bit for bit too), each plane run's examples/s, collectives,
busy share, hit rate and launches a step read; the ``a2a`` dump served
by a 2 x 2 grid of shard groups and replicas behind a
``ShardedRoutingClient``, a replica of each group killed under lookups;
the multihost driver; ``nccl`` refused for two ranks on one card
(``--mp-nccl``).

Phase 20, after phase 19 (``phase_sharded_delta``): ``ckpt_delta_ab`` on
a 1 x 4 mesh; ``deepfm_dim9`` on 2 x 2 ``a2a`` fitting with delta
autosaves, killed, resumed (appending to its chain) and published into a
whole registry and a shard group bit for bit, then ``deepfm_dim9_hash``'s
base and delta into the same three; ``offload_ab_k4`` on 1 x 4 against
one shard, persisted and restored, then with caches small enough to
evict.

Phases, in order; any failure raises and the run exits nonzero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every ``csrc/*.cu`` (one nvcc each, in parallel);
3. kernel against plain: ``gather_rows`` vs ``gather_rows_reference`` on
   the card, exact equality (it is a copy), with CUDA-event medians of the
   kernel, the plain version and ``torch.index_select`` (the yardstick,
   never used by the port) beside the least time the card could take
   (bytes over 3.35 TB/s, table rows counted in 32-byte sectors), at the
   main-path shapes and at the kernel's edges (n = 1, 2, 3 mod 4, n =
   1,000,003, dim 300, ids that are not 16-byte aligned);
4. serving path: the ``deepfm_dim9`` fused Criteo tables (26 x 2^20 rows,
   dim 9 plus the dim-1 ``:linear`` twin, adagrad slots) are initialized
   from a seed, saved as a checkpoint, loaded through ``POST /models`` of a
   ``ControllerServer`` and queried with ``[4096, 26]`` ``lookup_bin``
   requests and one JSON ``lookup``; every response must equal the host
   copy of the weights exactly, and the gather kernel's launch count must
   show that the lookups went through it;
5. hash tables and K2: the ``deepfm_dim9_hash`` tables (the same 26
   features fused into one wide-key hash table of 2^23 slots, dim 9, plus
   its dim-1 ``:linear`` twin, adagrad slots) are filled through
   ``insert_rows`` to load 0.5 with seeded rows: every distinct key of the
   served batches plus filler keys. ``probe_gather`` is held against
   ``probe_gather_reference`` on the card, exact in rows and hit flags, at
   the main-path shape and on the cases ``phase_probe_kernels`` lists
   (the design's edges among them: matches at window slots 31 to 33, keys
   overflowed into a window's second bucket, misses in windows with no
   EMPTY slot, the span's last window, n = 300,001),
   timed beside the plain version, ``torch.index_select`` over the
   already-resolved slots ("gather part only": not the same function)
   and the bound (bytes over 3.35 TB/s);
6. hash serving path: the tables are saved, loaded through ``POST
   /models`` and queried with ``[4096, 26, 2]`` pair ``lookup_bin``
   requests, narrow int64 ids, misses and EMPTY pairs, and one JSON
   ``lookup``; every response must equal the host's key -> row
   dictionary exactly, and the probe kernel's launch count must cover
   every lookup;
   then K3 against its plain version (``phase_find_check``): a table of
   the benchmark's hash cell's 2^26 wide slots filled with its 33.8 M
   keys through ``find_or_insert`` and through
   ``find_or_insert_reference``, the keys arrays equal word for word, and
   a push's find at the cell's shape (106,496 entries, 16,100 stored
   keys, then a tenth of them new), slot for slot, timed beside the plain
   version and the bound (``phase_find_kernels``); K3's launches on the
   main path are summed phase by phase (``K3_LAUNCHES``, the phase 14 and
   19 children's besides), and phase 8 holds them to its steps;
7. training: the ``deepfm_dim9`` trainer at full width (the fused tables
   with sparse Adagrad, ``DeepFM`` 247 -> 256 -> 128 -> 1, dense
   optax-form Adagrad, batches of 4096 from ``synthetic_criteo``) built
   on the card by ``Trainer.init(prng_key(SEED), batch)``, KI's array mode
   launched once for each table and dense kernel; with nothing copied,
   its dense parameters and the first, a middle and the last 4096 rows of
   each table equal the CPU's draws from the same key (uniform and
   constant exactly, normal ones within ``2^-21 * (|want| + stddev)``),
   and its first step's loss the CPU's from those values within 1e-6;
   its initial state copied to a trainer on
   the CPU (the plain K1); 4 captured steps on the card (``train_step``:
   the first builds the step program, a CUDA graph, its warm-up being the
   first step; the others replay it) and 4 on the CPU must agree (losses
   rtol 1e-4; touched rows, slots, dense parameters and accumulators atol
   1e-5 + rtol 1e-4; a seeded sample of 2^20 untouched ids bit-identical
   to the initial state); the program's build seconds and the memory its
   capture reserved; 4 captured steps equal 4 eager ones
   (``train_step_eager``) from one state bit for bit
   (``captured_against_eager``: under deterministic algorithms if two
   eager runs differ); K1 must launch exactly twice a card step, replays
   counted; then the throughput of the captured and the eager step (5
   timed blocks of 20 steps of each, in turns; the median block), each
   stage timed alone (pull, dense, push), a ``torch.profiler`` trace of
   20 replayed steps (device busy share, operations and graph launches a
   step, top device operations, longest idle gaps, idle time by what the
   host was doing, and K1's launches a step in the trace equal to its
   counter's), the trained tables saved, loaded through
   ``POST /models`` and served back exactly, and KI's array mode held
   against its plain version (``phase_ki_flat``: the whole ``fields``
   table in one launch, checked in three row ranges, those ranges drawn
   from their offsets, ``fields:linear``, a ``[4096, 9]`` table, a
   bfloat16 one and the first dense kernel), timed beside its bound;
8. hash training: the ``deepfm_dim9_hash`` trainer at full width (the
   wide-key hash tables of phase 5, empty, with sparse Adagrad, and the
   same dense half, batches of 4096 from ``synthetic_criteo(4096,
   num_buckets=2^22)``) built on the card by ``Trainer.init(prng_key(
   SEED), batch)``; with nothing copied, its dense parameters, hash init
   keys and empty keys arrays equal a CPU trainer's ``init`` from the same
   key, and the two first steps' losses agree within 1e-6; its initial
   state copied to a CPU trainer; 4 captured steps on the card and 4 on
   the CPU must agree (the keys arrays and
   insert-failure counts bit-identical; losses rtol 1e-4; every stored
   key's row and slots atol 1e-5 + rtol 1e-4, and its change from its
   init row within ``change_ratio``'s limit, the check shown to flag
   simulated push faults; free slots still zero); 4 inserting captured
   steps equal 4 eager ones bit for bit, keys arrays and failure counts
   too; 3 eager steps that insert
   keys under ``torch.cuda.set_sync_debug_mode("error")``; the init-rows
   kernel KI held against its plain version on the main path's pulls and
   edges (exact for uniform and constant draws, normal ones within
   ``2^-21 * (|want| + stddev)``), timed beside its bound (the larger of
   bytes over 3.35 TB/s and its threefry and draw operations over the
   instruction rate, 128 lane operations a clock an SM); K2 launched exactly
   2 and KI 4 times a step; the throughput of the captured and the eager
   step on ``bench.py``'s 8 cycled batches and on batches the tables have
   not seen (the open key space, with the keys inserted a step), the
   stages alone on unseen batches (pull, dense, push, and the push's
   dedup, insert and update), a ``torch.profiler`` trace of 20 replayed
   unseen-batch steps (K2's and KI's launches a step in it equal to their
   counters'), keys inserted and the load factor, and the trained tables
   served back exactly;
10. xdeepfm training (run after phase 8, printed before phase 9's line):
   the ``xdeepfm_dim16`` trainer of ``bench.py`` at full width (the 26
   features fused into ``fields`` ``[27,262,976, 16]`` and
   ``fields:linear`` ``[27,262,976, 1]`` f32 with Adagrad slots, ~3.7 GB;
   ``XDeepFM`` with CIN (128, 128) and DNN (256, 128) over 13 dense
   features, dense Adagrad; batches of 2048 from ``synthetic_criteo(2048,
   num_buckets=2^20)``, 8 cycled), float32 products without TF32, the
   earlier phases' tables freed: phase 7's checks (init against the CPU's
   draws with nothing copied, 4 captured card steps against 4 CPU steps
   with the change check, captured against eager, K1 twice a step,
   captured and eager throughput, a trace); then ``DCN`` (3 cross layers,
   DNN (256, 128)) over the same collection from a fresh init, 4 captured
   card steps against 4 CPU steps;
11. hybrid training (run after phase 10, printed before phase 9's line):
   ``criteo_hist_hybrid`` at full width (``build_hybrid_trainer``: the
   example's ``--no-fused --hist_len 32 --sparse_as_dense 64`` path with
   the Kaggle Criteo vocabularies, 28 dense-kept tables, 24 array tables
   and the pooled history in the collection, dense Adam) built on the card
   by ``Trainer(sparse_as_dense=).init(prng_key(SEED), batch)`` and held
   against the CPU's draws with nothing copied; phase 7's checks table by
   table (4 captured card steps against 4 CPU steps, the dense-kept tables
   and Adam's moments among them), captured against eager, K1 26 times a
   replayed step (24 tables and the 2 pooled histories) from the counters
   and the trace, the captured eval against the eager eval bit for bit
   and against the CPU's scores, captured and eager throughput of steps
   and evals, the stages alone, a trace, pooled and flat serving exactly;
   then the history as wide hash variables (the hash twin): 4 captured card
   steps against 4 CPU steps, keys arrays bit-identical, no EMPTY key
   inserted;
12. delta checkpoints, elastic fit and hot-swap (run after phase 11,
   printed before phase 9's line): ``ckpt_delta_ab`` (bench.py:1694: a
   ``[2^22, 9]`` Adagrad table saved full, 5 % of its rows pushed and 3
   delta saves of their chunks, the chain replayed exactly); then
   ``deepfm_dim9`` and ``deepfm_dim9_hash`` at full width with dirty
   tracking armed: the dirty chunk share after 1, 4 and 8 steps,
   ``fit(autosave_every=4, retrace_budget=0)`` over 12 captured steps,
   a fit killed after 8 and resumed by a fresh trainer bit for bit (one
   program build each; hash keys arrays too, no insert failure), the
   base served after step 4 and each published delta hot-swapped
   through ``POST /models/<sign>/delta`` with lookups equal to the
   trainer's rows at that step (K1 or K2 once a lookup, from the
   counters and a trace; KI never in an apply), a re-sent delta a
   no-op, a skipped one 409, and the captured step with tracking armed
   and off (``phase_delta``);
13. ingest and checkpoint layouts (run after phase 12, printed before
   phase 9's line): 8 TSV shards of 65,536 rows written by
   ``write_synthetic_shards`` into a temporary directory, the hash
   twin's shards meanwhile by two child processes joined before any
   fit; under deterministic algorithms ``deepfm_dim9`` at full width
   fits 64 steps from a ``ShardStream`` over the first 4 shards (fused on the readers,
   the default 2 readers) and 64 steps over the same batches read by a
   second stream into memory: losses and every tensor bit-equal, the
   two reads identical, one program build each; a stream with 4 mangled
   lines a shard counts exactly 8 bad rows; a fit with autosaves every 16
   steps is killed by the chaos plan before step 41 and a fresh trainer
   resumes it on a fresh stream through ``skip_batches(32)``, bit-equal
   in its last 32 losses and final state; then 64 streamed steps over
   all 8 shards and 64 in memory outside deterministic mode and outside
   the profiler; each with examples/s, the stall series and its
   p50/p95/max, reader rows/s and the ``ingest.*`` span totals, the
   deterministic pair also with the device's busy share (a
   ``torch.profiler`` trace of the card's activity); the
   ``deepfm_dim9_hash`` twin fits 16 steps from 2 TFRecord shards of
   32,768 rows (K2 and KI), its labels and dense features equal to a
   TSV stream of the same seed; the streamed state saved local, zlib-compressed and (the hash twin) into ``memory://``,
   zlib and a legacy npz repack, each reloaded bit for bit (hash tables
   key by key), served through ``POST /models`` and ``lookup_bin`` with
   K1 or K2 once a lookup, hash -> array and array -> hash conversion
   rows per key, and the native reader's rows equal to the registry's
   (``phase_ingest``; one ``{"ingest": ...}`` and one ``{"layouts":
   ...}`` line);
14. micro-batched, captured and replicated serving (run after phase
   13, printed before phase 9's line; ``--serving`` alone): the
   ``deepfm_dim9`` tables (no slots) saved as a delta chain (base, then
   4096 changed rows as delta 1) and the ``deepfm_dim9_hash`` tables
   of phase 5; in this process a batched ``ModelRegistry`` (rows 1024,
   200 µs) on each: ``warm_batch_programs`` (count, seconds, graphs,
   pool bytes), mixed concurrent requests of 1–1024 int32, int64 (and,
   hashed, pair) ids whose batched rows equal the unbatched ones and the
   host's bit for bit, every bucket's captured pull equal to the eager
   one and timed against it (CUDA events, median of 20), the delta
   hot-swapped and the buckets captured anew equal to the new version's
   rows; then three batched replica daemons, one unbatched and one
   batched hash replica (``ha.spawn_replica``, each its own process and
   CUDA context), their rows checked; open-loop storms through
   ``RoutingClient`` (``serving/load.py``: Poisson arrivals, 16 uniform
   ids a ``lookup_bin``) from 200 QPS, x1.5 a step, 10 s a rate (at
   least 2,000 arrivals above the first), until
   ``find_knee`` reports saturation, batched then unbatched, with p50,
   p95, p99, achieved QPS, rejections, the senders' lateness and the
   batchers' flush sizes from ``/metrics``; a 10 s storm at half the
   batched knee with one replica SIGKILLed 3 s in (no read may fail);
   the killed replica respawned with ``--peers`` while the dump is
   unreadable, its rows restored from a peer equal to a survivor's; one
   storm of the hash replica. K1 and K2 counted in this process and in
   each replica (reported at its SIGTERM shutdown);
15. host offload (run after phase 14; ``--offload`` alone):
   ``offload_ab_k4`` (bench.py:1668-1670) at full width, run as
   ``run_offload`` runs it: ``uid`` and ``uid:linear`` in 5 x 10^7-row
   host stores behind 2^22-row device caches, ``ctx`` array tables,
   ``DeepFM``, batches of 4096 zipf uids. Under deterministic algorithms
   a card trainer driven serially (its store a disk memmap), one
   prefetched at K=4 and a CPU trainer from the card state's copy take 4
   steps: K=4 equal to serial bit for bit, the card within the CPU's
   (losses rtol 1e-4, cache keys bit-identical, host stores atol 1e-5 +
   rtol 1e-4 on the touched rows, a sample of the others bit for bit);
   the same ids in in-HBM array tables bit for bit; a 2^16-row cache
   evicting at least twice in 48 steps, against the CPU, with no
   recapture. Then serial, K=1 and K=4 on the same batches (examples/s,
   step and prepare ms, hit rate), 2 K1 + 2 K2 + 4 KI launches a step;
   4 K=4 steps under ``set_sync_debug_mode("error")``; a trace of 10 K=4
   steps (busy share, idle gaps by host activity, the launches again,
   packed-insert H2D GB/s); the writeback's D2H GB/s; ``uid:linear``
   persisted (base, increment) and restored bit for bit; KI against its
   plain version with the device-held key; ``offload_bigvocab`` (4 x
   10^8 rows) when the disk holds its store;
16. the drivers (``--drivers`` alone): ``python -m
   openembedding_tpu_torch.examples.criteo_deepctr`` in process with
   ``criteo_hist_hybrid``'s flags and ``--save``, its checkpoint served
   through ``POST /models`` with every variable's rows equal to the
   saved state; the fused default with ``--save``, then ``--load
   --eval_steps 2``; ``export_dense`` of the ``deepfm_dim9`` tables
   against their host copy, timed;
17. sharded tables on a mesh of one process (``--sharded`` alone):
   ``deepfm_dim9`` on a 2 x 2 ``a2a`` and a 2 x 2 ``psum`` mesh,
   ``deepfm_dim9_hash`` on 2 x 2 ``a2a`` and its int64-key twin on 1 x
   4, at full width (``SHARD_RUNS``); for each (``sharded_run``), the
   initial state against the CPU's draws with nothing copied (each
   shard from ``fold_in(key, shard)``), 2 captured card steps against a
   CPU trainer on a CPU mesh of the same shape, a step on a batch whose
   keys are all congruent modulo the shard count (replayed against the
   CPU, its residue counted), captured against eager bit for bit,
   examples/s captured and eager with no program built, K1, K2 and KI
   launches a step, a trace, the plane's readings (wire bytes,
   exchanges a step, dense beside pull and push ms), the exchange's
   slice, buckets and static rounds with the extra rounds' cost, and
   the save served on 1 x 1 through the registry exactly; then the
   plane parity (SGD, constant init: 2 x 2 ``a2a`` and ``psum`` against
   1 x 1, rtol 1e-5) and K2's int64 mode and KI's int64 keys against
   their plain versions (``phase_sharded``);
18. the other exchange planes on 2 x 2 (``--planes`` alone): nine runs
   at full width (``PLANE_RUNS``: ``deepfm_dim9`` on ``+bf16``,
   ``+int8``, ``+pipelined`` and, as ``deepfm_dim9_zipf``, ``+cache``,
   beside phase 17's ``a2a`` run; the 52-variable
   ``deepfm_dim9_per_feature`` on ``a2a``, ``+grouped``,
   ``+grouped+pipelined``; ``deepfm_dim9_hash`` on ``+int8`` and
   ``+cache``), each through ``sharded_run``: the initial state against
   the CPU's draws with nothing copied, 2 captured card steps against a
   CPU trainer on a CPU mesh with the derived state after each step (an
   int8 residual equal to the CPU's or one unit from it, in units of
   the CPU step's per-row scale, its flips counted; a replica exactly),
   captured against eager bit for bit under deterministic algorithms,
   examples/s captured and eager with each step's lookahead and 0
   recaptures, launches a step, a trace, and the plane's readings (wire
   bytes, exchanges a step, ``quant_*``, hit rate, refresh ms, the
   sketch's host ms, dense beside pull and push ms); then each plane's
   parity against its ``a2a`` run on the same batches (``phase_planes``);
9. the card's name and power limit again, then the kernel list as one
   JSON line;
12. last line: ``{"ok": true, "device": {...}}``.

It imports torch, numpy and the port, never jax or openembedding_tpu.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
SECTOR = 32
REPS = 20
SPIN_CYCLES = 2_000_000       # ~1 ms: covers the host's dispatch of a call
FLUSH_BYTES = 64 << 20        # above the 50 MB L2
VOCAB_PER_FEATURE = 1 << 20
BATCH = 4096
SEED = 0
BIN_BATCHES = 12              # x 2 variables = 24 lookup_bin requests
EMPTY32 = -2**31              # the hash tables' EMPTY key word
HASH_CAPACITY = 1 << 23       # deepfm_dim9_hash (bench.py): slots per table
HASH_VOCAB = 1 << 22          # ... and buckets per feature
HASH_BIN_BATCHES = 12         # + 1 batch of hi != 0 keys, x 2 variables
LOAD_CHUNK = 1 << 16          # keys per insert_rows call, as the loader's
GATHER_MANY = 1_000_003       # K1 ids in one call: many strides of its grid
PROBE_MANY = 300_001          # K2 queries in one call: likewise
TRAIN_BATCHES = 8             # distinct batches, cycled (bench.py's 8)
CHECK_STEPS = 4               # card steps held against CPU steps
WARMUP_STEPS = 3
BLOCKS, BLOCK_STEPS = 5, 20   # timed throughput blocks
TRACE_STEPS = 20
STAGE_REPS = 20               # fresh batches of the hash push's stages
STAGE_STEPS = 8               # steps of the armed window (step_stages)
UNTOUCHED_SAMPLE = 1 << 20    # untouched ids checked bit for bit
CHANGE_RTOL = 1e-3            # of a touched row's largest change
CHANGE_ULPS = 2               # units at each value's magnitude
SYNC_STEPS = 3                # hash steps under sync debug mode "error"
ORACLE_STEPS = 4              # captured steps held against eager steps
XDEEP_BATCH = 2048            # xdeepfm_dim16 (bench.py): batch ...
XDEEP_DIM = 16                # ... and embedding width
CIN_LAYERS = (128, 128)       # XDeepFM's defaults, as bench.py builds it
DNN_UNITS = (256, 128)
CROSS_LAYERS = 3              # DCN's default
TRACE_WINDOW = "chip_smoke.traced_steps"   # the trace's annotation
# the kernels of each wrapper, by their names in a profiler trace
KERNEL_NAMES = {"gather_rows": ("gather_fixed", "gather_tile",
                                "gather_units"),
                "probe_gather": ("probe_gather_kernel",),
                "init_rows": ("keyed_rows_kernel",)}
INIT_ROWS = 4096              # rows of each range held card against CPU
INIT_LOSS_ATOL = 1e-6         # first losses from the card's and CPU's init
# H100 SXM: each of an SM's 4 schedulers dispatches one warp instruction a
# clock, 128 lane operations, which is the data sheet's 67 TFLOP/s float32
# rate (an FMA counted as two flops) over 2. KI's integer adds reach that
# rate too: besides the 64-lane INT pipe, the FMA pipe takes them as
# IMAD.IADD, so 64 int32 lanes an SM are not the ceiling of its mix.
LANE_OPS_PER_S = 67e12 / 2
# 32-bit operations of one threefry-2x32 block: the key schedule (one
# three-input LOP3), the first key injection (2 adds), 20 rounds of add,
# funnel shift, xor (60) and 5 key injections of 2 adds each (x1 + ks[b]
# + i is one IADD3)
THREEFRY_OPS = 73
# a row element's draw after its block: uniform x0 ^ x1, shift, or,
# subtract 1, FMA, max (6); a normal draw adds erf_inv's float arithmetic
# (x * x, w - 2.5, 8 polynomial steps of a multiply and an add, p * x) and
# the scaling (sqrt 2, stddev, mean), 22, leaving log1pf and sqrtf
# uncounted; a truncated one adds the clip (2)
DRAW_OPS = {"uniform": 6, "normal": 6 + 22, "truncated": 6 + 22 + 2}


def log(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def phase_build() -> None:
    from openembedding_tpu_torch.ops import _build
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s "
        f"({', '.join(f'{k} {v:.3f} s' for k, v in per_source.items())})")


# --- phase 3 -----------------------------------------------------------------

def _median_ms(fn, flush: torch.Tensor, reps: int = REPS,
               warm: int = 3) -> float:
    """CUDA-event median of ``fn``'s device time over ``reps`` runs after
    ``warm`` more, with the L2 flushed before each run: a ~1 ms spin
    kernel runs first, so ``fn``'s kernels are all enqueued before the
    start event fires and the events bracket device time alone."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _call_ms(fn, calls: int = 100) -> float:
    """What a caller pays per call: the wall time of ``calls`` back-to-back
    calls of ``fn`` through the final synchronize, over ``calls`` (the
    host's dispatch, or the device time where that is longer), median of
    9 repeats."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def row_sector_bytes(row_bytes: int, rows: np.ndarray) -> int:
    """Bytes of the 32-byte sectors holding the given rows, each sector
    counted once."""
    uniq = np.unique(rows).astype(np.int64)
    if not uniq.size:
        return 0
    first = uniq * row_bytes // SECTOR
    last = (uniq * row_bytes + row_bytes - 1) // SECTOR
    spans = [first + k for k in range(int((last - first).max()) + 1)]
    return int(np.unique(np.concatenate(
        [s[s <= last] for s in spans])).size * SECTOR)


def gather_bound_bytes(table: torch.Tensor, ids: np.ndarray) -> int:
    """Bytes a row gather must move: the 32-byte sectors holding the
    distinct valid rows, read once, plus the ids read and the rows
    written."""
    vocab, dim = table.shape
    row_bytes = dim * table.element_size()
    return (row_sector_bytes(row_bytes, ids[(ids >= 0) & (ids < vocab)])
            + ids.size * ids.itemsize + ids.size * row_bytes)


def check_case(name, table, ids_np, flush, gather_rows, reference,
               unaligned=False):
    """K1 against its plain version on one case, exact, with its timings
    beside the plain version's, ``index_select``'s and the bound;
    ``unaligned``: the ids tensor starts one id past a 16-byte boundary."""
    if unaligned:
        ids = torch.from_numpy(np.concatenate(
            [ids_np[:1], ids_np])).to(table.device)[1:]
    else:
        ids = torch.from_numpy(ids_np).to(table.device)
    got = gather_rows(table, ids)
    want = reference(table, ids)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(f"gather_rows != reference on case {name}")
    err = float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0
    case = {"case": name, "table": list(table.shape),
            "dtype": str(table.dtype).replace("torch.", ""),
            "ids": int(ids_np.size), "id_dtype": str(ids_np.dtype),
            "max_abs_err": err}
    if ids_np.size:
        valid = ids[(ids >= 0) & (ids < table.shape[0])]
        fns = {"kernel": lambda: gather_rows(table, ids),
               "plain": lambda: reference(table, ids),
               "library": lambda: torch.index_select(table, 0, valid)}
        for k, fn in fns.items():
            case[f"{k}_ms"] = _median_ms(fn, flush)
        for k in ("kernel", "library"):
            case[f"{k}_call_ms"] = _call_ms(fns[k])
        case["bound_ms"] = gather_bound_bytes(table, ids_np) \
            / HBM_BYTES_PER_S * 1e3
    return case


def phase_kernels(w9, w1, main_ids: np.ndarray):
    from openembedding_tpu_torch.ops.gather import (gather_rows,
                                                    gather_rows_reference)
    dev = w9.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(SEED)
    bf16 = torch.randn((1 << 18, 64), device=dev).to(torch.bfloat16)
    t128 = torch.randn((4096, 128), device=dev)
    t300 = torch.randn((1 << 14, 300), device=dev)
    wild = np.concatenate([
        rng.randint(0, 1 << 18, 4093).astype(np.int64),
        np.asarray([-1, 1 << 18, 2**32 + 3, -(2**40),
                    2**32, (1 << 18) - 1, 0], np.int64)])
    rng.shuffle(wild)
    cases = [
        check_case("fields_dim9_f32_i32", w9, main_ids, flush, gather_rows,
                   gather_rows_reference),
        check_case("linear_dim1_f32_i32", w1, main_ids, flush, gather_rows,
                   gather_rows_reference),
        check_case("fields_dim9_f32_uniform_1m", w9,
                   rng.randint(0, w9.shape[0], 1 << 20).astype(np.int32),
                   flush, gather_rows, gather_rows_reference),
        check_case("bf16_dim64_i32", bf16,
                   rng.randint(0, 1 << 18, main_ids.size).astype(np.int32),
                   flush, gather_rows, gather_rows_reference),
        check_case("dim128_f32_i32", t128,
                   rng.randint(0, 4096, 4096).astype(np.int32), flush,
                   gather_rows, gather_rows_reference),
        check_case("bf16_dim64_i64_invalid", bf16, wild, flush, gather_rows,
                   gather_rows_reference),
        check_case("fields_n1", w9, main_ids[:1], flush, gather_rows,
                   gather_rows_reference),
        check_case("fields_n0", w9, main_ids[:0], flush, gather_rows,
                   gather_rows_reference),
        check_case(f"fields_dim9_f32_n{GATHER_MANY}", w9,
                   rng.randint(0, w9.shape[0], GATHER_MANY).astype(np.int32),
                   flush, gather_rows, gather_rows_reference),
        *[check_case(f"{name}_n_mod4_{r}", w, main_ids[:main_ids.size - 4 + r],
                     flush, gather_rows, gather_rows_reference)
          for name, w in (("fields_dim9", w9), ("linear_dim1", w1))
          for r in (1, 2, 3)],
        check_case("dim300_f32_i32", t300,
                   rng.randint(-2, t300.shape[0] + 2, 32768).astype(np.int32),
                   flush, gather_rows, gather_rows_reference),
        check_case("fields_dim9_f32_i32_unaligned_ids", w9, main_ids, flush,
                   gather_rows, gather_rows_reference, unaligned=True),
    ]
    log(json.dumps({"gather_cases": cases}))
    return cases


# --- phase 4 -----------------------------------------------------------------

def _post(conn, path: str, body: bytes):
    conn.request("POST", path, body)
    resp = conn.getresponse()
    return resp.status, resp.read()


def lookup_bin(conn, sign: str, variable: str, ids: np.ndarray):
    head = json.dumps({"variable": variable, "dtype": str(ids.dtype),
                       "shape": list(ids.shape)}).encode() + b"\n"
    t0 = time.perf_counter()
    status, raw = _post(conn, f"/models/{sign}/lookup_bin",
                        head + ids.tobytes())
    dt = (time.perf_counter() - t0) * 1e3
    if status != 200:
        raise AssertionError(f"lookup_bin {variable}: HTTP {status} {raw!r}")
    nl = raw.index(b"\n")
    shape = json.loads(raw[:nl])["shape"]
    return np.frombuffer(raw[nl + 1:], np.float32).reshape(shape), dt


def expected_rows(host: np.ndarray, ids: np.ndarray) -> np.ndarray:
    valid = (ids >= 0) & (ids < host.shape[0])
    rows = host[np.where(valid, ids, 0)]
    rows[~valid] = 0
    return rows


def serving_breakdown(server, sign, batches, trace_path):
    """Where a lookup_bin request's time goes, per variable: the HTTP
    round trip, the in-process lookup with its copy to the host (the
    registry call the handler makes), and the device's busy share over a
    window of requests from a ``torch.profiler`` trace (kernels, copies
    and fills, against the window's wall time)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)
    for var in ("fields", "fields:linear"):
        http_ms, direct_ms = [], []
        for ids in batches:
            http_ms.append(lookup_bin(conn, sign, var, ids)[1])
            t0 = time.perf_counter()
            server.registry.lookup(sign, var, ids).float().cpu().numpy()
            direct_ms.append((time.perf_counter() - t0) * 1e3)
        out[var] = {"http_p50_ms": statistics.median(http_ms),
                    "direct_p50_ms": statistics.median(direct_ms)}
    conn.close()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a fresh connection: the profiler's start-up can outlast the
        # server's idle keep-alive timeout
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        t0 = time.perf_counter()
        for ids in batches:
            for var in ("fields", "fields:linear"):
                lookup_bin(conn, sign, var, ids)
        wall_us = (time.perf_counter() - t0) * 1e6
    conn.close()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    busy = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = e["cat"] if e["cat"] != "kernel" else e["name"][:60]
            busy[key] = busy.get(key, 0.0) + float(e.get("dur", 0.0))
    out["profile"] = {
        "requests": 2 * len(batches), "wall_us": wall_us,
        "device_busy_us": sum(busy.values()),
        "device_busy_share": sum(busy.values()) / wall_us if busy else None,
        "by_name_us": dict(sorted(busy.items(), key=lambda kv: -kv[1]))}
    return out


def phase_serving(coll, states, mapper, host):
    from openembedding_tpu_torch import checkpoint
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.serving.rest import ControllerServer

    ckpt_dir = os.path.join(ROOT, "_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    server = None
    try:
        saved = checkpoint.save_checkpoint(ckpt_dir, coll, states,
                                           include_optimizer=True,
                                           model_sign="deepfm_dim9-0")
        log(f"checkpoint save: {saved['seconds']:.3f} s, "
            f"{saved['bytes']} bytes")
        batches = [mapper.fuse(b["sparse"])["fields"] for b in
                   synthetic_criteo(BATCH, num_buckets=VOCAB_PER_FEATURE,
                                    seed=SEED + 1,
                                    num_batches=BIN_BATCHES + 2)]
        gather_rows.launches = 0
        server = ControllerServer(port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        t0 = time.perf_counter()
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": ckpt_dir, "block": True}).encode())
        load_s = time.perf_counter() - t0
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        lookups = 0
        latencies = []
        for i, ids in enumerate(batches[:BIN_BATCHES]):
            for var in ("fields", "fields:linear"):
                rows, dt = lookup_bin(conn, sign, var, ids)
                lookups += 1
                if i:       # the first batch warms the connection
                    latencies.append(dt)
                if not np.array_equal(rows, expected_rows(host[var], ids)):
                    raise AssertionError(f"lookup_bin {var} batch {i} "
                                         "differs from the host weights")
        bad = batches[BIN_BATCHES].copy()
        vocab = host["fields"].shape[0]
        bad.reshape(-1)[::7] = -1
        bad.reshape(-1)[3::11] = vocab
        bad.reshape(-1)[5::13] = np.iinfo(np.int32).max
        for var in ("fields", "fields:linear"):
            rows, _ = lookup_bin(conn, sign, var, bad)
            lookups += 1
            if not np.array_equal(rows, expected_rows(host[var], bad)):
                raise AssertionError(f"lookup_bin {var} with invalid ids "
                                     "differs from the host weights")
        small = batches[BIN_BATCHES + 1][:256]
        status, body = _post(conn, f"/models/{sign}/lookup", json.dumps(
            {"variable": "fields", "indices": small.tolist()}).encode())
        lookups += 1
        if status != 200:
            raise AssertionError(f"lookup: HTTP {status} {body!r}")
        rows = np.asarray(json.loads(body)["rows"], np.float32)
        if not np.array_equal(rows, expected_rows(host["fields"], small)):
            raise AssertionError("JSON lookup differs from the host weights")
        launches = gather_rows.launches
        if launches < lookups:
            raise AssertionError(f"gather_rows launched {launches} times "
                                 f"for {lookups} lookups")
        p50 = statistics.median(latencies)
        p99 = float(np.percentile(latencies, 99))
        log(f"serving: model load {load_s:.3f} s; {lookups} lookups, "
            f"{launches} gather launches; lookup_bin [4096, 26] latency "
            f"p50 {p50:.3f} ms p99 {p99:.3f} ms over {len(latencies)} "
            "requests")
        conn.close()
        breakdown = serving_breakdown(server, sign, batches[1:BIN_BATCHES],
                                      os.path.join(ckpt_dir, "trace.json"))
        log(json.dumps({"serving": {
            "load_s": load_s, "save_s": saved["seconds"],
            "lookups": lookups, "launches": launches,
            "lookup_bin_p50_ms": p50, "lookup_bin_p99_ms": p99,
            "lookup_bin_ms": latencies, "breakdown": breakdown}}))
        return launches
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# --- phases 5 and 6: hash tables ---------------------------------------------

def hash_keys(mapper):
    """The served request batches (``[4096, 26, 2]`` pairs; the last one
    drawn from a 2^62-bucket space, so its keys carry hi != 0) and the
    keys each table holds, as int64: every distinct key of those batches
    plus filler keys from the same fused key space, ``HASH_CAPACITY / 2``
    in all (load 0.5), in a seeded random order."""
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.hash_table import join64
    batches = [mapper.fuse(b["sparse"])["fields"] for b in synthetic_criteo(
        BATCH, num_buckets=HASH_VOCAB, seed=SEED + 2,
        num_batches=HASH_BIN_BATCHES + 2)]
    batches.append(mapper.fuse(next(synthetic_criteo(
        BATCH, num_buckets=1 << 62, seed=SEED + 3))["sparse"])["fields"])
    served = np.unique(np.concatenate(
        [join64(b).reshape(-1) for b in batches]))
    rng = np.random.RandomState(SEED)
    need = HASH_CAPACITY // 2 - served.size
    space = HASH_VOCAB * len(mapper.feature_names)
    filler = np.setdiff1d(rng.randint(0, space, int(need * 1.2),
                                      dtype=np.int64), served)
    if filler.size < need:
        raise AssertionError(f"{filler.size} filler keys for {need}")
    filler = filler[rng.permutation(filler.size)[:need]]
    keys = np.concatenate([served, filler])
    log(f"hash keys: {served.size} distinct served keys, {need} filler")
    return batches, keys[rng.permutation(keys.size)]


def seeded(key, tag: int, shape, cfg, dev) -> torch.Tensor:
    """A float32 array of ``shape`` on ``dev`` drawn by ``cfg`` (an
    initializer config) from ``fold_in(key, tag)``: test data made from a
    threefry key, the same on any device."""
    from openembedding_tpu_torch.optim import initializers as ti
    return ti.make_initializer(cfg).init(ti.fold_in(key, tag), shape,
                                         torch.float32, dev)


def fill_hash(state, keys: torch.Tensor, key):
    """Insert ``keys`` with rows and adagrad accumulators drawn from the
    threefry ``key`` (normal(0, 1) rows, accumulators uniform on
    [0.1, 1.1)), ``LOAD_CHUNK`` at a time; returns the rows as inserted
    (on the device). Fails unless every key found a slot."""
    from openembedding_tpu_torch.hash_table import insert_rows
    n, dev = keys.shape[0], keys.device
    rows = seeded(key, 0, (n, state.dim), "normal", dev).to(
        state.weights.dtype)
    slots = {k: seeded(key, 1 + i, (n,) + tuple(v.shape[1:]),
                       {"category": "uniform", "minval": 0.1,
                        "maxval": 1.1}, dev)
             for i, (k, v) in enumerate(state.slots.items())}
    for lo in range(0, n, LOAD_CHUNK):
        hi = lo + LOAD_CHUNK
        insert_rows(state, keys[lo:hi], rows[lo:hi],
                    {k: v[lo:hi] for k, v in slots.items()})
    failures = int(state.insert_failures)
    if failures or state.num_used() != n:
        raise AssertionError(f"hash fill: {failures} insert failures, "
                             f"{state.num_used()} of {n} keys placed")
    return rows


class HostRows:
    """One table's key -> row dictionary on the host (sorted int64 keys
    beside their rows): what every hash lookup must return."""

    def __init__(self, keys: np.ndarray, rows: np.ndarray):
        order = np.argsort(keys)
        self.keys, self.rows = keys[order], rows[order]

    def expect(self, query: np.ndarray) -> np.ndarray:
        """Rows for ``[..., 2]`` int32 pairs (EMPTY where hi is) or narrow
        int64 ids; zero rows for keys the table does not hold."""
        from openembedding_tpu_torch.hash_table import join64
        if query.dtype == np.int32 and query.shape[-1] == 2:
            q, valid = join64(query), query[..., 1] != EMPTY32
        else:
            q, valid = query.astype(np.int64), np.ones(query.shape, bool)
        pos = np.minimum(np.searchsorted(self.keys, q), self.keys.size - 1)
        found = valid & (self.keys[pos] == q)
        rows = self.rows[pos]
        rows[~found] = 0
        return rows


def _union_length(lo: np.ndarray, hi: np.ndarray) -> int:
    """Size of the union of the integer ranges ``[lo, hi]``."""
    if not lo.size:
        return 0
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    covered = np.concatenate([[lo[0] - 1], np.maximum.accumulate(hi)[:-1]])
    return int(np.maximum(0, hi - np.maximum(lo - 1, covered)).sum())


def probe_bound_bytes(keys, weights, query, slots: torch.Tensor):
    """Bytes a probe gather must move, counted for this run's data, and
    the same with whole windows.

    Keys are never freed and a bucket fills front to back, so a scan of a
    query's window may stop at its match or at the first EMPTY slot: the
    bytes the data needs are the key sectors from each valid query's
    window start through that slot (each sector once over all queries).
    The window count reads every distinct probe window whole (whole
    buckets, so whole sectors). Both add the 32-byte sectors of the
    distinct matched rows, the queries read, the rows and hit flags
    written. Returns ``(needed, windows)``."""
    from openembedding_tpu_torch.hash_table import (DEFAULT_MAX_PROBES,
                                                    probe_starts,
                                                    table_layout)
    capacity = keys.shape[0]
    bsz, _nb, chain = table_layout(capacity, DEFAULT_MAX_PROBES)
    wide = query.dim() == 2
    empty = torch.iinfo(keys.dtype).min     # int32 words, or int64 keys
    valid = (query[:, 1] if wide else query) != empty
    start = probe_starts(query[valid], capacity, DEFAULT_MAX_PROBES)
    span = chain * bsz
    window = keys[start[:, None] + torch.arange(span, device=keys.device)]
    free = (window[..., 1] if wide else window) == empty
    hit = slots[valid]
    stop = torch.where(
        hit >= 0, hit - start,
        torch.where(free.any(1), free.to(torch.uint8).argmax(1), span - 1))
    key_bytes = keys.element_size() * (2 if wide else 1)
    start, stop = start.cpu().numpy(), stop.cpu().numpy()
    needed = _union_length(start * key_bytes // SECTOR,
                           ((start + stop + 1) * key_bytes - 1) // SECTOR)
    windows = np.unique((start // bsz)[:, None] + np.arange(chain)).size
    row_bytes = weights.shape[1] * weights.element_size()
    n = query.shape[0]
    rest = (row_sector_bytes(row_bytes, slots[slots >= 0].cpu().numpy())
            + n * key_bytes + n * row_bytes + n)
    return needed * SECTOR + rest, windows * bsz * key_bytes + rest


def check_probe_case(name, keys, weights, query, flush):
    """K2 against its plain version on one case, exact (rows and hit),
    with its timings beside the plain version's, the "gather part only"
    ``index_select`` over the already-resolved slots (not the same
    function: it skips the probe) and the bound."""
    from openembedding_tpu_torch.hash_table import (DEFAULT_MAX_PROBES,
                                                    find_rows, table_layout)
    from openembedding_tpu_torch.ops.probe_gather import (
        probe_gather, probe_gather_reference)
    bsz, _nb, chain = table_layout(keys.shape[0], DEFAULT_MAX_PROBES)
    kw = {"chain": chain, "bucket": bsz,
          "empty": torch.iinfo(keys.dtype).min}
    rows, hit = probe_gather(keys, weights, query, **kw)
    want_rows, want_hit = probe_gather_reference(keys, weights, query, **kw)
    torch.cuda.synchronize()
    if rows.shape != want_rows.shape or rows.dtype != want_rows.dtype \
            or not torch.equal(rows, want_rows) \
            or not torch.equal(hit, want_hit):
        raise AssertionError(f"probe_gather != reference on case {name}")
    n = query.shape[0]
    case = {"case": name, "keys": list(keys.shape),
            "key_dtype": str(keys.dtype).replace("torch.", ""),
            "weights": list(weights.shape),
            "dtype": str(weights.dtype).replace("torch.", ""),
            "queries": n, "hits": int(hit.sum()),
            "max_abs_err": float((rows.float() - want_rows.float()).abs()
                                 .max()) if rows.numel() else 0.0}
    if n:
        slots = find_rows(keys, query)
        if not torch.equal(slots >= 0, hit):
            raise AssertionError(f"find_rows and probe_gather disagree on "
                                 f"the hits of case {name}")
        resolved = slots[slots >= 0]
        fns = {"kernel": lambda: probe_gather(keys, weights, query, **kw),
               "plain": lambda: probe_gather_reference(keys, weights, query,
                                                       **kw),
               "gather": lambda: torch.index_select(weights, 0, resolved)}
        for k, fn in fns.items():
            case[f"{k}_ms"] = _median_ms(fn, flush)
        for k in ("kernel", "gather"):
            case[f"{k}_call_ms"] = _call_ms(fns[k])
        needed, windows = probe_bound_bytes(keys, weights, query, slots)
        case["bound_ms"] = needed / HBM_BYTES_PER_S * 1e3
        case["bound_windows_ms"] = windows / HBM_BYTES_PER_S * 1e3
    return case


def _narrow_table(dev, capacity, dim, keys: np.ndarray, key):
    """An int32-key hash table filled with ``keys`` and random rows."""
    from openembedding_tpu_torch.hash_table import create_hash_table
    from openembedding_tpu_torch.meta import (UNBOUNDED_VOCAB,
                                              EmbeddingVariableMeta)
    st = create_hash_table(
        EmbeddingVariableMeta("float32", dim, UNBOUNDED_VOCAB), "default",
        capacity=capacity, key_dtype="int32", device=dev)
    fill_hash(st, torch.from_numpy(keys).to(dev), key)
    return st


def _window_offsets(keys: torch.Tensor) -> torch.Tensor:
    """[capacity] int64: each live slot's offset in its key's probe window,
    -1 at free slots."""
    from openembedding_tpu_torch.hash_table import (DEFAULT_MAX_PROBES,
                                                    probe_starts)
    wide = keys.dim() == 2
    live = torch.nonzero((keys[:, 1] if wide else keys) != EMPTY32).flatten()
    out = torch.full((keys.shape[0],), -1, dtype=torch.int64,
                     device=keys.device)
    out[live] = live - probe_starts(keys[live], keys.shape[0],
                                    DEFAULT_MAX_PROBES)
    return out


def _crafted_table(dev, key, rng):
    """A wide-key ``[2^16, 9]`` f32 table whose window at bucket 5 and whose
    last window (the span's last start, ending at the table's end) each
    hold 256 keys that start there, filled through ``insert_rows`` with 8
    more per window that fail: both windows are full, so keys overflowed
    into their second bucket and a miss there finds no EMPTY slot to stop
    at. Returns the state and, per window, the offered keys (placed, then
    failed) and absent keys that start in it, as pairs."""
    from openembedding_tpu_torch.hash_table import (
        DEFAULT_MAX_PROBES, create_hash_table, insert_rows, probe_starts,
        split64, table_layout)
    from openembedding_tpu_torch.meta import (UNBOUNDED_VOCAB,
                                              EmbeddingVariableMeta)
    capacity = 1 << 16
    bsz, nb, chain = table_layout(capacity, DEFAULT_MAX_PROBES)
    span = nb - chain + 1
    cand = split64(np.unique(rng.randint(0, 2**62, span * 700,
                                         dtype=np.int64)))
    start = (probe_starts(torch.from_numpy(cand).to(dev), capacity,
                          DEFAULT_MAX_PROBES) // bsz).cpu().numpy()
    windows = {}
    for name, b in (("bucket5", 5), ("last", span - 1)):
        mine = cand[start == b]
        windows[name] = (mine[:chain * bsz + 8], mine[chain * bsz + 8:300])
    st = create_hash_table(
        EmbeddingVariableMeta("float32", 9, UNBOUNDED_VOCAB), "default",
        capacity=capacity, key_dtype="wide", device=dev)
    offered = np.concatenate([w[0] for w in windows.values()])
    insert_rows(st, torch.from_numpy(offered).to(dev),
                seeded(key, 7, (len(offered), 9), "normal", dev))
    if int(st.insert_failures) != 16:
        raise AssertionError(f"crafted table: {int(st.insert_failures)} "
                             "insert failures, 16 expected")
    return st, windows


def phase_probe_kernels(states, batches, keys64):
    """K2 against its plain version on the card: the main-path shape (one
    ``[4096, 26, 2]`` batch on the filled ``fields`` table), the ``:linear``
    table, an int32-key table of the same capacity, the JAX kernel's own
    benchmark shape ``hash_probe_dim128`` (``[2^22, 128]``, 32,768
    queries), bf16 weights, a mix of hits, misses, EMPTY and hi != 0
    keys, n = 1 and n = 0; then the design's edges: keys at window slots
    31, 32 and 33 (the end and start of a 32-pair step) of the ``fields``
    table, the crafted table's full windows (keys overflowed into the
    second bucket, misses with no EMPTY slot to stop at, the span's last
    window at the table's end), and n = 300,001 (the one-wave grid strides
    several times)."""
    from openembedding_tpu_torch.hash_table import join64, split64
    fields, linear = states["fields"], states["fields:linear"]
    dev = fields.keys.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    from openembedding_tpu_torch.optim.initializers import fold_in, prng_key
    key = prng_key(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    main = torch.from_numpy(batches[0].reshape(-1, 2)).to(dev)
    fits = keys64[(keys64 > EMPTY32) & (keys64 < 2**31)].astype(np.int32)
    narrow = _narrow_table(dev, HASH_CAPACITY, 9, fits, fold_in(key, 1))
    narrow_q = torch.from_numpy(join64(batches[0]).reshape(-1).astype(
        np.int32)).to(dev)
    probe_keys = (rng.permutation(1 << 23)[:1 << 21] + 1).astype(np.int32)
    t128 = _narrow_table(dev, 1 << 22, 128, probe_keys, fold_in(key, 2))
    q128 = torch.from_numpy(probe_keys[rng.randint(0, probe_keys.size,
                                                   32768)]).to(dev)
    mixed = batches[-1].reshape(-1, 2).copy()
    mixed[::7, 1] = EMPTY32                                 # EMPTY
    mixed[3::11] = rng.randint(1 << 20, 1 << 30, (mixed[3::11].shape))
    mixed = torch.from_numpy(mixed).to(dev)
    offsets = _window_offsets(fields.keys)
    at_step_edge = torch.nonzero((offsets >= 31) & (offsets <= 33)).flatten()
    edge_q = fields.keys[at_step_edge]
    if sorted(offsets[at_step_edge].unique().tolist()) != [31, 32, 33]:
        raise AssertionError("no fields keys at window slots 31, 32 and 33")
    crafted, windows = _crafted_table(dev, fold_in(key, 3), rng)
    crafted_q = {name: torch.from_numpy(np.concatenate(w)).to(dev)
                 for name, w in windows.items()}
    depth = _window_offsets(crafted.keys)
    if not (bool((depth >= 128).any()) and bool((depth == 255).any())):
        raise AssertionError("crafted table: no keys in second buckets")
    big = split64(keys64[rng.randint(0, keys64.size, PROBE_MANY)])
    big[::5] = split64(rng.randint(2**62, 2**63 - 1, big[::5].shape[0],
                                   dtype=np.int64))          # misses
    big = torch.from_numpy(big).to(dev)
    cases = [
        check_probe_case("fields_wide_dim9_f32_main", fields.keys,
                         fields.weights, main, flush),
        check_probe_case("linear_wide_dim1_f32", linear.keys, linear.weights,
                         main, flush),
        check_probe_case("fields_int32_dim9_f32", narrow.keys,
                         narrow.weights, narrow_q, flush),
        check_probe_case("hash_probe_dim128_int32_f32", t128.keys,
                         t128.weights, q128, flush),
        check_probe_case("fields_wide_dim9_bf16", fields.keys,
                         fields.weights.to(torch.bfloat16), main, flush),
        check_probe_case("fields_wide_mixed_hits_misses_empty_hi",
                         fields.keys, fields.weights, mixed, flush),
        check_probe_case("fields_n1", fields.keys, fields.weights, main[:1],
                         flush),
        check_probe_case("fields_n0", fields.keys, fields.weights, main[:0],
                         flush),
        check_probe_case("fields_window_slots_31_32_33", fields.keys,
                         fields.weights, edge_q, flush),
        check_probe_case("crafted_second_bucket_and_full_window_misses",
                         crafted.keys, crafted.weights,
                         crafted_q["bucket5"], flush),
        check_probe_case("crafted_last_window_of_span", crafted.keys,
                         crafted.weights, crafted_q["last"], flush),
        check_probe_case(f"fields_n{PROBE_MANY}", fields.keys, fields.weights,
                         big, flush),
    ]
    log(json.dumps({"probe_cases": cases}))
    return cases


def _expect_equal(what, rows, want):
    if rows.shape != want.shape or not np.array_equal(rows, want):
        raise AssertionError(f"{what} differs from the host's key -> row "
                             "dictionary")


def phase_hash_serving(coll, states, batches, host):
    """The ``deepfm_dim9_hash`` tables saved, loaded through ``POST
    /models`` and served: ``[4096, 26, 2]`` pair ``lookup_bin`` requests
    on both variables (the last batch with hi != 0 keys), narrow int64
    ids the server widens, a batch with misses and EMPTY pairs, one JSON
    ``lookup``. Every response equals the host's dictionary exactly, and
    K2's launch count covers every lookup."""
    from openembedding_tpu_torch import checkpoint
    from openembedding_tpu_torch.hash_table import join64
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.serving.rest import ControllerServer

    ckpt_dir = os.path.join(ROOT, "_smoke_hash_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    server = None
    rng = np.random.RandomState(SEED + 2)
    try:
        saved = checkpoint.save_checkpoint(ckpt_dir, coll, states,
                                           include_optimizer=True,
                                           model_sign="deepfm_dim9_hash-0")
        log(f"hash checkpoint save: {saved['seconds']:.3f} s, "
            f"{saved['bytes']} bytes")
        probe_gather.launches = 0
        server = ControllerServer(port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        t0 = time.perf_counter()
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": ckpt_dir, "block": True}).encode())
        load_s = time.perf_counter() - t0
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        lookups = 0
        latencies = []
        served = batches[:HASH_BIN_BATCHES] + [batches[-1]]
        for i, ids in enumerate(served):
            for var in ("fields", "fields:linear"):
                rows, dt = lookup_bin(conn, sign, var, ids)
                lookups += 1
                if i:       # the first batch warms the connection
                    latencies.append(dt)
                _expect_equal(f"lookup_bin {var} batch {i}", rows,
                              host[var].expect(ids))
        narrow = join64(batches[HASH_BIN_BATCHES])        # int64 [4096, 26]
        bad = batches[HASH_BIN_BATCHES + 1].copy()
        flat = bad.reshape(-1, 2)
        flat[::7, 1] = EMPTY32
        flat[3::11] = rng.randint(1 << 20, 1 << 30, flat[3::11].shape)
        misses = int((np.abs(host["fields"].expect(bad)).sum(-1) == 0).sum())
        for what, ids in (("narrow int64 ids", narrow),
                          ("misses and EMPTY", bad)):
            for var in ("fields", "fields:linear"):
                rows, _ = lookup_bin(conn, sign, var, ids)
                lookups += 1
                _expect_equal(f"lookup_bin {var} with {what}", rows,
                              host[var].expect(ids))
        small = join64(batches[-1][:64])          # hi != 0, widened on host
        status, body = _post(conn, f"/models/{sign}/lookup", json.dumps(
            {"variable": "fields", "indices": small.tolist(),
             "int64": True}).encode())
        lookups += 1
        if status != 200:
            raise AssertionError(f"lookup: HTTP {status} {body!r}")
        _expect_equal("JSON lookup", np.asarray(json.loads(body)["rows"],
                                                np.float32),
                      host["fields"].expect(small))
        launches = probe_gather.launches
        if launches < lookups:
            raise AssertionError(f"probe_gather launched {launches} times "
                                 f"for {lookups} hash lookups")
        p50 = statistics.median(latencies)
        p99 = float(np.percentile(latencies, 99))
        log(f"hash serving: model load {load_s:.3f} s; {lookups} lookups, "
            f"{launches} probe launches, {misses} zero rows in the "
            f"miss/EMPTY batch; lookup_bin [4096, 26, 2] latency p50 "
            f"{p50:.3f} ms p99 {p99:.3f} ms over {len(latencies)} requests")
        conn.close()
        breakdown = serving_breakdown(server, sign,
                                      batches[1:HASH_BIN_BATCHES],
                                      os.path.join(ckpt_dir, "trace.json"))
        log(json.dumps({"hash_serving": {
            "load_s": load_s, "save_s": saved["seconds"],
            "save_bytes": saved["bytes"], "lookups": lookups,
            "launches": launches, "lookup_bin_p50_ms": p50,
            "lookup_bin_p99_ms": p99, "lookup_bin_ms": latencies,
            "breakdown": breakdown}}))
        return launches
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


# --- phase 7: training -------------------------------------------------------

def build_trainer(device):
    """The ``deepfm_dim9`` trainer of ``bench.py``: the fused tables with
    sparse Adagrad (lr 0.01), ``DeepFM`` with ``dnn_units=(256, 128)`` and
    dense optax-form Adagrad (lr 0.01), on ``device``."""
    from openembedding_tpu_torch.data.criteo import NUM_DENSE, SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import build_model
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    specs, mapper = make_fused_specs(
        SPARSE_NAMES, VOCAB_PER_FEATURE, 9,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    module = build_model("deepfm", SPARSE_NAMES, embedding_dim=9,
                         num_dense=NUM_DENSE, dnn_units=(256, 128))
    return Trainer(module, EmbeddingCollection(specs, device=device,
                                               seed=SEED),
                   dense.adagrad(0.01)), mapper


def _close(what, got, want) -> float:
    """``got`` (card) within atol 1e-5 + rtol 1e-4 of ``want`` (CPU),
    compared on ``got``'s device; returns the largest difference."""
    want = want.to(got.device)
    if got.shape != want.shape or not torch.allclose(got, want, rtol=1e-4,
                                                     atol=1e-5):
        raise AssertionError(f"training: {what} differs between the card "
                             "and the CPU")
    return float((got - want).abs().max()) if got.numel() else 0.0


def change_ratio(got, want, initial) -> torch.Tensor:
    """Per row, how far the card's change (``got - initial``) lies from
    the CPU's (``want - initial``) in units of that row's limit:
    ``CHANGE_RTOL`` of the row's largest CPU change plus ``CHANGE_ULPS``
    units of the storage dtype at each value's magnitude (the devices may
    round a sum once differently). Above 1 is a mismatch. A value check
    cannot see the change of a row that starts near 1e-4 and moves by
    1e-7; this one can."""
    eps = torch.finfo(initial.dtype).eps
    got, want, initial = (t.detach().cpu().double().reshape(len(t), -1)
                          for t in (got, want, initial))
    d_got, d_want = got - initial, want - initial
    mag = torch.maximum(torch.maximum(got.abs(), want.abs()), initial.abs())
    limit = (CHANGE_RTOL * d_want.abs().amax(1, keepdim=True)
             + CHANGE_ULPS * eps * mag).clamp_min(torch.finfo().tiny)
    return ((d_got - d_want).abs() / limit).amax(1)


def _fault_reading(faulted, want, initial, rows) -> dict:
    """What the change check and the value check read on a card state
    with a simulated fault in ``rows`` (those the CPU moved): the largest
    ratio, and the share of those rows each check flags. A row whose
    move lies within the rounding floor cannot be flagged."""
    if not rows.any():
        return {"rows": 0}
    ratio = change_ratio(faulted, want, initial)[rows]
    value = ((faulted - want).abs()
             > 1e-5 + 1e-4 * want.abs()).reshape(len(want), -1).any(1)[rows]
    return {"rows": int(rows.sum()), "change_max": float(ratio.max()),
            "change_flags": float((ratio > 1).double().mean()),
            "value_flags": float(value.double().mean())}


def check_against_cpu(trainer, state, batches, cpu_trainer=None,
                      what="training"):
    """``CHECK_STEPS`` card steps against the same steps of a CPU trainer
    from a copy of the initial state; untouched rows bit for bit; K1
    launched twice a card step. Every touched row's change, and that of
    its slots, is held to the CPU's by ``change_ratio``, and the check is
    shown to flag two simulated push faults: cold rows (seen once) of the
    weights left unwritten, and ``accum`` left unchanged (a slot's cold
    rows may move within the rounding floor, so there it is only read).
    The card steps are captured (``train_step``: the first builds the
    step program, its warm-up the first step; the others replay it).
    ``cpu_trainer``: the same trainer on the CPU (``build_trainer``'s if
    None). Returns the per-step losses, the largest differences and the
    readings."""
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.training import copy_state
    dev = trainer.device
    if cpu_trainer is None:
        cpu_trainer, _ = build_trainer("cpu")
    cstate = copy_state(state, "cpu")
    vocab = state.emb["fields"].capacity
    touched = np.unique(np.concatenate(
        [b["sparse"]["fields"].reshape(-1) for b in batches[:CHECK_STEPS]]))
    touched = touched[(touched >= 0) & (touched < vocab)]
    rng = np.random.RandomState(SEED + 4)
    cand = np.unique(rng.randint(0, vocab, 2 * UNTOUCHED_SAMPLE))
    cand = cand[~np.isin(cand, touched)]
    untouched = torch.from_numpy(
        cand[rng.permutation(cand.size)[:UNTOUCHED_SAMPLE]]).to(dev)
    if untouched.numel() != UNTOUCHED_SAMPLE:
        raise AssertionError(f"{what}: too few untouched ids sampled")
    initial = {n: [s.weights[untouched].clone()]
               + [v[untouched].clone() for v in s.slots.values()]
               for n, s in state.emb.items()}
    ids = torch.from_numpy(touched)
    before_rows = {n: {"weights": s.weights[ids.to(dev)].cpu(),
                       **{k: v[ids.to(dev)].cpu()
                          for k, v in s.slots.items()}}
                   for n, s in state.emb.items()}
    card, host = [], []
    before = gather_rows.launches
    for b in batches[:CHECK_STEPS]:
        state, m = trainer.train_step(state, b)
        card.append(m["loss"])
    torch.cuda.synchronize()
    if gather_rows.launches - before != 2 * CHECK_STEPS:
        raise AssertionError(f"{what}: {gather_rows.launches - before} "
                             f"K1 launches for {CHECK_STEPS} steps")
    for b in batches[:CHECK_STEPS]:
        cstate, m = cpu_trainer.train_step(cstate, b)
        host.append(float(m["loss"]))
    card = [float(x) for x in card]
    if not np.allclose(card, host, rtol=1e-4, atol=0):
        raise AssertionError(f"{what}: losses {card} on the card, {host} "
                             "on the CPU")
    seen = np.concatenate([b["sparse"]["fields"].reshape(-1)
                           for b in batches[:CHECK_STEPS]])
    seen, times = np.unique(seen, return_counts=True)
    cold = torch.from_numpy(np.isin(touched, seen[times == 1]))
    err, change, faults = {}, {}, {}
    for n, s in state.emb.items():
        cs = cstate.emb[n]
        err[n] = max([_close(f"{n} touched rows", s.weights[ids.to(dev)],
                             cs.weights[ids])]
                     + [_close(f"{n} slot {k}", v[ids.to(dev)],
                               cs.slots[k][ids])
                        for k, v in s.slots.items()])
        now = [s.weights[untouched]] + [v[untouched]
                                        for v in s.slots.values()]
        if not all(torch.equal(a, b) for a, b in zip(now, initial[n])):
            raise AssertionError(f"{what}: untouched rows of {n} changed")
        for k, v in [("weights", s.weights)] + list(s.slots.items()):
            got = v[ids.to(dev)].cpu()
            want = cs.weights[ids] if k == "weights" else cs.slots[k][ids]
            init = before_rows[n][k]
            reading = float(change_ratio(got, want, init).max())
            change[f"{n}/{k}"] = reading
            if not reading <= 1:
                raise AssertionError(
                    f"{what}: the change of {n} {k} differs between the "
                    f"card and the CPU ({reading:.3g} of its limit)")
            moved = (want != init).reshape(len(want), -1).any(1)
            if not moved.any():
                # a table the model does not read (DCN's ``:linear``): its
                # gradients are zero and no row may move on the card
                if not torch.equal(got, init):
                    raise AssertionError(f"{what}: rows of {n} {k}, which "
                                         "the model does not read, moved")
                faults[f"{n}/{k} unread"] = {"rows": 0}
                continue
            # the push skips cold rows: they keep their initial values
            faulted = torch.where(cold.reshape((-1,) + (1,) * (got.dim() - 1)),
                                  init, got)
            must = f"{n}/{k} cold rows skipped"
            faults[must] = _fault_reading(faulted, want, init, moved & cold)
            if k != "weights":
                # the push leaves the slot unchanged
                must = f"{n}/{k} unchanged"
                faults[must] = _fault_reading(init, want, init, moved)
            if not faults[must].get("change_max", 0) > 1:
                raise AssertionError(
                    f"{what}: the change check misses a simulated fault "
                    f"({must}): {json.dumps(faults[must])}")
    err["dense"] = max(
        [_close(f"parameter {k}", v, cstate.params[k])
         for k, v in state.params.items()]
        + [_close(f"accumulator {k}", v, cstate.opt_state[k])
           for k, v in state.opt_state.items()])
    return state, {"card_losses": card, "cpu_losses": host,
                   "touched_ids": int(touched.size),
                   "untouched_checked": UNTOUCHED_SAMPLE,
                   "max_abs_diff": err, "change_ratio_max": change,
                   "simulated_faults": faults}


def _init_agrees(what, got, want, kind, stddev) -> float:
    """A card draw (``got``) against the same draw on the CPU (``want``):
    exact for uniform and constant draws, normal and truncated ones within
    ``2^-21 * (|want| + stddev)`` (the card's ``log1pf``/``sqrtf`` against
    the host's), bfloat16 one unit more. Returns the largest difference."""
    from openembedding_tpu_torch.optim import initializers as ti
    got = got.detach().cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"init: {what} is {tuple(got.shape)} "
                             f"{got.dtype}, {tuple(want.shape)} "
                             f"{want.dtype} expected")
    diff = (got.float() - want.float()).abs()
    if kind in (ti.UNIFORM, ti.CONSTANT):
        ok = torch.equal(got, want)
    else:
        bound = 2.0**-21 * (want.float().abs() + stddev)
        if got.dtype == torch.bfloat16:
            bound = bound + 2.0**-7 * want.float().abs()
        ok = bool((diff <= bound).all())
    if not ok:
        raise AssertionError(f"init: {what} differs between the card and "
                             f"the CPU (max abs difference "
                             f"{float(diff.max())})")
    return float(diff.max()) if diff.numel() else 0.0


def _dense_init_agrees(card, cpu) -> float:
    """Every dense parameter of a card ``Trainer.init`` against the CPU's
    draw: lecun_normal kernels (truncated, ``stddev = sqrt(1 / fan_in) /
    0.8796``) within the ``erf_inv`` bound; glorot_uniform CIN and cross
    weights and zero biases exactly."""
    from openembedding_tpu_torch.optim import initializers as ti
    errs = [0.0]
    for k, v in cpu.items():
        if k.endswith(".weight"):
            std = float(np.sqrt(np.float32(1.0 / v.shape[1]))
                        / np.float32(0.87962566103423978))
            errs.append(_init_agrees(f"parameter {k}", card[k], v,
                                     ti.TRUNCATED, std))
        else:
            errs.append(_init_agrees(f"parameter {k}", card[k], v,
                                     ti.CONSTANT, 0.0))
    return max(errs)


def check_array_init_without_copy(trainer, state, batch,
                                  build=None) -> dict:
    """The card's ``Trainer.init(prng_key(SEED), batch)`` against the same
    state drawn on the CPU, nothing copied: the dense parameters
    (``init_params`` under the dense half of ``split(key)``), and each
    array table's first, a middle and its last ``INIT_ROWS`` rows (the
    plain flat draw from the table's key and those rows' flat offsets, in
    chunks; the whole 245 M-element ``fields`` would take minutes on the
    host). Returns the readings and the loss of a first step on ``batch``
    from the CPU's values (the rows of its ids drawn by the plain
    version), which the card's first step must match. ``build(device)``
    builds the trainer (``build_trainer`` if None)."""
    from openembedding_tpu_torch.models.deepctr import init_params
    from openembedding_tpu_torch.optim import initializers as ti
    coll = trainer.collection
    cpu_trainer, _ = (build or build_trainer)("cpu")
    emb_rng, dense_rng = ti.split(ti.prng_key(SEED))
    params = init_params(cpu_trainer.module, dense_rng, "cpu")
    placed = cpu_trainer.place_batch(batch)
    tables, rows = {}, {}
    for name, st in state.emb.items():
        init = coll.initializer(name)
        kind, prm = ti.keyed_params(init)
        stddev = getattr(init, "stddev", 1.0)
        key = coll.table_key(name, emb_rng)
        vocab, dim = st.weights.shape
        errs = []
        for r0 in (0, vocab // 2 - INIT_ROWS // 2, vocab - INIT_ROWS):
            want = ti.flat_rows(kind, prm, key, r0 * dim, INIT_ROWS * dim,
                                st.weights.dtype).reshape(INIT_ROWS, dim)
            errs.append(_init_agrees(f"{name} rows {r0}..",
                                     st.weights[r0:r0 + INIT_ROWS], want,
                                     kind, stddev))
        ids = placed["sparse"][name].to(torch.int64)
        rows[name] = ti.flat_draw(kind, prm, key,
                                  ids[..., None] * dim + torch.arange(dim),
                                  st.weights.dtype)
        tables[name] = {"rows_checked": 3 * INIT_ROWS,
                        "max_abs_diff": max(errs)}
    with torch.no_grad():
        loss = float(cpu_trainer.loss_fn(
            cpu_trainer._logits(params, placed["dense"], rows),
            placed["label"]))
    return {"dense_max_abs_diff": _dense_init_agrees(state.params, params),
            "tables": tables, "cpu_first_loss": loss}


def check_hash_init_without_copy(trainer, state, batch) -> dict:
    """The card's ``Trainer.init(prng_key(SEED), batch)`` against a CPU
    trainer's ``init`` from the same key, nothing copied: the dense
    parameters, and the hash tables' init keys and (empty) keys arrays;
    returns the readings and the CPU's first-step loss on ``batch``."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    cpu_trainer, _ = build_hash_trainer("cpu")
    cstate = cpu_trainer.init(prng_key(SEED), batch)
    dense = _dense_init_agrees(state.params, cstate.params)
    for n, cs in cstate.emb.items():
        s = state.emb[n]
        if s.init_rng != cs.init_rng or s.num_used() \
                or not torch.equal(s.keys.cpu(), cs.keys):
            raise AssertionError(f"init: hash table {n} differs between "
                                 "the card and the CPU")
    keys = {n: list(cs.init_rng) for n, cs in cstate.emb.items()}
    cstate, m = cpu_trainer.train_step(cstate, batch)
    return {"dense_max_abs_diff": dense, "init_rng": keys,
            "cpu_first_loss": float(m["loss"])}


def check_first_loss(what, reading: dict, card_loss: float) -> None:
    """The card's first-step loss from its own init against the CPU's
    from the CPU's own init: within ``INIT_LOSS_ATOL``."""
    reading["card_first_loss"] = card_loss
    if not abs(card_loss - reading["cpu_first_loss"]) <= INIT_LOSS_ATOL:
        raise AssertionError(
            f"{what}: first loss {card_loss} from the card's init, "
            f"{reading['cpu_first_loss']} from the CPU's")


def step_stages(trainer, state, batches) -> tuple:
    """The step's own split, ``observability.step_timings``, over a short
    window of captured steps on ``batches`` with the evaluate-performance
    gate on: the first step builds the armed program (its stage events
    inside the graph), the others replay it. Device ms a replay by stage
    (``pull_ms``, ``dense_ms``, ``push_ms``, ``push.<part>_ms``) and host
    ms a step by phase (``host_<phase>_ms``; the gate's every-batch scans
    land in ``host_stats_ms``). Returns ``(state, split)``."""
    from openembedding_tpu_torch.utils import observability
    before = observability.step_timings()
    observability.set_evaluate_performance(True)
    try:
        for b in batches:
            state, _ = trainer.train_step(state, b)
    finally:
        observability.set_evaluate_performance(False)
    after = observability.step_timings()
    out = {}
    for name, v in after["device"].items():
        was = before["device"].get(name, {"seconds": 0.0, "replays": 0})
        if v["replays"] > was["replays"]:
            out[f"{name}_ms"] = 1e3 * (v["seconds"] - was["seconds"]) \
                / (v["replays"] - was["replays"])
    calls = after["host"]["step"]["calls"] - before["host"]["step"]["calls"]
    for phase, v in after["host"].items():
        if calls:
            out[f"host_{phase}_ms"] = 1e3 * (
                v["seconds"] - before["host"][phase]["seconds"]) / calls
    return state, out


def _kernel_family(name: str):
    """The wrapper whose kernel a trace event named ``name`` is, or None."""
    for wrapper, kernels in KERNEL_NAMES.items():
        if any(f"::{k}<" in name or f"::{k}(" in name for k in kernels):
            return wrapper
    return None


def _idle_by_host(gaps, host):
    """Each idle gap of the device attributed to what the host was doing
    at its midpoint: the innermost host event (op, annotation or runtime
    call) open then, by name; summed microseconds, the 8 largest."""
    host = sorted(host)
    out, active, j = {}, [], 0
    for a, b in sorted(gaps):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [e for e in active if e[1] >= mid]
        name = min(active, key=lambda e: e[1] - e[0])[2] if active \
            else "(no host event)"
        out[name[:60]] = out.get(name[:60], 0.0) + (b - a)
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:8])


def replay_gate(replays: dict, recorded: dict, window: dict, steps: int,
                counted: dict) -> dict:
    """Hold each graph replay's kernels in a trace against the counters.

    ``replays`` maps a replay's correlation id to its launches of each
    wrapper's kernel found in the trace, ``recorded`` to its kernel
    records of any name; ``window`` holds each wrapper's kernels in the
    traced window, ``counted`` each wrapper's launches a step by its
    counter. Each replay whose kernels the profiler recorded holds each
    kernel as many times as the counters say a step launches it. Every
    replay of the step's graph runs the same nodes, so a replay with
    fewer kernel records than the fullest one lost records in the
    profiler (CUPTI drops activity records now and then): it is held
    only to that shortfall, no wrapper recorded more often than counted
    and the launches missing no more than the records missing, while
    the complete replays, at least one, must agree exactly. With no
    replay recorded, the window's kernels a step must agree. Raises
    AssertionError on a disagreement; returns what it counted."""
    full = max(recorded.values(), default=0)
    traced = [v for c, v in replays.items() if recorded[c] == full > 0] \
        or [{k: n / steps for k, n in window.items()}]
    partial = {c: v for c, v in replays.items() if 0 < recorded[c] < full}
    bad = [v for v in traced
           if {k: float(n) for k, n in v.items()} != counted]
    bad += [v for c, v in partial.items()
            if any(n > counted[k] for k, n in v.items())
            or sum(counted[k] - n for k, n in v.items())
            > full - recorded[c]]
    if bad:
        raise AssertionError(
            f"trace: kernel launches per replay {bad} in the trace "
            f"({len(replays)} graph launches, {len(traced)} with all "
            f"{full} kernel records), {counted} a step by the counters")
    return {"replays_with_kernels_recorded": sum(
                1 for n in recorded.values() if n),
            "replays_with_records_dropped": len(partial),
            "kernel_records_dropped": sum(full - recorded[c]
                                          for c in partial)}


def training_trace(trainer, state, batches, trace_path, lead,
                   steps: int = TRACE_STEPS) -> dict:
    """A ``torch.profiler`` trace of ``steps`` steps (``train_step``:
    replays of the captured step) inside an annotated window, after one
    lead-in step on ``lead`` (the profiler may miss the first kernels of
    its trace): the device's busy share of the window's wall time
    (kernels, copies and fills, their union), device operations and graph
    launches a step, the top 5 device operations by time, the longest
    idle gaps between device work and the idle time by what the host was
    doing, and each kernel wrapper's launches a step, from its counter
    and from the kernels of each replay in the trace (``replay_gate``
    holds them to each other)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = {"gather_rows": gather_rows, "probe_gather": probe_gather,
                "init_rows": init_rows}
    def ahead(i):
        # the pipelined schedule prefetches the next step's batch
        return {"next_batch": batches[i % len(batches)]} \
            if getattr(trainer, "_pipelined", ()) else {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, lead, **ahead(0))
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        with record_function(TRACE_WINDOW):
            t0 = time.perf_counter()
            for i in range(steps):
                state, _ = trainer.train_step(state,
                                              batches[i % len(batches)],
                                              **ahead(i + 1))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    counted = {k: (w.launches - before[k]) / steps
               for k, w in wrappers.items()}
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        whole = json.load(f).get("traceEvents", [])
    w0, w1 = next((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in whole if e.get("name") == TRACE_WINDOW
                  and e.get("cat") == "user_annotation")
    every = [e for e in whole if "ts" in e and w0 <= float(e["ts"]) <= w1]
    events = [e for e in every
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in every if e.get("cat") in (
                "cpu_op", "cuda_runtime", "cuda_driver")
            and "dur" in e]
    # a replay's kernels carry its cudaGraphLaunch's correlation id
    replays = {e.get("args", {}).get("correlation"):
               {k: 0 for k in wrappers}
               for e in every if e.get("cat") == "cuda_runtime"
               and e["name"] == "cudaGraphLaunch"}
    window = {k: 0 for k in wrappers}
    recorded = dict.fromkeys(replays, 0)
    by_name, spans = {}, []
    for e in events:
        dur = float(e.get("dur", 0.0))
        by_name[e["name"][:80]] = by_name.get(e["name"][:80], 0.0) + dur
        spans.append((float(e["ts"]), float(e["ts"]) + dur))
        if e["cat"] != "kernel":
            continue
        family = _kernel_family(e["name"])
        if family:
            window[family] += 1
    # a replay's kernels are found by correlation, not by their device
    # timestamps: the device clock, mapped onto the host's, can place the
    # first replay's first kernels a little before the window opens
    for e in whole:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") == "kernel" and corr in replays:
            recorded[corr] += 1
            family = _kernel_family(e["name"])
            if family:
                replays[corr][family] += 1
    spans.sort()
    busy, gaps, end = 0.0, [], None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    gate = replay_gate(replays, recorded, window, steps, counted)
    kernels = sum(1 for e in events if e["cat"] == "kernel")
    return {"steps": steps, "wall_us": wall_us,
            "device_busy_us": busy,
            "device_busy_share": busy / wall_us if spans else None,
            "kernels_per_step": kernels / steps,
            "device_ops_per_step": len(events) / steps,
            "graph_launches_per_step": len(replays) / steps,
            **gate,
            "kernels_per_replay": statistics.mean(recorded.values())
            if recorded else None,
            "traced_launches_per_step": {k: n / steps
                                         for k, n in window.items()},
            "launches_per_step": counted,
            "top5_us": dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:5]),
            "longest_idle_gaps_us": sorted((b - a for a, b in gaps),
                                           reverse=True)[:5],
            "idle_gaps_per_step": len(gaps) / steps,
            "idle_us_by_host": _idle_by_host(gaps, host)}


def state_tensors(state) -> list:
    """Every tensor of a train state: step, dense state, each table's
    weights and slots (a hash table's keys and failure count too, a
    plane's replica or residual), and the pipelined schedule's prefetched
    rows."""
    import dataclasses

    def walk(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if dataclasses.is_dataclass(x):
            return [t for f in dataclasses.fields(x)
                    for t in walk(getattr(x, f.name))]
        if isinstance(x, dict):
            return [t for v in x.values() for t in walk(v)]
        return []
    return walk(state)


def _spread(a, b) -> dict:
    """How two runs' results differ: tensors and elements that differ and
    the largest absolute difference (0 for bit-identical runs)."""
    tensors, elements, worst = 0, 0, 0.0
    for x, y in zip(a, b):
        if torch.equal(x, y):
            continue
        tensors += 1
        ne = x != y
        elements += int(ne.sum())
        if x.is_floating_point():
            worst = max(worst, float((x[ne].double() - y[ne].double())
                                     .abs().max()))
    return {"tensors": tensors, "elements": elements, "max_abs": worst}


def captured_against_eager(what, trainer, state, batches,
                           deterministic: bool = False,
                           reset=None, steps: int = 0) -> dict:
    """The captured step's oracle: ``ORACLE_STEPS`` (or ``steps``)
    captured steps
    (``train_step`` on a copy of ``state``, which builds its own program)
    against as many eager ones (``train_step_eager`` on another copy),
    bit for bit: losses, dense parameters and accumulators, table rows
    and slots, and a hash table's keys and failure count. The push sums
    float gradients with ``index_add_``, atomics on the card, so two eager
    runs go first: if they differ, both sides run under
    ``torch.use_deterministic_algorithms(True)``; if an op of the step
    refuses that mode, the two are held at the eager runs' spread and the
    op is named; ``deterministic`` runs both sides in that mode without
    the eager runs (two eager runs may agree by chance where a replay's
    atomics add in another order), and a refusal raises; ``reset``, when
    given, runs
    before each run (to start the trainer's host state, a replica's
    sketch and refresh clock, where the first run started it). The
    kernel launches of these runs are not counted as the main path's:
    the counters are put back."""
    from openembedding_tpu_torch.ops.find_or_insert import find_or_insert
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.training import copy_state
    wrappers = (gather_rows, probe_gather, init_rows, find_or_insert)
    counted = [w.launches for w in wrappers]

    def run(step):
        if reset is not None:
            reset()
        s = copy_state(state, trainer.device)
        losses = []
        for b in batches[:steps or ORACLE_STEPS]:
            s, m = step(s, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return [torch.stack(losses)] + state_tensors(s)
    first = spread = None
    if not deterministic:
        first = run(trainer.train_step_eager)
        spread = _spread(first, run(trainer.train_step_eager))
        deterministic = spread["tensors"] > 0
    refused = None
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        try:
            captured = run(trainer.train_step)
            eager = run(trainer.train_step_eager)
        except RuntimeError as e:
            if first is None or not deterministic \
                    or "deterministic" not in str(e):
                raise
            refused = str(e).splitlines()[0][:300]
            torch.use_deterministic_algorithms(False)
            captured, eager = run(trainer.train_step), first
    finally:
        torch.use_deterministic_algorithms(False)
        for w, n in zip(wrappers, counted):
            w.launches = n
    diff = _spread(captured, eager)
    ok = diff["tensors"] == 0 if refused is None \
        else diff["max_abs"] <= spread["max_abs"]
    reading = {"steps": steps or ORACLE_STEPS, "eager_vs_eager": spread,
               "deterministic_mode": deterministic, "refused_by": refused,
               "captured_vs_eager": diff,
               "bit_identical": diff["tensors"] == 0}
    if not ok:
        raise AssertionError(f"{what}: captured steps differ from eager "
                             f"steps: {json.dumps(reading)}")
    return reading


def _block(trainer, state, step, batches, batch_size, table, nexts=None):
    """One timed block: ``step`` over ``batches`` (each with its
    lookahead from ``nexts``, an iterator, when given), ended by a
    synchronize; returns the state, the last metrics, examples/s and the
    keys ``table`` (a hash table's name, or None) gained a step."""
    used = state.emb[table].num_used() if table else 0
    t0 = time.perf_counter()
    for b in batches:
        state, m = step(state, b) if nexts is None \
            else step(state, b, next_batch=next(nexts))
    torch.cuda.synchronize()
    eps = len(batches) * batch_size / (time.perf_counter() - t0)
    gained = (state.emb[table].num_used() - used) / len(batches) \
        if table else None
    return state, m, eps, gained


def compare_steps(trainer, state, batch_of, batch_size, table=None,
                  num_blocks=BLOCKS, lookahead=False,
                  block_steps=BLOCK_STEPS):
    """Throughput of the captured step (``train_step``, replays) and of the
    eager one (``train_step_eager``) on one state: ``WARMUP_STEPS`` of
    each, then ``num_blocks`` timed blocks of ``block_steps`` steps of
    each, in turns (the order flips every block). ``batch_of(kind, k, i)`` is
    step ``i`` of block ``k``; with ``lookahead`` every step is given the
    batch of the step after it as ``next_batch`` (the pipelined schedule
    prefetches it; the last step the first's), so the prefetch never
    misses. Returns the state, the last metrics and per kind the median
    block's examples/s (min, max), its step time and, for a hash table,
    the keys inserted a step and their share of a step's keys; and the
    step programs built meanwhile (``recaptures``)."""
    steps = {"captured": trainer.train_step,
             "eager": trainer.train_step_eager}
    order = [(kind, [batch_of(kind, 0, i) for i in range(WARMUP_STEPS)])
             for kind in steps]
    for k in range(num_blocks):
        for kind in (list(steps) if k % 2 == 0 else list(steps)[::-1]):
            order.append((kind, [batch_of(kind, k, i)
                                 for i in range(block_steps)]))
    flat = [b for _, run in order for b in run]
    nexts = iter(flat[1:] + flat[:1]) if lookahead else None
    builds = trainer.builds
    for kind, run in order[:2]:
        for b in run:
            state, m = steps[kind](state, b) if nexts is None \
                else steps[kind](state, b, next_batch=next(nexts))
    torch.cuda.synchronize()
    blocks = {kind: [] for kind in steps}
    gained = {kind: [] for kind in steps}
    for kind, run in order[2:]:
        state, m, eps, g = _block(trainer, state, steps[kind], run,
                                  batch_size, table, nexts)
        blocks[kind].append(eps)
        gained[kind].append(g)
    out = {}
    for kind, eps in blocks.items():
        med = statistics.median(eps)
        out[kind] = {"examples_per_s": med, "eps_min": min(eps),
                     "eps_max": max(eps), "block_eps": eps,
                     "step_ms": batch_size / med * 1e3}
        if table:
            keys = int(np.prod(batch_of(kind, 0, 0)["sparse"][table]
                               .shape[:-1]))
            out[kind]["inserted_per_step"] = gained[kind]
            out[kind]["inserted_share"] = \
                statistics.mean(gained[kind]) / keys
    out["captured_over_eager"] = out["captured"]["examples_per_s"] \
        / out["eager"]["examples_per_s"]
    out["recaptures"] = trainer.builds - builds
    return state, m, out


STATS_BLOCKS, STATS_STEPS = 6, 100


def batch_stats_cost(trainer, state, batches):
    """The captured step with the batch-shape stats ``train_step``
    records (the always-on ``_last`` gauges: one ``np.unique`` a table a
    second) against the same step with the recorder stubbed out:
    ``STATS_BLOCKS`` blocks of ``STATS_STEPS`` steps each way, in turns;
    the median block's step ms. Also one forced scan of a batch (the
    throttle cleared), the cost the gauges pay once a second."""
    from openembedding_tpu_torch.utils import observability as obs
    real = obs.record_batch_stats
    ms = {"on": [], "off": []}
    try:
        for k in range(STATS_BLOCKS):
            for kind in (("on", "off") if k % 2 == 0 else ("off", "on")):
                obs.record_batch_stats = real if kind == "on" \
                    else (lambda *a, **kw: None)
                t0 = time.perf_counter()
                for i in range(STATS_STEPS):
                    state, _ = trainer.train_step(
                        state, batches[i % len(batches)])
                torch.cuda.synchronize()
                ms[kind].append((time.perf_counter() - t0)
                                / STATS_STEPS * 1e3)
    finally:
        obs.record_batch_stats = real
    obs._BATCH_GAUGE_LAST.clear()
    t0 = time.perf_counter()
    real({k: np.asarray(v) for k, v in batches[0]["sparse"].items()})
    scan_ms = (time.perf_counter() - t0) * 1e3
    on, off = statistics.median(ms["on"]), statistics.median(ms["off"])
    return state, {"step_ms_on": on, "step_ms_off": off,
                   "on_over_off": on / off, "blocks_on_ms": ms["on"],
                   "blocks_off_ms": ms["off"], "forced_scan_ms": scan_ms}


def program_reading(trainer, reserved_before: int) -> dict:
    """The trainer's step programs: builds, each build's seconds (its
    warm-up step and capture) and the memory its capture reserved, and
    the device memory reserved since ``reserved_before``."""
    dev = trainer.device
    programs = list(trainer.programs.values())
    return {"builds": trainer.builds,
            "build_s": [p.build_s for p in programs],
            "capture_pool_bytes": [p.pool_bytes for p in programs],
            "reserved_delta_bytes":
                torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
                - reserved_before}


def train_then_serve(trainer, state, batch) -> dict:
    """Save the trained tables, load them through ``POST /models`` of a
    ``ControllerServer`` and look one trained batch up on both tables:
    the rows must equal the trainer's exactly."""
    from openembedding_tpu_torch import checkpoint
    from openembedding_tpu_torch.serving.rest import ControllerServer
    ckpt_dir = os.path.join(ROOT, "_smoke_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    server = None
    try:
        saved = checkpoint.save_checkpoint(
            ckpt_dir, trainer.collection, state.emb,
            model_sign=trainer.model_sign(state))
        server = ControllerServer(port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": ckpt_dir, "block": True}).encode())
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        ids = batch["sparse"]["fields"]
        dev_ids = torch.from_numpy(ids.reshape(-1)).to(trainer.device)
        for var in ("fields", "fields:linear"):
            rows, _ = lookup_bin(conn, sign, var, ids)
            want = state.emb[var].weights[dev_ids.long()].reshape(
                ids.shape + (-1,)).cpu().numpy()
            if not np.array_equal(rows, want):
                raise AssertionError(f"served {var} rows differ from the "
                                     "trained table")
        conn.close()
        return {"model_sign": sign, "save_s": saved["seconds"],
                "save_bytes": saved["bytes"], "served_exact": True}
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_training() -> int:
    """Phase 7; returns K1's launches on the training path, KI's array
    launches in the trainer's init and KI's array-mode cases."""
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat
    from openembedding_tpu_torch.optim.initializers import prng_key
    trainer, mapper = build_trainer("cuda")
    dev = trainer.device
    batches = [mapper.fuse_batch(b) for b in synthetic_criteo(
        BATCH, num_buckets=VOCAB_PER_FEATURE, seed=SEED,
        num_batches=TRAIN_BATCHES)]
    init_flat.launches = 0
    t0 = time.perf_counter()
    state = trainer.init(prng_key(SEED), batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat_launches = init_flat.launches
    check_init_launches("training", state, flat_launches)
    nocopy = check_array_init_without_copy(trainer, state, batches[0])
    gather_rows.launches = 0
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    state, check = check_against_cpu(trainer, state, batches)
    program = program_reading(trainer, reserved)
    check_first_loss("training", nocopy, check["card_losses"][0])
    oracle = captured_against_eager("training", trainer, state, batches)
    state, m, speed = compare_steps(
        trainer, state, lambda kind, k, i: batches[i % TRAIN_BATCHES], BATCH)
    trace_path = os.path.join(ROOT, "_smoke_train_trace.json")
    try:
        trace = training_trace(trainer, state, batches, trace_path,
                               batches[-1])
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    steps = CHECK_STEPS + 2 * (WARMUP_STEPS + BLOCKS * BLOCK_STEPS) \
        + 1 + TRACE_STEPS
    launches = gather_rows.launches
    if launches != 2 * steps:
        raise AssertionError(f"training: {launches} K1 launches for {steps} "
                             "steps, 2 a step expected")
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"training: loss {loss}")
    state, stages = step_stages(trainer, state, batches[:STAGE_STEPS])
    before = gather_rows.launches
    state, stats_cost = batch_stats_cost(trainer, state, batches)
    launches += gather_rows.launches - before
    served = train_then_serve(trainer, state, batches[1])
    flat_cases = phase_ki_flat(trainer)
    log(json.dumps({"training": {
        "config": "deepfm_dim9", "batch": BATCH, "init_s": init_s,
        "init_without_copy": nocopy, "init_flat_launches": flat_launches,
        "check": check, "program": program, "captured_vs_eager": oracle,
        "steps": steps, "k1_launches": launches,
        "examples_per_s": speed["captured"]["examples_per_s"],
        "step_ms": speed["captured"]["step_ms"],
        "eager_examples_per_s": speed["eager"]["examples_per_s"],
        "eager_step_ms": speed["eager"]["step_ms"], "speed": speed,
        "last_loss": loss, "stages": stages, "trace": trace,
        "batch_stats_cost": stats_cost, "serve": served,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}}))
    return launches, flat_launches, flat_cases


def check_init_launches(what, state, launches: int) -> None:
    """A trainer's init on the card launches KI's array mode once for each
    array table and each dense kernel (every array below 2^30 elements)."""
    from openembedding_tpu_torch.table import TableState
    want = sum(type(s) is TableState for s in state.emb.values()) \
        + sum(v.dim() == 2 for v in state.params.values())
    if launches != want:
        raise AssertionError(f"{what}: {launches} KI array launches in the "
                             f"trainer's init, {want} expected")


# --- phase 8: hash training --------------------------------------------------

def build_hash_trainer(device):
    """The ``deepfm_dim9_hash`` trainer of ``bench.py``: the 26 features
    fused into one wide-key hash table of ``HASH_CAPACITY`` slots, dim 9,
    and its dim-1 ``:linear`` twin, sparse Adagrad (lr 0.01), ``DeepFM``
    with ``dnn_units=(256, 128)`` and dense optax-form Adagrad (lr 0.01),
    on ``device``, tables empty."""
    from openembedding_tpu_torch.data.criteo import NUM_DENSE, SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import build_model
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    specs, mapper = make_fused_specs(
        SPARSE_NAMES, -1, 9, hash_capacity=HASH_CAPACITY,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    module = build_model("deepfm", SPARSE_NAMES, embedding_dim=9,
                         num_dense=NUM_DENSE, dnn_units=(256, 128))
    return Trainer(module, EmbeddingCollection(specs, device=device,
                                               seed=SEED),
                   dense.adagrad(0.01)), mapper


def _live_keys64(state) -> np.ndarray:
    """The int64 keys a CPU hash table holds, in slot order."""
    from openembedding_tpu_torch.hash_table import join64
    return join64(state.keys[state.live()].numpy())


def check_hash_against_cpu(trainer, state, batches):
    """``CHECK_STEPS`` card steps from empty tables against the same steps
    of a CPU trainer from a copy of the initial state: the keys arrays and
    insert-failure counts bit-identical, losses within rtol 1e-4, every
    stored key's row and slots within atol 1e-5 + rtol 1e-4 and its change
    (value minus the key's init row, or the slot's initial value) held to
    the CPU's by ``change_ratio``, shown to flag the simulated push faults;
    free slots still zero; K2 launched twice a step and KI four times."""
    from openembedding_tpu_torch import hash_table as hash_lib
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.training import copy_state
    dev = trainer.device
    cpu_trainer, _ = build_hash_trainer("cpu")
    cstate = copy_state(state, "cpu")
    initial = copy_state(state, "cpu")
    k2, ki = probe_gather.launches, init_rows.launches
    card, host = [], []
    for b in batches[:CHECK_STEPS]:
        state, m = trainer.train_step(state, b)
        card.append(m["loss"])
    torch.cuda.synchronize()
    launched = (probe_gather.launches - k2, init_rows.launches - ki)
    if launched != (2 * CHECK_STEPS, 4 * CHECK_STEPS):
        raise AssertionError(f"hash training: K2 and KI launched {launched} "
                             f"times in {CHECK_STEPS} steps")
    for b in batches[:CHECK_STEPS]:
        cstate, m = cpu_trainer.train_step(cstate, b)
        host.append(float(m["loss"]))
    card = [float(x) for x in card]
    if not np.allclose(card, host, rtol=1e-4, atol=0):
        raise AssertionError(f"hash training: losses {card} on the card, "
                             f"{host} on the CPU")
    seen = np.concatenate([hash_lib.join64(b["sparse"]["fields"]).reshape(-1)
                           for b in batches[:CHECK_STEPS]])
    seen, times = np.unique(seen, return_counts=True)
    err, change, faults, tables = {}, {}, {}, {}
    for n, s in state.emb.items():
        cs = cstate.emb[n]
        if not torch.equal(s.keys.cpu(), cs.keys) \
                or int(s.insert_failures) != int(cs.insert_failures):
            raise AssertionError(f"hash training: the keys of {n} differ "
                                 "between the card and the CPU")
        live = cs.live()
        idx = torch.nonzero(live).reshape(-1)
        free = ~live.to(dev)
        if int(torch.count_nonzero(s.weights[free])):
            raise AssertionError(f"hash training: free slots of {n} hold "
                                 "nonzero rows")
        cold = torch.from_numpy(np.isin(_live_keys64(cs),
                                        seen[times == 1]))
        init_w = hash_lib.init_rows(trainer.collection.initializer(n),
                                    cs.init_rng, cs.keys[idx], cs.dim,
                                    cs.weights.dtype)
        fields = [("weights", s.weights, cs.weights, init_w)] + [
            (k, v, cs.slots[k], initial.emb[n].slots[k][idx])
            for k, v in s.slots.items()]
        errs = []
        for k, v, cv, init in fields:
            got, want = v[idx.to(dev)].cpu(), cv[idx]
            errs.append(_close(f"{n} {k} of stored keys", got, want))
            reading = float(change_ratio(got, want, init).max())
            change[f"{n}/{k}"] = reading
            if not reading <= 1:
                raise AssertionError(
                    f"hash training: the change of {n} {k} differs between "
                    f"the card and the CPU ({reading:.3g} of its limit)")
            moved = (want != init).reshape(len(want), -1).any(1)
            # the push skips cold keys' rows: they keep their init values
            faulted = torch.where(cold.reshape((-1,) + (1,) * (got.dim() - 1)),
                                  init, got)
            must = f"{n}/{k} cold rows skipped"
            faults[must] = _fault_reading(faulted, want, init, moved & cold)
            if k != "weights":
                must = f"{n}/{k} unchanged"
                faults[must] = _fault_reading(init, want, init, moved)
            if not faults[must].get("change_max", 0) > 1:
                raise AssertionError(
                    f"hash training: the change check misses a simulated "
                    f"fault ({must}): {json.dumps(faults[must])}")
        err[n] = max(errs)
        tables[n] = {"keys": int(idx.numel()),
                     "insert_failures": int(cs.insert_failures),
                     "cold_keys": int(cold.sum())}
    err["dense"] = max(
        [_close(f"parameter {k}", v, cstate.params[k])
         for k, v in state.params.items()]
        + [_close(f"accumulator {k}", v, cstate.opt_state[k])
           for k, v in state.opt_state.items()])
    return state, {"card_losses": card, "cpu_losses": host,
                   "keys_bit_identical": True, "tables": tables,
                   "max_abs_diff": err, "change_ratio_max": change,
                   "simulated_faults": faults}


def ki_bound(keys: torch.Tensor, skip: torch.Tensor, dim: int,
             word_bytes: int, draw: str):
    """KI's least time on this input: the larger of the bytes it must move
    (the skip flags, the keys and rows of the rows it fills) over
    ``HBM_BYTES_PER_S`` and the operations of those rows over
    ``LANE_OPS_PER_S``: a key's fold_ins (two threefry blocks for a pair
    key, one for an int32 key), and for each element its block and
    ``DRAW_OPS[draw]``; none for a constant. Returns
    ``(bound_ms, bound_by)``."""
    n = int(keys.shape[0])
    fill = n - int(skip.sum())
    constant = draw == "constant"
    key_bytes = 0 if constant else fill * keys.element_size() * (
        keys.numel() // max(n, 1))
    data = n + key_bytes + fill * dim * word_bytes
    folds = 2 if keys.dim() == 2 else 1
    ops = 0 if constant else fill * (
        folds * THREEFRY_OPS + dim * (THREEFRY_OPS + DRAW_OPS[draw]))
    t_bytes, t_ops = data / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_ki_case(name, keys, skip, dim, dtype, cfg, flush,
                  base=(0x12345678, 0x9ABCDEF0)):
    """KI against its plain version on the card on one case (exact for
    uniform and constant draws, normal ones within
    ``2^-21 * (|want| + stddev)``, bfloat16 one unit more), timed beside
    the plain version and the bound. ``base``: the key words, or a
    ``[2]`` int32 device tensor of them (an offload cache's)."""
    from openembedding_tpu_torch.ops.init_rows import (init_rows,
                                                       init_rows_reference)
    from openembedding_tpu_torch.optim import initializers as ti
    init = ti.make_initializer(cfg)
    kind, params = ti.keyed_params(init)
    out = torch.full((keys.shape[0], dim), 3.0, dtype=dtype,
                     device=keys.device)
    ref = out.clone()
    init_rows(out, keys, skip, base, init)
    init_rows_reference(ref, keys, skip, base, kind, params)
    torch.cuda.synchronize()
    got, want = out.float(), ref.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if kind in (ti.UNIFORM, ti.CONSTANT):
        ok = torch.equal(out, ref)
    else:
        bound = 2.0**-21 * (want.abs() + cfg.get("stddev", 1.0))
        if dtype == torch.bfloat16:
            bound = bound + 2.0**-7 * want.abs()
        ok = bool(((got - want).abs() <= bound).all())
    if not ok or not bool((out[skip] == 3.0).all()):
        raise AssertionError(f"init_rows != reference on case {name} "
                             f"(max abs difference {err})")
    draw = ("constant", "uniform", "normal", "truncated")[kind]
    bound_ms, bound_by = ki_bound(keys, skip, dim, out.element_size(), draw)
    return {"case": name, "n": int(keys.shape[0]), "dim": dim,
            "dtype": str(dtype).replace("torch.", ""),
            "keys": "pairs" if keys.dim() == 2
            else str(keys.dtype).replace("torch.", ""),
            "base": "device" if isinstance(base, torch.Tensor) else "host",
            "draw": cfg["category"] + ("/truncated" if cfg.get("truncated")
                                       else ""),
            "filled": int(keys.shape[0] - int(skip.sum())),
            "max_abs_err": err,
            "kernel_ms": _median_ms(
                lambda: init_rows(out, keys, skip, base, init), flush),
            "kernel_call_ms": _call_ms(
                lambda: init_rows(out, keys, skip, base, init)),
            "plain_ms": _median_ms(lambda: init_rows_reference(
                ref, keys, skip, base, kind, params), flush),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_ki_kernels(trainer, state, batch):
    """KI held against its plain version on the card: the main path's two
    pulls of a batch the table has not seen (its own skip flags, the
    ``fields`` normal and ``:linear`` constant draws), the same keys all
    missing, every draw at the main-path shape, and the edges (n = 1,
    EMPTY and negative keys, bfloat16 rows, int32 keys). The launches made
    here (KI's, and K2's that finds the batch's hits) are not counted as
    the main path's."""
    from openembedding_tpu_torch import hash_table as hash_lib
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    dev = trainer.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    counted = init_rows.launches, probe_gather.launches
    keys = trainer.collection.to_device("fields", batch["sparse"]["fields"])
    keys = keys.reshape(-1, 2).contiguous()
    st = state.emb["fields"]
    bsz, _, chain = hash_lib.table_layout(st.capacity,
                                          hash_lib.DEFAULT_MAX_PROBES)
    _, hit = hash_lib.probe_gather(st.keys, st.weights, keys, chain=chain,
                                   bucket=bsz, empty=EMPTY32)
    invalid = keys[:, 1] == EMPTY32
    skip = hit | invalid
    coll = trainer.collection
    cfg9 = coll.initializer("fields").to_config()
    cfg1 = coll.initializer("fields:linear").to_config()
    rng = np.random.RandomState(SEED + 5)
    odd = torch.from_numpy(rng.randint(-2**31, 2**31, (4099, 2),
                                       dtype=np.int64).astype(np.int32))
    odd[::5, 1] = EMPTY32
    odd = odd.to(dev)
    odd_skip = odd[:, 1] == EMPTY32
    narrow = keys[:, 0].contiguous()
    f32, bf16 = torch.float32, torch.bfloat16
    uniform = {"category": "uniform", "minval": -1e-3, "maxval": 1e-3}
    trunc = {"category": "normal", "truncated": True, "stddev": 0.5,
             "mean": 0.1}
    cases = [
        check_ki_case("pull_fields_dim9_normal", keys, skip, 9, f32, cfg9,
                      flush),
        check_ki_case("pull_linear_dim1_constant", keys, skip, 1, f32, cfg1,
                      flush),
        check_ki_case("all_missing_fields_dim9_normal", keys, invalid, 9,
                      f32, cfg9, flush),
        check_ki_case("all_missing_dim9_uniform", keys, invalid, 9, f32,
                      uniform, flush),
        check_ki_case("all_missing_dim9_truncated", keys, invalid, 9, f32,
                      trunc, flush),
        check_ki_case("all_missing_dim1_normal", keys, invalid, 1, f32,
                      cfg9, flush),
        check_ki_case("bf16_dim9_normal", keys, invalid, 9, bf16, cfg9,
                      flush),
        check_ki_case("bf16_dim9_uniform", keys, invalid, 9, bf16, uniform,
                      flush),
        check_ki_case("int32_keys_dim9_normal", narrow, narrow == EMPTY32,
                      9, f32, cfg9, flush),
        check_ki_case("int32_keys_dim9_uniform", narrow, narrow == EMPTY32,
                      9, f32, uniform, flush),
        check_ki_case("n1", keys[:1], invalid[:1], 9, f32, cfg9, flush),
        check_ki_case("empty_and_negative_keys_dim9_uniform", odd, odd_skip,
                      9, f32, uniform, flush),
        check_ki_case("empty_and_negative_keys_dim1_truncated", odd,
                      odd_skip, 1, f32, trunc, flush),
    ]
    init_rows.launches, probe_gather.launches = counted
    log(json.dumps({"init_rows_cases": cases}))
    return cases


def ki_flat_bound(count: int, word_bytes: int, draw: str):
    """KI array mode's least time for ``count`` elements: the larger of the
    bytes it writes over ``HBM_BYTES_PER_S`` and each element's threefry
    block and ``DRAW_OPS[draw]`` over ``LANE_OPS_PER_S`` (none for a
    constant). Returns ``(bound_ms, bound_by)``."""
    ops = 0 if draw == "constant" else count * (THREEFRY_OPS
                                                + DRAW_OPS[draw])
    t_bytes, t_ops = count * word_bytes / HBM_BYTES_PER_S, \
        ops / LANE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_ki_flat_case(name, shape, dtype, cfg, key, flush, offset=0,
                       ranges=None, plain_reps=REPS):
    """KI's array mode against its plain version on the card: an array of
    ``shape`` drawn from ``key`` at flat ``offset`` in one launch; the
    plain version draws the whole array, or only the row ranges
    ``ranges`` (from their flat offsets, in chunks); exact for uniform and
    constant draws, normal ones within ``2^-21 * (|want| + stddev)``.
    Timed beside the plain version over the whole array and the bound."""
    from openembedding_tpu_torch.ops.init_rows import (init_flat,
                                                       init_flat_reference)
    from openembedding_tpu_torch.optim import initializers as ti
    init = ti.make_initializer(cfg)
    kind, prm = ti.keyed_params(init)
    out = torch.empty(shape, dtype=dtype, device=flush.device)
    init_flat(out, key, offset, init)
    torch.cuda.synchronize()
    dim = shape[-1]
    rows = out.view(-1, dim)
    err = 0.0
    for r0, r1 in ranges or [(0, rows.shape[0])]:
        want = ti.flat_rows(kind, prm, key, offset + r0 * dim,
                            (r1 - r0) * dim, dtype, out.device)
        err = max(err, _init_agrees(
            f"array case {name} rows {r0}..{r1}", rows[r0:r1],
            want.reshape(r1 - r0, dim).cpu(), kind,
            getattr(init, "stddev", 1.0)))
    draw = ("constant", "uniform", "normal", "truncated")[kind]
    bound_ms, bound_by = ki_flat_bound(out.numel(), out.element_size(),
                                       draw)
    ref = torch.empty_like(out)
    many = out.numel() > 1 << 24
    case = {"case": name, "shape": list(shape), "offset": offset,
            "dtype": str(dtype).replace("torch.", ""),
            "draw": cfg["category"] + ("/truncated" if cfg.get("truncated")
                                       else ""),
            "elements_checked": sum((r1 - r0) * dim for r0, r1
                                    in ranges or [(0, rows.shape[0])]),
            "max_abs_err": err,
            "kernel_ms": _median_ms(
                lambda: init_flat(out, key, offset, init), flush),
            "kernel_call_ms": _call_ms(
                lambda: init_flat(out, key, offset, init),
                calls=10 if many else 100),
            "plain_ms": _median_ms(lambda: init_flat_reference(
                ref, key, offset, kind, prm), flush, reps=plain_reps,
                warm=1),
            "bound_ms": bound_ms, "bound_by": bound_by}
    del out, ref
    return case


def phase_ki_flat(trainer):
    """KI's array mode held against its plain version on the card, on the
    draws of the ``deepfm_dim9`` trainer's init under ``prng_key(SEED)``:
    the whole ``fields`` table (27,262,976 x 9 normal(0, 1e-4), one
    launch; the plain version checks its first, a middle and its last
    ``INIT_ROWS`` rows), those three ranges drawn alone from their
    offsets, the whole ``fields:linear`` (constant), a ``[4096, 9]``
    table, a bfloat16 one and the first dense kernel (``[247, 256]``
    truncated, flax's key). The launches made here are not counted as the
    main path's."""
    from openembedding_tpu_torch.interop import flax_path
    from openembedding_tpu_torch.ops.init_rows import init_flat
    from openembedding_tpu_torch.optim import initializers as ti
    dev = trainer.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    counted = init_flat.launches
    coll = trainer.collection
    emb_rng, dense_rng = ti.split(ti.prng_key(SEED))
    fkey = coll.table_key("fields", emb_rng)
    cfg9 = coll.initializer("fields").to_config()
    cfg1 = coll.initializer("fields:linear").to_config()
    vocab = coll.specs["fields"].input_dim
    mid = vocab // 2 - INIT_ROWS // 2
    ranges = [(0, INIT_ROWS), (mid, mid + INIT_ROWS),
              (vocab - INIT_ROWS, vocab)]
    name = "MLP_0.Dense_0.weight"
    fan_out, fan_in = dict(trainer.module.named_parameters())[name].shape
    dkey = ti.flax_param_key(dense_rng, flax_path(name)[:-1], 1)
    lecun = {"category": "normal", "truncated": True, "stddev": float(
        np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978))}
    uniform = {"category": "uniform", "minval": -1e-3, "maxval": 1e-3}
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [check_ki_flat_case("fields_whole_normal", (vocab, 9), f32,
                                cfg9, fkey, flush, ranges=ranges,
                                plain_reps=3)]
    cases += [check_ki_flat_case(f"fields_rows_{where}_normal",
                                 (INIT_ROWS, 9), f32, cfg9, fkey, flush,
                                 offset=r0 * 9)
              for where, (r0, _) in zip(("first", "middle", "last"),
                                        ranges)]
    cases += [
        check_ki_flat_case("linear_whole_constant", (vocab, 1), f32, cfg1,
                           coll.table_key("fields:linear", emb_rng), flush,
                           ranges=ranges, plain_reps=3),
        check_ki_flat_case("table_4096x9_normal", (4096, 9), f32, cfg9,
                           fkey, flush),
        check_ki_flat_case("table_4096x9_bf16_uniform", (4096, 9), bf16,
                           uniform, fkey, flush),
        check_ki_flat_case("dense_mlp0_kernel_truncated", (fan_in, fan_out),
                           f32, lecun, dkey, flush),
    ]
    init_flat.launches = counted
    log(json.dumps({"init_flat_cases": cases}))
    return cases


def push_stages(trainer, state, batches) -> dict:
    """The push of both tables split into its three stages, on batches the
    tables have not seen: for each batch its gradients (untimed), then
    dedup and combine, ``find_or_insert`` (which inserts the batch's new
    keys) and the update (gather, init rows, optimizer, scatter), each
    timed alone on the host's clock and ended by a synchronize. Medians
    over the batches after the first, a warm-up; ``push_ms`` is the median
    of the three stages' sum, ``push_inserted_keys`` of the ``fields``
    keys inserted a batch."""
    from openembedding_tpu_torch import hash_table as hash_lib
    coll = trainer.collection
    times = {"push_dedup_ms": [], "push_insert_ms": [],
             "push_update_ms": [], "push_ms": []}
    inserted = []
    for b in batches:
        placed = trainer.place_batch(b)
        rows = coll.pull(state.emb, placed["sparse"])
        _, grads = trainer.dense_step(state, placed, rows)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ded = {n: hash_lib.push_dedup(state.emb[n], placed["sparse"][n],
                                      grads[n]) for n in grads}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ins = {n: hash_lib.find_or_insert(state.emb[n].keys, ded[n][0],
                                          ded[n][1]) for n in grads}
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for n in grads:
            uniq, valid, summed, counts = ded[n]
            hash_lib.push_update(state.emb[n], coll.optimizer(n),
                                 coll.initializer(n), uniq, valid, summed,
                                 counts, ins[n][1], ins[n][2])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(times, (t1 - t0, t2 - t1, t3 - t2, t3 - t0)):
            times[k].append(v * 1e3)
        inserted.append(int(ins["fields"][2].sum()))
    out = {k: statistics.median(v[1:]) for k, v in times.items()}
    out["push_inserted_keys"] = statistics.median(inserted[1:])
    return out


def hash_train_then_serve(trainer, state, batch) -> dict:
    """Save the trained hash tables, load them through ``POST /models`` of
    a ``ControllerServer`` and look one trained batch of pairs up on both
    tables: the rows must equal the trainer's read-only pull exactly."""
    from openembedding_tpu_torch import checkpoint
    from openembedding_tpu_torch import hash_table as hash_lib
    from openembedding_tpu_torch.serving.rest import ControllerServer
    ckpt_dir = os.path.join(ROOT, "_smoke_hash_train_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    server = None
    try:
        saved = checkpoint.save_checkpoint(
            ckpt_dir, trainer.collection, state.emb,
            model_sign=trainer.model_sign(state))
        server = ControllerServer(port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": ckpt_dir, "block": True}).encode())
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        ids = batch["sparse"]["fields"]
        dev_ids = torch.from_numpy(ids).to(trainer.device)
        for var in ("fields", "fields:linear"):
            rows, _ = lookup_bin(conn, sign, var, ids)
            want = hash_lib.pull(state.emb[var], dev_ids, None).cpu().numpy()
            if not np.array_equal(rows, want) or not np.abs(want).sum():
                raise AssertionError(f"served hash {var} rows differ from "
                                     "the trained table")
        conn.close()
        return {"model_sign": sign, "save_s": saved["seconds"],
                "save_bytes": saved["bytes"], "served_exact": True}
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_hash_training():
    """Phase 8; returns the KI cases and K2's, KI's and K3's launches on
    the hash training path (KI's array launches: the trainer's init)."""
    from openembedding_tpu_torch import hash_table as hash_lib
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.ops.find_or_insert import find_or_insert
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    trainer, mapper = build_hash_trainer("cuda")
    dev = trainer.device
    # bench.py's 8 cycled batches, then the same stream's next batches,
    # which the tables have not seen (the open key space): a block's worth
    # for each timed block of each step kind, then the trace's and the
    # stages'
    stream = synthetic_criteo(BATCH, num_buckets=HASH_VOCAB, seed=SEED)
    batches = [mapper.fuse_batch(next(stream)) for _ in range(TRAIN_BATCHES)]
    timed = 2 * BLOCKS * BLOCK_STEPS
    fresh = [mapper.fuse_batch(next(stream)) for _ in range(
        timed + 1 + TRACE_STEPS + STAGE_REPS + 2)]
    trace_batches = fresh[timed:][:1 + TRACE_STEPS]
    stage_batches = fresh[timed + 1 + TRACE_STEPS:]
    init_flat.launches = 0
    t0 = time.perf_counter()
    state = trainer.init(prng_key(SEED), batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat_launches = init_flat.launches
    check_init_launches("hash training", state, flat_launches)
    nocopy = check_hash_init_without_copy(trainer, state, batches[0])
    probe_gather.launches = init_rows.launches = 0
    k3_before = find_or_insert.launches
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    state, check = check_hash_against_cpu(trainer, state, batches)
    program = program_reading(trainer, reserved)
    check_first_loss("hash training", nocopy, check["card_losses"][0])
    oracle = captured_against_eager("hash training", trainer, state,
                                    batches[CHECK_STEPS:])
    # eager steps that insert keys, none reading the device back (a step
    # that synchronized could not be captured)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[CHECK_STEPS:CHECK_STEPS + SYNC_STEPS]:
            state, m = trainer.train_step_eager(state, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cases = phase_ki_kernels(trainer, state, batches[-1])
    state, m, cycled = compare_steps(
        trainer, state, lambda kind, k, i: batches[i % TRAIN_BATCHES],
        BATCH, table="fields")
    order = {"captured": 0, "eager": 1}
    state, m, opened = compare_steps(
        trainer, state,
        lambda kind, k, i: fresh[(2 * k + order[kind]) * BLOCK_STEPS + i],
        BATCH, table="fields")
    trace_path = os.path.join(ROOT, "_smoke_train_trace.json")
    try:
        trace = training_trace(trainer, state, trace_batches[1:],
                               trace_path, trace_batches[0])
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    steps = CHECK_STEPS + SYNC_STEPS \
        + 4 * (WARMUP_STEPS + BLOCKS * BLOCK_STEPS) + 1 + TRACE_STEPS
    launches = {"probe_gather": probe_gather.launches,
                "init_rows": init_rows.launches}
    if launches != {"probe_gather": 2 * steps, "init_rows": 4 * steps}:
        raise AssertionError(f"hash training: launches {launches} in "
                             f"{steps} steps, K2 2 and KI 4 a step expected")
    # each step's push finds or inserts once a table: 3 + chain kernels
    k3_step = sum(3 + hash_lib.table_layout(
        s.capacity, hash_lib.DEFAULT_MAX_PROBES)[2]
        for s in state.emb.values())
    launches["find_or_insert"] = find_or_insert.launches - k3_before
    if launches["find_or_insert"] != k3_step * steps:
        raise AssertionError(f"hash training: {launches['find_or_insert']} "
                             f"K3 launches in {steps} steps, {k3_step} a "
                             "step expected")
    launches["init_flat"] = flat_launches
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"hash training: loss {loss}")
    # a batch not yet seen, stepped again and again: its push inserts in
    # the build's warm-up only, so the replays' push is ``push_seen_ms``
    state, stages = step_stages(trainer, state,
                                [stage_batches[0]] * STAGE_STEPS)
    stages["push_seen_ms"] = stages.pop("push_ms")
    stages.update(push_stages(trainer, state, stage_batches[1:]))
    tables = {n: {"keys": s.num_used(), "capacity": s.capacity,
                  "load_factor": s.num_used() / s.capacity,
                  "insert_failures": int(s.insert_failures)}
              for n, s in state.emb.items()}
    served = hash_train_then_serve(trainer, state, batches[1])
    log(json.dumps({"hash_training": {
        "config": "deepfm_dim9_hash", "batch": BATCH, "init_s": init_s,
        "init_without_copy": nocopy, "check": check, "program": program,
        "captured_vs_eager": oracle, "steps": steps, "launches": launches,
        "tables": tables, "cycled": cycled, "fresh": opened,
        "examples_per_s": opened["captured"]["examples_per_s"],
        "step_ms": opened["captured"]["step_ms"],
        "eager_examples_per_s": opened["eager"]["examples_per_s"],
        "eager_step_ms": opened["eager"]["step_ms"],
        "last_loss": loss, "stages": stages, "trace": trace,
        "serve": served,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}}))
    return cases, launches


# --- phase 10: xdeepfm_dim16 training ---------------------------------------

def build_xdeep_trainer(device, model="xdeepfm"):
    """The ``xdeepfm_dim16`` trainer of ``bench.py`` (``build`` with its
    config): the 26 features fused into ``fields`` ``[26·2^20 + 26, 16]``
    and ``fields:linear``, sparse Adagrad (lr 0.01), ``XDeepFM`` with CIN
    ``CIN_LAYERS`` and DNN ``DNN_UNITS`` over 13 dense features, dense
    optax-form Adagrad (lr 0.01), on ``device``; with ``model="dcn"``,
    ``DCN`` with ``CROSS_LAYERS`` cross layers and the same DNN."""
    from openembedding_tpu_torch.data.criteo import NUM_DENSE, SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import build_model
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    specs, mapper = make_fused_specs(
        SPARSE_NAMES, VOCAB_PER_FEATURE, XDEEP_DIM,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    extra = {"cin_layer_sizes": CIN_LAYERS} if model == "xdeepfm" \
        else {"cross_layers": CROSS_LAYERS}
    module = build_model(model, SPARSE_NAMES, embedding_dim=XDEEP_DIM,
                         num_dense=NUM_DENSE, dnn_units=DNN_UNITS, **extra)
    return Trainer(module, EmbeddingCollection(specs, device=device,
                                               seed=SEED),
                   dense.adagrad(0.01)), mapper


def phase_xdeepfm_training() -> int:
    """Phase 10; returns K1's launches (XDeepFM's and DCN's steps) and
    KI's array launches in the two inits."""
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat
    from openembedding_tpu_torch.optim.initializers import prng_key
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("xdeepfm: float32 products must not run in "
                             "TF32 (the CPU's values are float32)")
    trainer, mapper = build_xdeep_trainer("cuda")
    dev = trainer.device
    batches = [mapper.fuse_batch(b) for b in synthetic_criteo(
        XDEEP_BATCH, num_buckets=VOCAB_PER_FEATURE, seed=SEED,
        num_batches=TRAIN_BATCHES)]
    init_flat.launches = 0
    t0 = time.perf_counter()
    state = trainer.init(prng_key(SEED), batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat_launches = init_flat.launches
    check_init_launches("xdeepfm", state, flat_launches)
    nocopy = check_array_init_without_copy(trainer, state, batches[0],
                                           build_xdeep_trainer)
    gather_rows.launches = 0
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    state, check = check_against_cpu(
        trainer, state, batches, build_xdeep_trainer("cpu")[0], "xdeepfm")
    program = program_reading(trainer, reserved)
    check_first_loss("xdeepfm", nocopy, check["card_losses"][0])
    oracle = captured_against_eager("xdeepfm", trainer, state, batches)
    state, m, speed = compare_steps(
        trainer, state, lambda kind, k, i: batches[i % TRAIN_BATCHES],
        XDEEP_BATCH)
    trace_path = os.path.join(ROOT, "_smoke_train_trace.json")
    try:
        trace = training_trace(trainer, state, batches, trace_path,
                               batches[-1])
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    steps = CHECK_STEPS + 2 * (WARMUP_STEPS + BLOCKS * BLOCK_STEPS) \
        + 1 + TRACE_STEPS
    if gather_rows.launches != 2 * steps:
        raise AssertionError(f"xdeepfm: {gather_rows.launches} K1 launches "
                             f"for {steps} steps, 2 a step expected")
    launches = gather_rows.launches
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"xdeepfm: loss {loss}")
    state, stages = step_stages(trainer, state, batches[:STAGE_STEPS])
    reading = {
        "config": "xdeepfm_dim16", "batch": XDEEP_BATCH, "init_s": init_s,
        "init_without_copy": nocopy, "init_flat_launches": flat_launches,
        "check": check, "program": program, "captured_vs_eager": oracle,
        "steps": steps, "k1_launches": launches,
        "examples_per_s": speed["captured"]["examples_per_s"],
        "step_ms": speed["captured"]["step_ms"],
        "eager_examples_per_s": speed["eager"]["examples_per_s"],
        "eager_step_ms": speed["eager"]["step_ms"], "speed": speed,
        "last_loss": loss, "stages": stages, "trace": trace,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    del trainer, state
    torch.cuda.empty_cache()
    # DCN over the same collection, from a fresh init
    dcn, _ = build_xdeep_trainer("cuda", "dcn")
    init_flat.launches = 0
    dstate = dcn.init(prng_key(SEED), batches[0])
    check_init_launches("dcn", dstate, init_flat.launches)
    flat_launches += init_flat.launches
    gather_rows.launches = 0
    dstate, dcheck = check_against_cpu(
        dcn, dstate, batches, build_xdeep_trainer("cpu", "dcn")[0], "dcn")
    if gather_rows.launches != 2 * CHECK_STEPS:
        raise AssertionError(f"dcn: {gather_rows.launches} K1 launches for "
                             f"{CHECK_STEPS} steps")
    launches += gather_rows.launches
    reading["dcn"] = {"check": dcheck, "builds": dcn.builds,
                      "k1_launches": gather_rows.launches}
    log(json.dumps({"xdeepfm_training": reading}))
    return launches, flat_launches


# --- phase 11: criteo_hist_hybrid ---------------------------------------------

# C1..C26's cardinalities in the public Criteo Display Advertising
# Challenge (Kaggle) data, as DLRM's Kaggle runs use them
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)
HYBRID_DENSE_SIZE = 64        # --sparse_as_dense 64 (exb.py:602's default)
HIST_LEN = 32                 # --hist_len 32
HIST_VOCAB = 1 << 20
HYBRID_BUCKETS = 1 << 24      # synthetic ids, each column then % its vocab
HIST_HASH_CAPACITY = 1 << 22  # the example's --hash tables
HYBRID_DENSE_KEPT = 28        # 14 features below the batch size, and twins
HYBRID_K1_PER_STEP = 26       # 24 array tables + the 2 pooled histories


def build_hybrid_trainer(device, hash_hist=False):
    """``criteo_hist_hybrid``: ``examples/criteo_deepctr.py --model deepfm
    --no-fused --embedding_dim 9 --batch_size 4096 --optimizer adagrad
    --learning_rate 0.01 --dense_lr 1e-3 --hist_len 32 --sparse_as_dense
    64`` with per-feature vocabularies (``CRITEO_KAGGLE_VOCABS``): the
    split keeps the 14 features below the batch size and their ``:linear``
    twins dense (28 tables), the other 24 tables and the pooled history
    (``hist`` mean, ``hist:linear`` sum, vocabulary 2^20) stay in the
    collection with sparse Adagrad; ``DeepFM`` over 27 fields, DNN (256,
    128), dense optax-form Adam 1e-3. ``hash_hist``: the history as wide
    hash variables of ``HIST_HASH_CAPACITY`` slots instead."""
    from openembedding_tpu_torch.data.criteo import NUM_DENSE, SPARSE_NAMES
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.hybrid import split_sparse_dense
    from openembedding_tpu_torch.models.deepctr import (build_model,
                                                        make_feature_specs)
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    opt = {"category": "adagrad", "learning_rate": 0.01}
    hist = {"input_dim": -1, "hash_capacity": HIST_HASH_CAPACITY} \
        if hash_hist else {"input_dim": HIST_VOCAB}
    specs = tuple(make_feature_specs(
        SPARSE_NAMES, list(CRITEO_KAGGLE_VOCABS), 9, optimizer=opt)) + (
        EmbeddingSpec(name="hist", output_dim=9, optimizer=opt,
                      pooling="mean", **hist),
        EmbeddingSpec(name="hist:linear", output_dim=1, optimizer=opt,
                      pooling="sum", **hist))
    sparse, kept = split_sparse_dense(specs, HYBRID_DENSE_SIZE,
                                      batch_size=BATCH)
    if len(kept) != HYBRID_DENSE_KEPT:
        raise AssertionError(f"hybrid: {len(kept)} dense-kept tables, "
                             f"{HYBRID_DENSE_KEPT} expected")
    module = build_model("deepfm", SPARSE_NAMES + ("hist",), embedding_dim=9,
                         num_dense=NUM_DENSE, dnn_units=DNN_UNITS)
    return Trainer(module, EmbeddingCollection(sparse, device=device,
                                               seed=SEED),
                   dense.adam(1e-3), sparse_as_dense=kept)


def hybrid_batches(count, wide=False):
    """``count`` batches of 4096 as the example makes them: the stream of
    ``synthetic_criteo(4096, num_buckets=2^24, seed=SEED)`` (zipf 1.2),
    each column ``Cj`` taken modulo its vocabulary, ``:linear`` twins, and
    the history drawn from ``RandomState(7)`` (lengths uniform in [0, 32],
    ids in [0, 2^20)), padded to ``[4096, 32]`` with -1
    (``ragged.pad_ragged``), or to ``[4096, 32, 2]`` pairs with EMPTY pairs
    (``pad_ragged_wide``) for the hash twin."""
    from openembedding_tpu_torch.data.criteo import (SPARSE_NAMES,
                                                     synthetic_criteo)
    from openembedding_tpu_torch.ragged import pad_ragged, pad_ragged_wide
    rng = np.random.RandomState(7)
    out = []
    for b in synthetic_criteo(BATCH, num_buckets=HYBRID_BUCKETS, seed=SEED,
                              num_batches=count):
        sparse = {}
        for name, vocab in zip(SPARSE_NAMES, CRITEO_KAGGLE_VOCABS):
            sparse[name] = sparse[name + ":linear"] = \
                (b["sparse"][name] % vocab).astype(np.int32)
        seqs = [rng.randint(0, HIST_VOCAB, rng.randint(0, HIST_LEN + 1))
                for _ in range(BATCH)]
        hist = pad_ragged_wide(seqs, HIST_LEN) if wide \
            else pad_ragged(seqs, HIST_LEN, pad_id=-1)
        sparse["hist"] = sparse["hist:linear"] = hist
        out.append({**b, "sparse": sparse})
    return out


def check_hybrid_init_without_copy(trainer, state, batch) -> dict:
    """The card's hybrid ``Trainer.init(prng_key(SEED), batch)`` against
    the CPU's draws, nothing copied: every dense parameter (the dense-kept
    tables among them, drawn by their specs' initializer) and each
    collection table's first, a middle and its last ``INIT_ROWS`` rows,
    as ``check_array_init_without_copy``; and the loss of a first step on
    ``batch`` from the CPU's values (the rows of its ids drawn by the
    plain version, zero for padding, the history pooled)."""
    from openembedding_tpu_torch.hybrid import DENSE_SCOPE
    from openembedding_tpu_torch.models.deepctr import init_params
    from openembedding_tpu_torch.optim import initializers as ti
    coll = trainer.collection
    cpu = build_hybrid_trainer("cpu")
    emb_rng, dense_rng = ti.split(ti.prng_key(SEED))
    params = init_params(cpu.module, dense_rng, "cpu",
                         dense_ids=set(batch["sparse"]))
    kept = getattr(cpu.module, DENSE_SCOPE)
    errs = [0.0]
    for k, v in params.items():
        if k.startswith(DENSE_SCOPE + "."):
            init = kept.initializer(k[len(DENSE_SCOPE) + 1:])
            kind, _ = ti.keyed_params(init)
            errs.append(_init_agrees(f"dense-kept {k}", state.params[k], v,
                                     kind, getattr(init, "stddev", 1.0)))
        elif k.endswith(".weight"):
            std = float(np.sqrt(np.float32(1.0 / v.shape[1]))
                        / np.float32(0.87962566103423978))
            errs.append(_init_agrees(f"parameter {k}", state.params[k], v,
                                     ti.TRUNCATED, std))
        else:
            errs.append(_init_agrees(f"parameter {k}", state.params[k], v,
                                     ti.CONSTANT, 0.0))
    if set(params) != set(state.params):
        raise AssertionError("init: the card's dense parameters are not "
                             "the CPU's")
    placed = cpu.place_batch(batch)
    pull_inputs, dense_ids = cpu._split_sparse(placed["sparse"])
    tables, rows = {}, {}
    for name, st in state.emb.items():
        init = coll.initializer(name)
        kind, prm = ti.keyed_params(init)
        key = coll.table_key(name, emb_rng)
        vocab, dim = st.weights.shape
        terr = []
        for r0 in (0, vocab // 2 - INIT_ROWS // 2, vocab - INIT_ROWS):
            want = ti.flat_rows(kind, prm, key, r0 * dim, INIT_ROWS * dim,
                                st.weights.dtype).reshape(INIT_ROWS, dim)
            terr.append(_init_agrees(f"{name} rows {r0}..",
                                     st.weights[r0:r0 + INIT_ROWS], want,
                                     kind, getattr(init, "stddev", 1.0)))
        ids = pull_inputs[name].to(torch.int64)
        valid = (ids >= 0) & (ids < vocab)
        r = ti.flat_draw(kind, prm, key, torch.where(valid, ids, 0)[..., None]
                         * dim + torch.arange(dim), st.weights.dtype)
        r = torch.where(valid[..., None], r, torch.zeros_like(r))
        spec = cpu.collection.specs[name]
        rows[name] = cpu.collection._pool(spec, r, ids) if spec.pooling \
            else r
        tables[name] = {"rows_checked": 3 * INIT_ROWS,
                        "max_abs_diff": max(terr)}
    with torch.no_grad():
        loss = float(cpu.loss_fn(
            cpu._logits(params, placed["dense"], rows, dense_ids),
            placed["label"]))
    return {"dense_max_abs_diff": max(errs), "dense_kept_tables": sum(
        k.startswith(DENSE_SCOPE + ".") for k in params),
            "tables": tables, "cpu_first_loss": loss}


def _table_ids(batches, name, vocab) -> np.ndarray:
    """The valid ids of column ``name`` over ``batches``, flat."""
    ids = np.concatenate([b["sparse"][name].reshape(-1) for b in batches])
    return ids[(ids >= 0) & (ids < vocab)]


def check_hybrid_against_cpu(trainer, state, batches, cpu_trainer):
    """``CHECK_STEPS`` captured card steps of the hybrid against the same
    steps of a CPU trainer from a copy of the initial state, phase 7's
    checks table by table: losses rtol 1e-4; each collection table's
    touched rows and slots atol 1e-5 + rtol 1e-4 and within
    ``change_ratio``'s limit, the check shown to flag the two simulated
    push faults; a sample of untouched ids (up to 2^20) bit for bit; the
    dense parameters (the dense-kept tables among them), Adam's moments
    and its count likewise; K1 ``HYBRID_K1_PER_STEP`` times a step."""
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.training import copy_state
    dev = trainer.device
    cstate = copy_state(state, "cpu")
    rng = np.random.RandomState(SEED + 4)
    plan = {}
    for n, s in state.emb.items():
        vocab = s.capacity
        seen, times = np.unique(_table_ids(batches[:CHECK_STEPS], n, vocab),
                                return_counts=True)
        if vocab <= 4 * UNTOUCHED_SAMPLE:
            cand = np.setdiff1d(np.arange(vocab), seen)
        else:
            cand = np.unique(rng.randint(0, vocab, 2 * UNTOUCHED_SAMPLE))
            cand = cand[~np.isin(cand, seen)]
        if cand.size < min(UNTOUCHED_SAMPLE, vocab // 4):
            raise AssertionError(f"hybrid: too few untouched ids of {n}")
        untouched = torch.from_numpy(
            cand[rng.permutation(cand.size)[:UNTOUCHED_SAMPLE]]).to(dev)
        ids = torch.from_numpy(seen)
        plan[n] = {"ids": ids, "cold": torch.from_numpy(times == 1),
                   "untouched": untouched,
                   "initial": [s.weights[untouched].clone()]
                   + [v[untouched].clone() for v in s.slots.values()],
                   "before": {"weights": s.weights[ids.to(dev)].cpu(),
                              **{k: v[ids.to(dev)].cpu()
                                 for k, v in s.slots.items()}}}
    card, host = [], []
    before = gather_rows.launches
    for b in batches[:CHECK_STEPS]:
        state, m = trainer.train_step(state, b)
        card.append(m["loss"])
    torch.cuda.synchronize()
    if gather_rows.launches - before != HYBRID_K1_PER_STEP * CHECK_STEPS:
        raise AssertionError(f"hybrid: {gather_rows.launches - before} K1 "
                             f"launches for {CHECK_STEPS} steps")
    for b in batches[:CHECK_STEPS]:
        cstate, m = cpu_trainer.train_step(cstate, b)
        host.append(float(m["loss"]))
    card = [float(x) for x in card]
    if not np.allclose(card, host, rtol=1e-4, atol=0):
        raise AssertionError(f"hybrid: losses {card} on the card, {host} on "
                             "the CPU")
    err, change, faults = {}, {}, {}
    for n, s in state.emb.items():
        cs, p = cstate.emb[n], plan[n]
        ids, cold = p["ids"], p["cold"]
        now = [s.weights[p["untouched"]]] + [v[p["untouched"]]
                                             for v in s.slots.values()]
        if not all(torch.equal(a, b) for a, b in zip(now, p["initial"])):
            raise AssertionError(f"hybrid: untouched rows of {n} changed")
        errs = []
        for k, v in [("weights", s.weights)] + list(s.slots.items()):
            got = v[ids.to(dev)].cpu()
            want = cs.weights[ids] if k == "weights" else cs.slots[k][ids]
            init = p["before"][k]
            errs.append(_close(f"{n} {k} of touched rows", got, want))
            reading = float(change_ratio(got, want, init).max())
            change[f"{n}/{k}"] = reading
            if not reading <= 1:
                raise AssertionError(
                    f"hybrid: the change of {n} {k} differs between the "
                    f"card and the CPU ({reading:.3g} of its limit)")
            moved = (want != init).reshape(len(want), -1).any(1)
            if not moved.any():
                # a field no row of which the CPU moved (the history's
                # ``accum``: mean-pooled gradients square below its
                # rounding): no fault can show there, and no card row may
                # move either
                if not torch.equal(got, init):
                    raise AssertionError(f"hybrid: rows of {n} {k} moved on "
                                         "the card, none on the CPU")
                faults[f"{n}/{k} unmoved"] = {"rows": 0}
                continue
            faulted = torch.where(cold.reshape((-1,) + (1,) * (got.dim() - 1)),
                                  init, got)
            must = f"{n}/{k} cold rows skipped"
            faults[must] = _fault_reading(faulted, want, init, moved & cold)
            if k != "weights":
                must = f"{n}/{k} unchanged"
                faults[must] = _fault_reading(init, want, init, moved)
            if not faults[must].get("change_max", 0) > 1:
                raise AssertionError(
                    f"hybrid: the change check misses a simulated fault "
                    f"({must}): {json.dumps(faults[must])}")
        err[n] = max(errs)
    err["dense"] = max(_close(f"parameter {k}", v, cstate.params[k])
                       for k, v in state.params.items())
    err["adam"] = max(_close(f"adam {k}", v, cstate.opt_state[k])
                      for k, v in state.opt_state.items() if k != "count")
    if not torch.equal(state.opt_state["count"].cpu(),
                       cstate.opt_state["count"]):
        raise AssertionError("hybrid: Adam's count differs")
    return state, cstate, {
        "card_losses": card, "cpu_losses": host,
        "touched_ids": {n: int(p["ids"].numel()) for n, p in plan.items()},
        "untouched_checked": {n: int(p["untouched"].numel())
                              for n, p in plan.items()},
        "max_abs_diff": err, "change_ratio_max": change,
        "simulated_faults": faults}


def check_hybrid_eval(trainer, state, cpu_trainer, cstate, batches) -> dict:
    """The captured eval (``eval_step``) against the eager one
    (``eval_step_eager``) on every batch, bit for bit, and against the CPU
    trainer's scores on the same state within rtol 1e-5; one eval program
    built."""
    worst = 0.0
    for i, b in enumerate(batches):
        got = trainer.eval_step(state, b)
        eager = trainer.eval_step_eager(state, b)
        if not torch.equal(got, eager):
            raise AssertionError(f"hybrid eval: captured scores differ from "
                                 f"eager ones on batch {i}")
        if i == 0:
            want = cpu_trainer.eval_step(cstate, b)
            if not torch.allclose(got.cpu(), want, rtol=1e-5, atol=0):
                raise AssertionError("hybrid eval: card scores differ from "
                                     "the CPU's")
            worst = float((got.cpu() - want).abs().max())
    if trainer.eval_builds != 1:
        raise AssertionError(f"hybrid eval: {trainer.eval_builds} eval "
                             "programs built, 1 expected")
    return {"batches": len(batches), "captured_equals_eager": True,
            "cpu_max_abs_diff": worst,
            "build_s": [p.build_s for p in trainer.eval_programs.values()],
            "pool_bytes": [p.pool_bytes
                           for p in trainer.eval_programs.values()]}


def eval_throughput(trainer, state, batches) -> dict:
    """Examples/s of the captured and the eager eval: ``BLOCKS`` timed
    blocks of ``BLOCK_STEPS`` evals each, in turns (the median block)."""
    evals = {"captured": trainer.eval_step,
             "eager": trainer.eval_step_eager}
    blocks = {kind: [] for kind in evals}
    for k in range(BLOCKS):
        for kind in (list(evals) if k % 2 == 0 else list(evals)[::-1]):
            t0 = time.perf_counter()
            for i in range(BLOCK_STEPS):
                evals[kind](state, batches[i % len(batches)])
            torch.cuda.synchronize()
            blocks[kind].append(BLOCK_STEPS * BATCH
                                / (time.perf_counter() - t0))
    out = {kind: {"examples_per_s": statistics.median(eps),
                  "eps_min": min(eps), "eps_max": max(eps),
                  "ms": BATCH / statistics.median(eps) * 1e3}
           for kind, eps in blocks.items()}
    out["captured_over_eager"] = out["captured"]["examples_per_s"] \
        / out["eager"]["examples_per_s"]
    return out


def _pooled_on_host(weights: np.ndarray, ids: np.ndarray,
                    pooling: str) -> np.ndarray:
    """A pooled sequence lookup computed on the host: zero rows for
    padding, the rows added in sequence order, then divided by the valid
    length for ``mean`` (float32 throughout)."""
    rows = expected_rows(weights, ids)
    s = rows[:, 0] + np.float32(0)
    for i in range(1, ids.shape[1]):
        s = s + rows[:, i]
    if pooling == "mean":
        n = np.maximum(((ids >= 0) & (ids < len(weights))).sum(1), 1)
        s = s / n.astype(np.float32)[:, None]
    return s


def hybrid_train_then_serve(trainer, state, batch) -> dict:
    """Save the trained collection's tables (weights only), load them
    through ``POST /models`` and look up: ``[4096, 32]`` history sequences
    on ``hist`` and ``hist:linear``, which must come back pooled and equal
    the host copy pooled on the host; flat ``[n]`` ids of ``hist`` and of
    ``C3``, one row per id, equal to the host copy."""
    from openembedding_tpu_torch import checkpoint
    from openembedding_tpu_torch.serving.rest import ControllerServer
    ckpt_dir = os.path.join(ROOT, "_smoke_hybrid_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    server = None
    try:
        saved = checkpoint.save_checkpoint(
            ckpt_dir, trainer.collection, state.emb, include_optimizer=False,
            model_sign=trainer.model_sign(state))
        server = ControllerServer(port=0).start()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": ckpt_dir, "block": True}).encode())
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        seqs = batch["sparse"]["hist"]
        ms = {}
        for var, pooling in (("hist", "mean"), ("hist:linear", "sum")):
            host = state.emb[var].weights.cpu().numpy()
            rows, ms[var] = lookup_bin(conn, sign, var, seqs)
            want = _pooled_on_host(host, seqs, pooling)
            if rows.shape != want.shape or not np.array_equal(rows, want):
                raise AssertionError(f"served pooled {var} rows differ from "
                                     "the host's pooling")
        for var, ids in (("hist", seqs[:, :4].reshape(-1)),
                         ("C3", batch["sparse"]["C3"])):
            rows, _ = lookup_bin(conn, sign, var, ids)
            want = expected_rows(state.emb[var].weights.cpu().numpy(), ids)
            if not np.array_equal(rows, want):
                raise AssertionError(f"served flat {var} rows differ")
        conn.close()
        return {"model_sign": sign, "save_s": saved["seconds"],
                "save_bytes": saved["bytes"], "pooled_exact": True,
                "flat_exact": True, "pooled_lookup_ms": ms}
    finally:
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def hybrid_hash_twin() -> dict:
    """The history as wide hash variables (``HIST_HASH_CAPACITY`` slots,
    ``[4096, 32, 2]`` pairs padded with EMPTY pairs), correctness only: 4
    captured card steps against 4 CPU steps from a copy of the initial
    state; losses rtol 1e-4, the keys arrays and failure counts bit for
    bit, every stored key a real id of the batches (no EMPTY key inserted
    from padding), its row within atol 1e-5 + rtol 1e-4; K1 24 times, K2
    twice and KI four times a step. Returns the reading and the
    launches."""
    from openembedding_tpu_torch.hash_table import join64
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.training import copy_state
    trainer = build_hybrid_trainer("cuda", hash_hist=True)
    batches = hybrid_batches(CHECK_STEPS, wide=True)
    init_flat.launches = 0
    state = trainer.init(prng_key(SEED), batches[0])
    flat = init_flat.launches
    check_init_launches("hybrid hash twin", state, flat)
    cpu = build_hybrid_trainer("cpu", hash_hist=True)
    cstate = copy_state(state, "cpu")
    counters = (gather_rows, probe_gather, init_rows)
    before = [c.launches for c in counters]
    card = []
    for b in batches:
        state, m = trainer.train_step(state, b)
        card.append(m["loss"])
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(counters, before)]
    if launched != [24 * CHECK_STEPS, 2 * CHECK_STEPS, 4 * CHECK_STEPS]:
        raise AssertionError(f"hybrid hash twin: K1, K2, KI launched "
                             f"{launched} times in {CHECK_STEPS} steps")
    host = []
    for b in batches:
        cstate, m = cpu.train_step(cstate, b)
        host.append(float(m["loss"]))
    card = [float(x) for x in card]
    if not np.allclose(card, host, rtol=1e-4, atol=0):
        raise AssertionError(f"hybrid hash twin: losses {card} on the card, "
                             f"{host} on the CPU")
    pairs = np.concatenate([b["sparse"]["hist"].reshape(-1, 2)
                            for b in batches])
    real = np.unique(join64(pairs[pairs[:, 1] != np.iinfo(np.int32).min]))
    tables = {}
    for n in ("hist", "hist:linear"):
        s, cs = state.emb[n], cstate.emb[n]
        if not torch.equal(s.keys.cpu(), cs.keys) \
                or int(s.insert_failures) != int(cs.insert_failures):
            raise AssertionError(f"hybrid hash twin: the keys of {n} differ "
                                 "between the card and the CPU")
        live = cs.live()
        stored = np.sort(join64(cs.keys[live].numpy()))
        if not np.array_equal(stored, real):
            raise AssertionError(f"hybrid hash twin: {n} holds keys that are "
                                 "not the batches' ids (an EMPTY key from "
                                 "padding?)")
        idx = torch.nonzero(live).reshape(-1)
        err = _close(f"twin {n} rows", s.weights[idx.to(s.weights.device)],
                     cs.weights[idx])
        tables[n] = {"keys": int(idx.numel()), "max_abs_diff": err,
                     "insert_failures": int(cs.insert_failures)}
    reading = {"steps": CHECK_STEPS, "card_losses": card, "cpu_losses": host,
               "keys_bit_identical": True, "no_empty_key": True,
               "tables": tables, "builds": trainer.builds,
               "launches_per_step": {"gather_rows": 24, "probe_gather": 2,
                                     "init_rows": 4}}
    return reading, {"gather_rows": launched[0],
                     "probe_gather": launched[1],
                     "init_rows": launched[2], "init_flat": flat}


def phase_hybrid_training():
    """Phase 11; returns the launches of K1, K2 and KI (per key and array)
    on this phase's main path."""
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat
    from openembedding_tpu_torch.optim.initializers import prng_key
    trainer = build_hybrid_trainer("cuda")
    dev = trainer.device
    batches = hybrid_batches(TRAIN_BATCHES)
    init_flat.launches = 0
    t0 = time.perf_counter()
    state = trainer.init(prng_key(SEED), batches[0])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flat_launches = init_flat.launches
    check_init_launches("hybrid", state, flat_launches)
    nocopy = check_hybrid_init_without_copy(trainer, state, batches[0])
    gather_rows.launches = 0
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    cpu_trainer = build_hybrid_trainer("cpu")
    state, cstate, check = check_hybrid_against_cpu(trainer, state, batches,
                                                    cpu_trainer)
    program = program_reading(trainer, reserved)
    check_first_loss("hybrid", nocopy, check["card_losses"][0])
    oracle = captured_against_eager("hybrid", trainer, state, batches)
    evals = check_hybrid_eval(trainer, state, cpu_trainer, cstate, batches)
    del cpu_trainer, cstate
    state, m, speed = compare_steps(
        trainer, state, lambda kind, k, i: batches[i % TRAIN_BATCHES], BATCH)
    eval_speed = eval_throughput(trainer, state, batches)
    trace_path = os.path.join(ROOT, "_smoke_train_trace.json")
    try:
        trace = training_trace(trainer, state, batches, trace_path,
                               batches[-1])
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    steps = CHECK_STEPS + 2 * (WARMUP_STEPS + BLOCKS * BLOCK_STEPS) \
        + 1 + TRACE_STEPS
    evals_run = 2 * TRAIN_BATCHES + 2 * BLOCKS * BLOCK_STEPS
    launches = gather_rows.launches
    if launches != HYBRID_K1_PER_STEP * (steps + evals_run):
        raise AssertionError(
            f"hybrid: {launches} K1 launches for {steps} steps and "
            f"{evals_run} evals, {HYBRID_K1_PER_STEP} each expected")
    if trace["launches_per_step"]["gather_rows"] != HYBRID_K1_PER_STEP:
        raise AssertionError(f"hybrid: K1 {trace['launches_per_step']} a "
                             "replayed step")
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"hybrid: loss {loss}")
    state, stages = step_stages(trainer, state, batches[:STAGE_STEPS])
    served = hybrid_train_then_serve(trainer, state, batches[1])
    reading = {
        "config": "criteo_hist_hybrid", "batch": BATCH, "init_s": init_s,
        "init_without_copy": nocopy, "init_flat_launches": flat_launches,
        "check": check, "program": program, "captured_vs_eager": oracle,
        "eval": evals, "eval_speed": eval_speed,
        "eval_examples_per_s": eval_speed["captured"]["examples_per_s"],
        "eager_eval_examples_per_s": eval_speed["eager"]["examples_per_s"],
        "steps": steps, "evals": evals_run, "k1_launches": launches,
        "examples_per_s": speed["captured"]["examples_per_s"],
        "step_ms": speed["captured"]["step_ms"],
        "eager_examples_per_s": speed["eager"]["examples_per_s"],
        "eager_step_ms": speed["eager"]["step_ms"], "speed": speed,
        "last_loss": loss, "stages": stages, "trace": trace,
        "serve": served,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    del trainer, state
    torch.cuda.empty_cache()
    twin, twin_launches = hybrid_hash_twin()
    reading["hash_twin"] = twin
    log(json.dumps({"hybrid_training": reading}))
    return {"gather_rows": launches + twin_launches["gather_rows"],
            "probe_gather": twin_launches["probe_gather"],
            "init_rows": twin_launches["init_rows"],
            "init_flat": flat_launches + twin_launches["init_flat"]}


# --- phase 12: delta checkpoints, elastic fit, hot-swap -----------------------

AB_VOCAB, AB_DIM = 1 << 22, 9  # ckpt_delta_ab (bench.py:1694): one table,
AB_DIRTY = 0.05                # 5 % of its rows dirty, 1024 chunks, 3
AB_CHUNKS, AB_REPEATS = 1024, 3    # delta saves
ELASTIC_STEPS = 12             # the uninterrupted fit(autosave_every=4)
AUTOSAVE_EVERY = 4
KILLED_AT = 8                  # the interrupted fit's steps
SHARE_AT = (1, 4, 8)           # steps after which the dirty share is read


def ckpt_delta_ab(tmp: str, mesh=None) -> dict:
    """``ckpt_delta_ab`` on the card: a ``[2^22, 9]`` Adagrad table saved
    full (parallel writers), then 5 % of its rows pushed and 3 delta saves
    of those rows' chunks (1024 chunks; each repeat re-marks the same
    rows, as bench.py does), then the base and chain loaded (replayed) and
    held against the live table exactly, weights and slots. ``mesh``: a
    one-process ``(data, model)`` shape the table shards over
    (``run_ckpt_delta_ab``'s ``create_mesh(1, n_dev)``), else one
    device."""
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                    EmbeddingSpec)
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    coll = EmbeddingCollection((EmbeddingSpec(
        name="big", input_dim=AB_VOCAB, output_dim=AB_DIM,
        optimizer={"category": "adagrad", "learning_rate": 0.01}),),
        None if mesh is None else create_mesh(*mesh, device=SD_DEVICE),
        seed=SEED)
    states = coll.init()
    torch.cuda.synchronize()
    full = ck.save_checkpoint(os.path.join(tmp, "ab_full"), coll, states)
    shutil.rmtree(os.path.join(tmp, "ab_full"))
    coll.enable_dirty_tracking(target_chunks=AB_CHUNKS)
    ddir = os.path.join(tmp, "ab_delta")
    ck.save_checkpoint(ddir, coll, states, mode="delta", step=0)
    n_dirty = int(AB_VOCAB * AB_DIRTY)
    ids = torch.arange(n_dirty, device=coll.device)
    rows = coll.pull(states, {"big": ids})
    coll.apply_gradients(states, {"big": ids},
                         {"big": torch.ones_like(rows["big"])})
    deltas = []
    for r in range(AB_REPEATS):
        if r:
            coll.mark_dirty({"big": np.arange(n_dirty)})
        info = cd.save_delta(ddir, coll, states, step=r + 1,
                             compact_chain_len=10 ** 6,
                             compact_bytes_ratio=float("inf"),
                             background_compact=False)
        deltas.append({"seconds": info["seconds"], "bytes": info["bytes"],
                       "rows": info["rows"]})
    t0 = time.perf_counter()
    info: dict = {}
    loaded = ck.load_checkpoint(ddir, coll, info=info)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    exact = torch.equal(loaded["big"].weights, states["big"].weights) \
        and torch.equal(loaded["big"].slots["accum"],
                        states["big"].slots["accum"])
    if not exact or info["applied_seq"] != AB_REPEATS:
        raise AssertionError(f"ckpt_delta_ab: replay exact={exact}, "
                             f"applied_seq {info['applied_seq']}")
    return {"vocab": AB_VOCAB, "dim": AB_DIM, "dirty_rows": n_dirty,
            "mesh": list(mesh or (1, 1)),
            "full_s": full["seconds"], "full_bytes": full["bytes"],
            "full_gbps": full["bytes"] / full["seconds"] / 1e9,
            "deltas": deltas,
            "full_over_delta_bytes": full["bytes"] / deltas[-1]["bytes"],
            "load_replay_s": load_s, "replay_exact": exact}


def _dirty_share(trainer, state, batches) -> dict:
    """The share of each table's chunks marked after 1, 4 and 8 steps from
    clean trackers (default chunking), on a copy of ``state``; the
    trackers are cleared again after."""
    from openembedding_tpu_torch.training import copy_state
    trackers = trainer.collection.dirty_trackers
    for t in trackers.values():
        t.clear_all()
    s = copy_state(state, trainer.device)
    out = {}
    for i, b in enumerate(batches[:max(SHARE_AT)]):
        s, _ = trainer.train_step(s, b)
        if i + 1 in SHARE_AT:
            out[str(i + 1)] = {n: t.dirty_count / t.num_chunks
                               for n, t in trackers.items()}
    for t in trackers.values():
        t.clear_all()
    del s
    return out


def _tracking_cost(trainer, state, batches) -> dict:
    """Captured step ms with dirty tracking armed and off, ``BLOCKS``
    blocks of ``BLOCK_STEPS`` steps each, in turns (``_block``; off takes
    the trackers away for the block), on a copy of ``state`` whose program
    is built here, outside the deterministic mode the elastic checks ran
    in; and the host's marking of one batch alone (``mark_dirty`` on its
    host ids, median of ``REPS``)."""
    from openembedding_tpu_torch.training import copy_state
    coll = trainer.collection
    trackers = coll._dirty_trackers
    host = [trainer.host_batch(b)["sparse"] for b in batches]
    mark_ms = []
    for i in range(REPS):
        t0 = time.perf_counter()
        coll.mark_dirty(host[i % len(host)])
        mark_ms.append((time.perf_counter() - t0) * 1e3)
    state = copy_state(state, trainer.device)
    for b in batches[:WARMUP_STEPS]:
        state, _ = trainer.train_step(state, b)

    def armed(s, b):
        coll._dirty_trackers = trackers
        return trainer.train_step(s, b)

    def off(s, b):
        coll._dirty_trackers = {}
        return trainer.train_step(s, b)
    steps = {"armed": armed, "off": off}
    ms = {k: [] for k in steps}
    try:
        for k in range(BLOCKS):
            for kind in (list(steps) if k % 2 == 0 else list(steps)[::-1]):
                state, _, eps, _ = _block(
                    trainer, state, steps[kind],
                    [batches[i % len(batches)] for i in range(BLOCK_STEPS)],
                    BATCH, None)
                ms[kind].append(BATCH / eps * 1e3)
    finally:
        coll._dirty_trackers = trackers
    out = {k: {"step_ms": statistics.median(v), "block_ms": v}
           for k, v in ms.items()}
    out["mark_ms"] = statistics.median(mark_ms)
    return out


def _expected(state, var, ids: np.ndarray, hashed: bool) -> np.ndarray:
    """The trainer's rows for served ids, read from its tables on the host
    (no kernel): an array table's rows by id, a hash table's by key."""
    st = state.emb[var]
    if not hashed:
        return st.weights.index_select(
            0, torch.from_numpy(ids.reshape(-1)).to(st.weights.device)
        ).reshape(ids.shape + (-1,)).cpu().numpy()
    from openembedding_tpu_torch.hash_table import join64
    live = st.live()
    table = HostRows(join64(st.keys[live].cpu().numpy()),
                     st.weights[live].cpu().numpy())
    return table.expect(ids)


def _serve_check(conn, sign, state, probe, hashed, what) -> int:
    """``lookup_bin`` of the probe batch on both tables, each response
    equal to the trainer's rows exactly; returns the requests made."""
    for var in ("fields", "fields:linear"):
        rows, _ = lookup_bin(conn, sign, var, probe)
        if not np.array_equal(rows, _expected(state, var, probe, hashed)):
            raise AssertionError(f"{what}: served {var} rows differ from "
                                 "the trainer's")
    return 2


def elastic_and_swap(kind: str, tmp: str) -> dict:
    """Phase 12's training half for ``deepfm_dim9`` (``kind="array"``) or
    ``deepfm_dim9_hash`` (from empty tables), at full width, with dirty
    tracking armed at the default chunking, under deterministic
    algorithms (two runs must be bit-identical; the push's atomics are
    not):

    * the dirty chunk share after 1, 4 and 8 steps (on a copy);
    * uninterrupted: ``fit(autosave_every=4, retrace_budget=0)`` over 12
      captured steps; its deltas are published from memory
      (``save_delta(return_payload=True)``, compaction parked so the
      chain stays whole); after step 4 the base (version 0) is loaded
      through ``POST /models`` and served exactly;
    * interrupted: a fresh trainer fits 8 steps (autosaves at 4 and 8,
      default compaction) and is dropped; a fresh trainer and collection
      ``fit(resume_from=, retrace_budget=0)`` the remaining 4 and must
      equal the uninterrupted run bit for bit: every table, slot, dense
      parameter and optimizer state, a hash table's keys and failure
      count (0, no EMPTY key stored); one program build each;
    * hot-swap: each delta's ``encode_delta`` bytes through ``POST
      /models/<sign>/delta``, lookups after each equal to the trainer's
      rows at that step, a re-sent delta a no-op, a skipped one refused
      with 409; K1 (array) or K2 (hash) launched once a lookup request,
      from the counters and a profiler trace, KI never in a hash apply;
      the swap's seconds, rows and peak device memory;
    * captured step ms with tracking armed and off, in turns, and the
      host's marking of one batch alone."""
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.analysis import scope
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.serving.rest import ControllerServer
    hashed = kind == "hash"
    build = build_hash_trainer if hashed else build_trainer
    kernel = probe_gather if hashed else gather_rows

    def fresh():
        trainer, mapper = build("cuda")
        trainer.collection.enable_dirty_tracking()
        return trainer, mapper
    trainer, mapper = fresh()
    batches = [mapper.fuse_batch(b) for b in synthetic_criteo(
        BATCH, num_buckets=HASH_VOCAB if hashed else VOCAB_PER_FEATURE,
        seed=SEED, num_batches=ELASTIC_STEPS)]
    probe = batches[-1]["sparse"]["fields"]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    server = ControllerServer(port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)
    published, saves, seen = [], [], {}
    orig_save_delta = cd.save_delta

    def publishing_save_delta(*a, **k):
        info = orig_save_delta(*a, **{**k, "return_payload": True,
                                      "compact_chain_len": 10 ** 6,
                                      "compact_bytes_ratio": float("inf")})
        saves.append({f: info[f] for f in ("mode", "seconds", "bytes")})
        if "delta" in info:
            published.append(info.pop("delta"))
        return info
    try:
        state = trainer.init(prng_key(SEED), batches[0])
        share = _dirty_share(trainer, state, batches)
        auto = os.path.join(tmp, f"{kind}_auto")

        # the hooks run before a step (fit fetches its batches a window
        # ahead, so a batch generator would run them too early)
        orig_step, calls = trainer.train_step, [0]

        def hooked_step(state_, b, **kw):
            i, calls[0] = calls[0], calls[0] + 1
            if i == AUTOSAVE_EVERY:
                # after step 4 and its (full) autosave: serve the base
                status, body = _post(conn, "/models", json.dumps(
                    {"model_uri": auto, "model_sign": f"{kind}-auto",
                     "block": True}).encode())
                if status != 201:
                    raise AssertionError(
                        f"POST /models: HTTP {status} {body!r}")
                seen["sign"] = json.loads(body)["model_sign"]
                seen["requests"] = _serve_check(
                    conn, seen["sign"], state, probe, hashed,
                    f"{kind} base")
                seen["version0"] = server.registry.find_model(
                    seen["sign"]).version
            if i == KILLED_AT:
                seen["rows8"] = {v: _expected(state, v, probe, hashed)
                                 for v in ("fields", "fields:linear")}
            return orig_step(state_, b, **kw)
        scope.reset()
        builds0 = trainer.builds
        cd.save_delta = publishing_save_delta
        trainer.train_step = hooked_step
        try:
            state, m = trainer.fit(state, batches,
                                   autosave_every=AUTOSAVE_EVERY,
                                   autosave_dir=auto, retrace_budget=0)
        finally:
            cd.save_delta = orig_save_delta
            del trainer.train_step
        builds_u = trainer.builds - builds0

        # interrupted after 8 steps, then resumed by a fresh trainer
        killed = os.path.join(tmp, f"{kind}_killed")
        t1, _ = fresh()
        s1 = t1.init(prng_key(SEED), batches[0])
        t1.fit(s1, batches[:KILLED_AT], autosave_every=AUTOSAVE_EVERY,
               autosave_dir=killed)
        del t1, s1
        torch.cuda.empty_cache()
        t2, _ = fresh()
        s2 = t2.init(prng_key(SEED), batches[0])
        resume0 = scope.HISTOGRAMS.sum("span_trainer_resume_seconds")
        # the resumed fit writes no autosave: the gate reads its state
        s2, m2 = t2.fit(s2, batches, resume_from=killed, retrace_budget=0)
        torch.cuda.synchronize()
        resume_s = scope.HISTOGRAMS.sum("span_trainer_resume_seconds") \
            - resume0
        diff = _spread(state_tensors(state), state_tensors(s2))
        reading = {"config": "deepfm_dim9" + ("_hash" if hashed else ""),
                   "dirty_share": share, "steps": ELASTIC_STEPS,
                   "autosave_every": AUTOSAVE_EVERY, "saves": saves,
                   "builds_uninterrupted": builds_u,
                   "builds_resumed": t2.builds, "resume_s": resume_s,
                   "resumed_vs_uninterrupted": diff,
                   "chain_killed": cd.chain_state(killed)}
        if diff["tensors"] or builds_u != 1 or t2.builds != 1 \
                or int(s2.step) != ELASTIC_STEPS:
            raise AssertionError(f"{kind} elastic fit: {json.dumps(reading)}")
        if hashed:
            for name, st in s2.emb.items():
                stored = st.keys[st.live()]
                empty = (stored == EMPTY32).all(dim=1).sum()
                if int(st.insert_failures) or int(empty):
                    raise AssertionError(f"{kind} {name}: "
                                         f"{int(st.insert_failures)} insert "
                                         f"failures, {int(empty)} EMPTY keys")
            reading["keys_stored"] = {n: st.num_used()
                                      for n, st in s2.emb.items()}
        del t2, s2
        torch.cuda.empty_cache()

        # hot-swap the published deltas into the served base, on a new
        # connection (the server closes one idle for 5 s)
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        sign = seen["sign"]
        if seen["version0"] != 0 or len(published) != 2:
            raise AssertionError(f"{kind}: base version {seen['version0']}"
                                 f", {len(published)} deltas published")
        swaps, requests = [], seen["requests"]
        launches0, ki0 = kernel.launches, init_rows.launches
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            for delta, want in zip(published, (seen["rows8"], None)):
                raw = cd.encode_delta(delta)
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ki = init_rows.launches
                t0 = time.perf_counter()
                status, body = _post(conn, f"/models/{sign}/delta", raw)
                swap_s = time.perf_counter() - t0
                res = json.loads(body)
                if status != 200 or not res["applied"] \
                        or res["version"] != delta.seq:
                    raise AssertionError(f"{kind} swap {delta.seq}: HTTP "
                                         f"{status} {body!r}")
                swaps.append({"seq": delta.seq, "seconds": swap_s,
                              "wire_bytes": len(raw), "rows": res["rows"],
                              "peak_bytes":
                                  torch.cuda.max_memory_allocated(),
                              "peak_over_before_bytes":
                                  torch.cuda.max_memory_allocated()
                                  - before,
                              "ki_launches": init_rows.launches - ki})
                for var in ("fields", "fields:linear"):
                    rows, _ = lookup_bin(conn, sign, var, probe)
                    expect = want[var] if want is not None \
                        else _expected(state, var, probe, hashed)
                    requests += 1
                    if not np.array_equal(rows, expect):
                        raise AssertionError(
                            f"{kind} after swap {delta.seq}: served {var} "
                            "rows differ from the trainer's")
            torch.cuda.synchronize()
        trace_path = os.path.join(tmp, f"{kind}_swap_trace.json")
        prof.export_chrome_trace(trace_path)
        with open(trace_path) as f:
            traced = sum(1 for e in json.load(f).get("traceEvents", [])
                         if e.get("cat") == "kernel"
                         and _kernel_family(e.get("name", ""))
                         == kernel.__name__)
        swap_launches = kernel.launches - launches0
        lookups = requests - seen["requests"]
        if swap_launches != lookups or traced != lookups \
                or init_rows.launches != ki0:
            raise AssertionError(
                f"{kind} swap: {swap_launches} {kernel.__name__} launches "
                f"({traced} traced) for {lookups} lookups, "
                f"{init_rows.launches - ki0} KI launches")
        conn.close()        # idle through the trace's export
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        status, body = _post(conn, f"/models/{sign}/delta", raw)
        stale = json.loads(body)
        gap = cd.Delta(seq=published[-1].seq + 2, step=0, vars={})
        gap_status, _ = _post(conn, f"/models/{sign}/delta",
                              cd.encode_delta(gap))
        if status != 200 or stale["applied"] or gap_status != 409:
            raise AssertionError(f"{kind}: re-sent delta HTTP {status} "
                                 f"{stale}, skipped one HTTP {gap_status}")
        reading["swap"] = {"swaps": swaps, "lookups": requests,
                           "kernel_launches": swap_launches,
                           "traced_launches": traced, "resent": stale,
                           "skipped_status": gap_status}
    finally:
        torch.use_deterministic_algorithms(False)
        conn.close()
        server.stop()
    reading["tracking"] = _tracking_cost(trainer, state, batches)
    reading["last_loss"] = float(m["loss"])
    return reading


def phase_delta() -> dict:
    """Phase 12: ``ckpt_delta_ab``, then the elastic fit and hot-swap of
    ``deepfm_dim9`` and ``deepfm_dim9_hash`` (``elastic_and_swap``), every
    checkpoint under a ``tempfile.mkdtemp()`` removed at the end. Prints
    one ``{"delta": {...}}`` line; returns the kernels' launches of the
    phase (counters zeroed at its start)."""
    import tempfile
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = (gather_rows, probe_gather, init_rows, init_flat)
    for w in wrappers:
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_delta_")
    t0 = time.perf_counter()
    try:
        reading = {"ckpt_delta_ab": ckpt_delta_ab(tmp)}
        torch.cuda.empty_cache()
        for kind in ("array", "hash"):
            reading[kind] = elastic_and_swap(kind, tmp)
            torch.cuda.empty_cache()
    finally:
        # a background compaction may still fold a chain under tmp
        for d in os.listdir(tmp):
            try:
                cd.join_compactor(os.path.join(tmp, d))
            except RuntimeError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
    reading["phase_s"] = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    reading["launches"] = launches
    log(json.dumps({"delta": reading}))
    return launches


# --- phase 13: ingest from shard files, checkpoint layouts ---------------------

INGEST_SHARDS = 8             # TSV shards of INGEST_ROWS rows: 128 batches
INGEST_ROWS = 1 << 16
INGEST_STEPS = 64             # the gated fits run over the first 4 shards
INGEST_AUTOSAVE = 16
INGEST_KILLED_AT = 40         # steps the killed fit takes
BAD_ROWS_PER_SHARD = 4        # the short bad-row stream: 2 x 8192 rows
TFR_SHARDS, TFR_ROWS = 2, 1 << 14   # the hash twin's TFRecord shards
HASH_INGEST_STEPS = TFR_SHARDS * TFR_ROWS // BATCH
MEMORY_URI = "memory://oe-smoke-ingest"


def _write_shards(out_dir: str, num_shards: int, rows: int, fmt: str):
    """``write_synthetic_shards`` at the smoke's seed: paths, seconds."""
    from openembedding_tpu_torch.data.stream import write_synthetic_shards
    t0 = time.perf_counter()
    paths = write_synthetic_shards(out_dir, num_shards=num_shards,
                                   rows_per_shard=rows, fmt=fmt, seed=SEED)
    return paths, time.perf_counter() - t0


def _shard_reading(paths: list, seconds: float, rows: int) -> dict:
    return {"files": len(paths), "rows": len(paths) * rows,
            "seconds": seconds,
            "bytes": sum(os.path.getsize(p) for p in paths)}


_SHARD_WRITER = (
    "import json, sys\n"
    "import chip_smoke\n"
    "print(json.dumps(chip_smoke._write_shards(*json.loads(sys.argv[1]))))\n")


def _spawn_shard_writer(out_dir: str, num_shards: int, rows: int,
                        fmt: str) -> subprocess.Popen:
    """A child process running ``_write_shards`` beside this process's
    work (the shard writers are pure Python, so threads would only take
    turns); ``_join_shard_writer`` returns its paths and reading."""
    return subprocess.Popen(
        [sys.executable, "-c", _SHARD_WRITER,
         json.dumps([out_dir, num_shards, rows, fmt])],
        cwd=ROOT, stdout=subprocess.PIPE, text=True)


def _join_shard_writer(child: subprocess.Popen) -> tuple:
    out, _ = child.communicate(timeout=300)
    if child.returncode:
        raise RuntimeError(f"shard writer {child.args[-1]} exited "
                           f"{child.returncode}")
    paths, seconds = json.loads(out.strip().splitlines()[-1])
    return paths, _shard_reading(paths, seconds,
                                 json.loads(child.args[-1])[2])


def _ingest_stream(paths, mapper, buckets, fmt="tsv", **kw):
    from openembedding_tpu_torch.data.stream import ShardStream
    return ShardStream(paths, batch_size=BATCH, fmt=fmt,
                       num_buckets=buckets, transform=mapper.fuse_batch,
                       **kw)


def _device_busy_us(trace_path: str) -> float:
    """Device time in a ``torch.profiler`` trace: the union of its
    kernel, memcpy and memset intervals, in microseconds."""
    with open(trace_path) as f:
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in json.load(f).get("traceEvents", [])
                       if e.get("cat") in ("kernel", "gpu_memcpy",
                                           "gpu_memset") and "dur" in e)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _recorded_fit(trainer, state, source, trace=None, **kw):
    """``trainer.fit(state, source, retrace_budget=0, **kw)`` with every
    step's batch and loss kept; returns ``(state, reading, record)``. The
    steady window starts at step 2 (step 1 builds the program):
    examples/s over it and, with ``trace`` (a path), the device's busy
    share, the device time a ``torch.profiler`` trace of the card (CUDA
    activity only, started at step 2) holds over the window's wall time.
    A fit that raises leaves its partial record in the exception's
    ``record`` attribute."""
    from torch.profiler import ProfilerActivity, profile
    rec = {"seen": [], "losses": [], "marks": []}
    prof = profile(activities=[ProfilerActivity.CUDA]) if trace else None
    orig = trainer.train_step

    def step(st, batch):
        if len(rec["marks"]) == 1 and prof is not None:
            prof.start()
        rec["marks"].append(time.perf_counter())
        st, m = orig(st, batch)
        rec["seen"].append(batch)
        rec["losses"].append(m["loss"])
        return st, m
    trainer.train_step = step
    t0 = time.perf_counter()
    try:
        state, _ = trainer.fit(state, source, retrace_budget=0, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()     # before the profiler's flush
    except BaseException as e:
        e.record = rec
        raise
    finally:
        del trainer.train_step
        if prof is not None and len(rec["marks"]) > 1:
            prof.stop()
    steps = len(rec["seen"])
    steady = t1 - rec["marks"][1]
    reading = {"steps": steps, "wall_s": t1 - t0,
               "examples_per_s": (steps - 1) * BATCH / steady,
               "step_ms": steady / (steps - 1) * 1e3,
               "builds": trainer.builds}
    if prof is not None:
        prof.export_chrome_trace(trace)
        busy = _device_busy_us(trace) / 1e6
        os.remove(trace)
        reading.update({"device_busy_s": busy,
                        "busy_share": busy / steady})
    return state, reading, rec


def _stream_reading(stream, t_open: float, t_end: float) -> dict:
    from openembedding_tpu_torch.analysis import scope
    mem = stream.memory_stats()
    spans = {}
    for kind, labels in (("read", {"stream": stream.name,
                                   "fmt": stream.fmt}),
                         ("hash", {"stream": stream.name}),
                         ("ring", {"stream": stream.name})):
        name = f"span_ingest_{kind}_seconds"
        spans[f"ingest.{kind}"] = {
            "count": scope.HISTOGRAMS.count(name, **labels),
            "total_s": scope.HISTOGRAMS.sum(name, **labels)}
    return {"stall": stream.stall_summary(),
            "stall_series_ms": [float(x) for x in stream.stall_stats()],
            "rows_read": mem["rows_read"],
            "reader_rows_per_s": mem["rows_read"] / (t_end - t_open),
            "readers": stream.readers, "spans": spans,
            "bad_rows": stream.bad_rows()}


def _same_batch(a, b) -> bool:
    return (np.array_equal(a["label"], b["label"])
            and np.array_equal(a["dense"], b["dense"])
            and a["sparse"].keys() == b["sparse"].keys()
            and all(np.array_equal(a["sparse"][k], b["sparse"][k])
                    and a["sparse"][k].dtype == b["sparse"][k].dtype
                    for k in a["sparse"]))


def _states_equal(a, b) -> dict:
    spread = _spread(state_tensors(a), state_tensors(b))
    spread["equal"] = spread["tensors"] == 0
    return spread


def ingest_fits(tmp: str, tsv: list) -> dict:
    """Phase 13's training half over the TSV shards ``tsv``, under
    deterministic algorithms (the bit gates need them): the streamed
    ``deepfm_dim9`` fit against the same batches in memory, a second read
    of the stream, the bad-row stream, the kill and the resume from the
    stream, then both fits again outside deterministic mode for their
    throughput. Returns the reading and the streamed run's trainer and
    state (for the layouts)."""
    import itertools
    from openembedding_tpu_torch.analysis import chaos
    from openembedding_tpu_torch.data.stream import ShardStream, \
        write_synthetic_shards
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.utils import observability
    reading = {}
    gated = tsv[:INGEST_STEPS * BATCH // INGEST_ROWS]   # 64 batches
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        # the streamed fit
        trainer, mapper = build_trainer("cuda")
        t_open = time.perf_counter()
        stream = _ingest_stream(gated, mapper, VOCAB_PER_FEATURE,
                                name="smoke_stream")
        with _ingest_stream(gated, mapper, VOCAB_PER_FEATURE,
                            name="smoke_first") as head:
            first = next(head)
        state = trainer.init(prng_key(SEED), first)
        records0 = observability.ingest_stall_records()
        state, fit_s, rec_s = _recorded_fit(
            trainer, state, stream, os.path.join(tmp, "streamed.json"))
        fit_s["stall_records"] = observability.ingest_stall_records() \
            - records0
        fit_s.update(_stream_reading(stream, t_open, time.perf_counter()))
        stream.close()
        # the same batches in memory, from a second stream of the shards
        mem_trainer, _ = build_trainer("cuda")
        t1 = time.perf_counter()
        second = _ingest_stream(gated, mapper, VOCAB_PER_FEATURE,
                                name="smoke_second")
        batches = list(second)
        materialize_s = time.perf_counter() - t1
        second.close()
        same_reads = len(batches) == len(rec_s["seen"]) and all(
            _same_batch(a, b) for a, b in zip(batches, rec_s["seen"]))
        mstate = mem_trainer.init(prng_key(SEED), batches[0])
        mstate, fit_m, rec_m = _recorded_fit(
            mem_trainer, mstate, batches, os.path.join(tmp, "memory.json"))
        fit_m["materialize_s"] = materialize_s
        losses_s = torch.stack(rec_s["losses"])
        losses_m = torch.stack(rec_m["losses"])
        reading["deterministic"] = {
            "streamed": fit_s, "in_memory": fit_m,
            "second_read_identical": same_reads,
            "losses_equal": bool(torch.equal(losses_s, losses_m)),
            "tables": _states_equal(state, mstate)}
        if not (same_reads and torch.equal(losses_s, losses_m)
                and reading["deterministic"]["tables"]["equal"]
                and fit_s["steps"] == fit_m["steps"] == INGEST_STEPS
                and fit_s["builds"] == fit_m["builds"] == 1
                and fit_s["bad_rows"] == 0
                and fit_s["stall_records"] == fit_s["stall"]["pops"]):
            raise AssertionError("streamed fit against in-memory: "
                                 + json.dumps(_brief(reading)))
        del mem_trainer, mstate, rec_m
        torch.cuda.empty_cache()

        # bad rows: each shard's mangled lines skipped and counted exactly
        bad = write_synthetic_shards(os.path.join(tmp, "bad"), num_shards=2,
                                     rows_per_shard=8192, fmt="tsv",
                                     seed=SEED + 1,
                                     bad_rows_per_shard=BAD_ROWS_PER_SHARD)
        with ShardStream(bad, batch_size=BATCH, name="smoke_bad") as bs:
            nbad = sum(1 for _ in bs)
            reading["bad_rows"] = {"batches": nbad, "counted": bs.bad_rows(),
                                   "written": 2 * BAD_ROWS_PER_SHARD}
        if reading["bad_rows"]["counted"] != 2 * BAD_ROWS_PER_SHARD:
            raise AssertionError(f"bad rows: {reading['bad_rows']}")

        # killed after step 40 (autosaves at 16 and 32), resumed from the
        # stream by a fresh trainer
        auto = os.path.join(tmp, "auto")
        killed, _ = build_trainer("cuda")
        killed.collection.enable_dirty_tracking()
        kstate = killed.init(prng_key(SEED), first)
        plan = chaos.FaultPlan([chaos.FaultSpec(
            point="trainer.fit.step", action="kill_thread",
            hit=INGEST_KILLED_AT + 1)])
        kstream = _ingest_stream(gated, mapper, VOCAB_PER_FEATURE,
                                 name="smoke_killed")
        try:
            with chaos.active_plan(plan):
                _recorded_fit(killed, kstate, kstream,
                              autosave_every=INGEST_AUTOSAVE,
                              autosave_dir=auto)
            raise AssertionError("the chaos kill did not fire")
        except chaos.ChaosKill as e:
            killed_steps = len(e.record["seen"])
        kstream.close()
        from openembedding_tpu_torch import checkpoint_delta as cd
        chain = cd.chain_state(auto)
        del killed, kstate
        torch.cuda.empty_cache()
        resumed, _ = build_trainer("cuda")
        resumed.collection.enable_dirty_tracking()
        rstate = resumed.init(prng_key(SEED), first)
        rstream = _ingest_stream(gated, mapper, VOCAB_PER_FEATURE,
                                 name="smoke_resumed")
        skips = []
        real_skip = rstream.skip_batches

        def spy(n):
            skips.append({"n": int(n), "cursor_before": rstream.cursor()})
            t = time.perf_counter()
            out = real_skip(n)
            skips[-1]["seconds"] = time.perf_counter() - t
            return out
        rstream.skip_batches = spy
        rstate, fit_r, rec_r = _recorded_fit(resumed, rstate, rstream,
                                             resume_from=auto)
        rstream.close()
        tail = losses_s[INGEST_STEPS - len(rec_r["losses"]):]
        resume = {"killed_after": killed_steps, "chain": chain,
                  "skips": skips, "steps": fit_r["steps"],
                  "builds": fit_r["builds"],
                  "losses_equal": bool(torch.equal(
                      torch.stack(rec_r["losses"]), tail)),
                  "tables": _states_equal(state, rstate),
                  "cursor": rstream.cursor()}
        reading["resume"] = resume
        if not (killed_steps == INGEST_KILLED_AT
                and [s["n"] for s in skips] == [2 * INGEST_AUTOSAVE]
                and skips[0]["cursor_before"] == 0
                and fit_r["steps"] == INGEST_STEPS - 2 * INGEST_AUTOSAVE
                and resume["losses_equal"] and resume["tables"]["equal"]
                and fit_r["builds"] == 1
                and rstream.cursor() == INGEST_STEPS):
            raise AssertionError("kill and resume: "
                                 + json.dumps(_brief(reading)))
        del resumed, rstate
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)

    # throughput outside deterministic mode and outside the profiler
    # (its tracing adds ~0.5 ms of host time a step), each on a program
    # built outside it: 64 steps over the whole shard set (8 shards, the
    # default readers) against the 64 batches held in memory
    tput = {}
    for kind in ("streamed", "in_memory"):
        tr, _ = build_trainer("cuda")
        t_open = time.perf_counter()
        st = tr.init(prng_key(SEED), first)
        if kind == "streamed":
            src = _ingest_stream(tsv, mapper, VOCAB_PER_FEATURE,
                                 name="smoke_tput")
            st, fit_t, _ = _recorded_fit(
                tr, st, itertools.islice(src, INGEST_STEPS))
            fit_t.update(_stream_reading(src, t_open, time.perf_counter()))
            src.close()
        else:
            st, fit_t, _ = _recorded_fit(tr, st, batches)
        tput[kind] = fit_t
        del tr, st
        torch.cuda.empty_cache()
    reading["throughput"] = tput
    reading["stream_over_memory"] = (tput["streamed"]["examples_per_s"]
                                     / tput["in_memory"]["examples_per_s"])
    reading["fit_loop_ab"] = fit_loop_ab(first, batches)
    return reading, trainer, state, rec_s["seen"][-1]


def _prior_fit(trainer, state, batches):
    """The loop ``fit`` ran before it took JAX's window (kept here to
    compare the two): launch the step, then fetch the next batch, its
    wall time recorded as the step's stall. Returns ``(state,
    examples/s over the steady window from step 2)``."""
    from openembedding_tpu_torch.utils import observability
    it, marks = iter(batches), []
    batch = next(it, None)
    while batch is not None:
        marks.append(time.perf_counter())
        state, _ = trainer.train_step(state, batch)
        t0 = time.perf_counter()
        batch = next(it, None)
        observability.record_ingest_stall(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return state, (len(marks) - 1) * BATCH / (time.perf_counter()
                                              - marks[1])


def fit_loop_ab(first, batches, blocks: int = 5) -> dict:
    """The captured ``deepfm_dim9`` fit in memory through ``fit`` (JAX's
    window of ``pipeline_depth + 1`` batches) and through the loop it ran
    before (``_prior_fit``), ``blocks`` blocks each over the same batches
    in turns on one trainer and state: examples/s, medians and spreads
    (max - min over median)."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    tr, _ = build_trainer("cuda")
    st = tr.init(prng_key(SEED), first)
    runs = {"window": [], "prior": []}
    for _ in range(blocks):
        st, r, _ = _recorded_fit(tr, st, batches)
        runs["window"].append(r["examples_per_s"])
        st, eps = _prior_fit(tr, st, batches)
        runs["prior"].append(eps)
    out = {"blocks": runs, "builds": tr.builds}
    for k, v in runs.items():
        med = statistics.median(v)
        out[f"{k}_median"] = med
        out[f"{k}_spread"] = (max(v) - min(v)) / med
    out["moved"] = out["window_median"] / out["prior_median"] - 1
    del tr, st
    torch.cuda.empty_cache()
    return out


def _brief(reading: dict) -> dict:
    """A reading without its long series (for an error message)."""
    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()
                    if k != "stall_series_ms"}
        return x
    return cut(reading)


def hash_ingest(tmp: str, tfr: list, twin: list) -> tuple:
    """The ``deepfm_dim9_hash`` twin trained from the TFRecord shards
    ``tfr`` (K2 and KI on its steps), its batches held against a stream
    of the TSV shards ``twin`` of the same seed where the JAX package's
    own streams agree (labels and dense features; the TSV reader adds 1
    to each categorical before hashing, the TFRecord one does not, in
    both packages). ``Trainer.init`` reads only the sample batch's column
    names, so the first TSV batch serves as the sample."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    reading = {}
    trainer, mapper = build_hash_trainer("cuda")
    with _ingest_stream(twin, mapper, HASH_VOCAB,
                        name="smoke_twin") as tsv_stream:
        tsv_batches = list(tsv_stream)
    state = trainer.init(prng_key(SEED), tsv_batches[0])
    t_open = time.perf_counter()
    stream = _ingest_stream(tfr, mapper, HASH_VOCAB, fmt="tfrecord",
                            name="smoke_tfrecord")
    state, fit_h, rec = _recorded_fit(trainer, state, stream,
                                      os.path.join(tmp, "hash.json"))
    fit_h.update(_stream_reading(stream, t_open, time.perf_counter()))
    stream.close()
    agree = [np.array_equal(a["label"], b["label"])
             and np.array_equal(a["dense"], b["dense"])
             for a, b in zip(rec["seen"], tsv_batches)]
    sparse_equal = sum(np.array_equal(a["sparse"]["fields"],
                                      b["sparse"]["fields"])
                       for a, b in zip(rec["seen"], tsv_batches))
    failures = {n: int(st.insert_failures) for n, st in state.emb.items()}
    reading.update({"fit": fit_h, "label_dense_equal_tsv": all(agree),
                    "batches_compared": len(agree),
                    "sparse_equal_tsv_batches": int(sparse_equal),
                    "keys_stored": {n: st.num_used()
                                    for n, st in state.emb.items()},
                    "insert_failures": failures})
    if not (fit_h["steps"] == HASH_INGEST_STEPS and all(agree)
            and len(agree) == HASH_INGEST_STEPS and fit_h["builds"] == 1
            and not any(failures.values())):
        raise AssertionError("hash twin from TFRecord: "
                             + json.dumps(_brief(reading)))
    return reading, trainer, state, rec["seen"][-1]


def _dir_bytes(path: str) -> int:
    from openembedding_tpu_torch.utils import fs
    if fs.is_remote(path):
        return int(fs._fs(path).du(path, total=True))
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _d, names in os.walk(path) for f in names)


def _hash_rows_by_key(st):
    """A hash table's live keys (joined, sorted) and rows in that order,
    on its device."""
    live = st.live()
    k = st.keys[live].to(torch.int64)
    k64 = (k[:, 1] << 32) | (k[:, 0] & 0xFFFFFFFF)
    order = torch.argsort(k64)
    return (k64[order], st.weights[live][order],
            {n: v[live][order] for n, v in st.slots.items()})


def _tables_equal(a, b, hashed: bool) -> bool:
    for name in a:
        if hashed:
            ka, wa, sa = _hash_rows_by_key(a[name])
            kb, wb, sb = _hash_rows_by_key(b[name])
            if not (torch.equal(ka, kb) and torch.equal(wa, wb)
                    and all(torch.equal(sa[n], sb[n]) for n in sa)):
                return False
        elif not (torch.equal(a[name].weights, b[name].weights)
                  and all(torch.equal(a[name].slots[n], b[name].slots[n])
                          for n in a[name].slots)):
            return False
    return True


def _legacy_npz(path: str) -> None:
    """Repack a local dump's ``var_*.d`` directories as the legacy
    single-file ``var_*.npz`` dumps."""
    for d in sorted(os.listdir(path)):
        if not d.endswith(".d"):
            continue
        vdir = os.path.join(path, d)
        np.savez(os.path.join(path, d[:-2] + ".npz"),
                 **{f[:-4]: np.load(os.path.join(vdir, f))
                    for f in os.listdir(vdir) if f.endswith(".npy")})
        shutil.rmtree(vdir)


def ingest_layouts(tmp: str, trainer, state, probe, htrainer, hstate,
                   hprobe) -> dict:
    """Phase 13's layouts: the streamed ``deepfm_dim9`` state saved
    uncompressed and zlib-compressed, the hash twin into ``memory://``,
    compressed and as a legacy npz repack; each reloaded into a fresh
    collection (every tensor equal; hash tables key by key) and served
    through ``POST /models`` and ``lookup_bin`` (K1 or K2 once a lookup);
    hash -> array and array -> hash conversion, rows per key; the
    uncompressed dump through the native reader."""
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch.embedding import EmbeddingCollection, \
        EmbeddingSpec
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.serving.native import NativeModel
    from openembedding_tpu_torch.serving.rest import ControllerServer
    from openembedding_tpu_torch.utils import fs
    reading = {"saves": {}, "reloads": {}, "served": {}}
    coll, hcoll = trainer.collection, htrainer.collection
    dumps = {"array_local": (os.path.join(tmp, "dump"), {}, coll, state),
             "array_zlib": (os.path.join(tmp, "dump_zlib"),
                            {"compress": "zlib"}, coll, state),
             "hash_memory": (f"{MEMORY_URI}/hash", {}, hcoll, hstate),
             "hash_zlib": (os.path.join(tmp, "hdump_zlib"),
                           {"compress": "zlib"}, hcoll, hstate),
             "hash_local": (os.path.join(tmp, "hdump"), {}, hcoll, hstate)}
    for what, (path, kw, c, st) in dumps.items():
        info = ck.save_checkpoint(path, c, st.emb, model_sign=what, **kw)
        nbytes = _dir_bytes(path)
        reading["saves"][what] = {
            "seconds": info["seconds"], "row_bytes": info["bytes"],
            "file_bytes": nbytes,
            "gb_per_s": info["bytes"] / info["seconds"] / 1e9}
    saves = reading["saves"]
    saves["zlib_over_local_bytes"] = (saves["array_zlib"]["file_bytes"]
                                      / saves["array_local"]["file_bytes"])
    saves["hash_zlib_over_local_bytes"] = (
        saves["hash_zlib"]["file_bytes"]
        / saves["hash_local"]["file_bytes"])
    legacy = os.path.join(tmp, "hdump_legacy")
    shutil.copytree(dumps["hash_local"][0], legacy)
    _legacy_npz(legacy)
    dumps["hash_legacy"] = (legacy, {}, hcoll, hstate)
    for what, (path, _kw, c, st) in dumps.items():
        fresh = EmbeddingCollection(list(c.specs.values()), device="cuda",
                                    seed=SEED)
        t0 = time.perf_counter()
        loaded = ck.load_checkpoint(path, fresh)
        torch.cuda.synchronize()
        equal = _tables_equal(st.emb, loaded, what.startswith("hash"))
        reading["reloads"][what] = {"seconds": time.perf_counter() - t0,
                                    "equal": equal}
        del loaded
        torch.cuda.empty_cache()
        if not equal:
            raise AssertionError(f"{what}: the reload differs from the "
                                 "saved tables")

    # serving every reload: K1 or K2 once a lookup
    server = ControllerServer(port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=600)
    try:
        for what, (path, _kw, _c, st) in dumps.items():
            hashed = what.startswith("hash")
            ids = hprobe if hashed else probe
            kernel = probe_gather if hashed else gather_rows
            t0 = time.perf_counter()
            status, body = _post(conn, "/models", json.dumps(
                {"model_uri": path, "model_sign": f"smoke-{what}",
                 "block": True}).encode())
            load_s = time.perf_counter() - t0
            if status != 201:
                raise AssertionError(f"POST /models {what}: HTTP {status} "
                                     f"{body!r}")
            sign = json.loads(body)["model_sign"]
            launches = kernel.launches
            for var in ("fields", "fields:linear"):
                rows, _ = lookup_bin(conn, sign, var, ids)
                if not np.array_equal(rows, _expected(st, var, ids,
                                                      hashed)):
                    raise AssertionError(f"{what}: served {var} rows "
                                         "differ from the trainer's")
            got = kernel.launches - launches
            reading["served"][what] = {"load_s": load_s, "lookups": 2,
                                       "kernel": kernel.__name__,
                                       "launches": got}
            if got != 2:
                raise AssertionError(f"{what}: {got} {kernel.__name__} "
                                     "launches for 2 lookups")
            if what == "array_local":
                served = {v: server.registry.lookup(sign, v, ids).cpu()
                          .numpy() for v in ("fields", "fields:linear")}
            server.registry.delete_model(sign)
            torch.cuda.empty_cache()
            conn.close()
            conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                              timeout=600)
    finally:
        conn.close()
        server.stop()

    # the native reader over the uncompressed deepfm_dim9 dump
    t0 = time.perf_counter()
    with NativeModel(dumps["array_local"][0]) as nm:
        open_s = time.perf_counter() - t0
        native_equal = all(
            np.array_equal(nm.lookup(v, probe.astype(np.int64)), served[v])
            for v in served)
    reading["native"] = {"open_s": open_s, "equal_registry": native_equal}
    if not native_equal:
        raise AssertionError("native reader rows differ from the "
                             "registry's")

    # hash -> array: the hash twin's dump into array variables over the
    # fused key space (26 x 2^22 ids), rows per key
    from openembedding_tpu_torch.data.criteo import SPARSE_NAMES
    vocab = len(SPARSE_NAMES) * HASH_VOCAB
    arr_coll = EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=vocab, output_dim=s.output_dim,
                       optimizer={"category": "default"})
         for n, s in hcoll.specs.items()], device="cuda")
    t0 = time.perf_counter()
    arr = ck.load_checkpoint(dumps["hash_zlib"][0], arr_coll)
    torch.cuda.synchronize()
    conv = {"hash_to_array_s": time.perf_counter() - t0}
    ok = True
    for name, st in hstate.emb.items():
        k64, w, _ = _hash_rows_by_key(st)
        ok &= bool(k64.min() >= 0) and bool(k64.max() < vocab) \
            and torch.equal(arr[name].weights.index_select(0, k64), w)
    conv["hash_to_array_equal"] = ok
    del arr, arr_coll
    torch.cuda.empty_cache()
    # array -> hash: the streamed deepfm_dim9 dump (27,262,976 rows) into
    # wide hash variables of twice as many slots, rounded up to a power
    # of two (2^26: load 0.41), each row id a key
    hash_coll = EmbeddingCollection(
        [EmbeddingSpec(name=n, input_dim=-1, output_dim=s.output_dim,
                       hash_capacity=1 << (2 * s.input_dim - 1).bit_length(),
                       optimizer={"category": "default"})
         for n, s in coll.specs.items()], device="cuda", seed=SEED)
    t0 = time.perf_counter()
    hashed = ck.load_checkpoint(dumps["array_local"][0], hash_coll)
    torch.cuda.synchronize()
    conv["array_to_hash_s"] = time.perf_counter() - t0
    launches = probe_gather.launches
    flat = probe.reshape(-1).astype(np.int64)
    rows = hash_coll.pull(hashed, {n: flat for n in hashed},
                          read_only=True)
    ok = all(torch.equal(rows[n], state.emb[n].weights.index_select(
        0, torch.from_numpy(flat).to(rows[n].device))) for n in hashed)
    conv["array_to_hash_equal"] = ok
    conv["array_to_hash_keys"] = {n: st.num_used()
                                  for n, st in hashed.items()}
    conv["array_to_hash_k2"] = probe_gather.launches - launches
    reading["conversion"] = conv
    del hashed, hash_coll, rows
    torch.cuda.empty_cache()
    if not (conv["hash_to_array_equal"] and conv["array_to_hash_equal"]
            and all(v == coll.specs[n].input_dim
                    for n, v in conv["array_to_hash_keys"].items())):
        raise AssertionError(f"conversion: {conv}")
    fs.rmtree(MEMORY_URI)
    return reading


def phase_ingest() -> dict:
    """Phase 13: ``deepfm_dim9`` trained from TSV shard files through a
    ``ShardStream`` (``ingest_fits``), its hash twin from TFRecord shards
    (``hash_ingest``) and every single-process checkpoint layout
    (``ingest_layouts``), files under a ``tempfile.mkdtemp()`` removed at
    the end. Prints one ``{"ingest": ...}`` and one ``{"layouts": ...}``
    line; returns the kernels' launches of the phase (counters zeroed at
    its start)."""
    import tempfile
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = (gather_rows, probe_gather, init_rows, init_flat)
    for w in wrappers:
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_ingest_")
    t0 = time.perf_counter()
    # the hash twin's shards are written by two child processes while
    # this one writes the TSV shards; all are joined before any fit
    children = [_spawn_shard_writer(os.path.join(tmp, d), TFR_SHARDS,
                                    TFR_ROWS, fmt)
                for d, fmt in (("tfr", "tfrecord"), ("twin", "tsv"))]
    try:
        tsv, seconds = _write_shards(os.path.join(tmp, "tsv"),
                                     INGEST_SHARDS, INGEST_ROWS, "tsv")
        shards_tsv = _shard_reading(tsv, seconds, INGEST_ROWS)
        (tfr, shards_tfr), (twin, _) = [_join_shard_writer(c)
                                        for c in children]
        ingest, trainer, state, probe = ingest_fits(tmp, tsv)
        hash_reading, htrainer, hstate, hbatch = hash_ingest(tmp, tfr,
                                                             twin)
        ingest["shards_tsv"] = shards_tsv
        ingest["hash_twin"] = {"shards_tfrecord": shards_tfr,
                               **hash_reading}
        layouts = ingest_layouts(tmp, trainer, state,
                                 probe["sparse"]["fields"], htrainer,
                                 hstate, hbatch["sparse"]["fields"])
    finally:
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    ingest["phase_s"] = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    ingest["launches"] = launches
    log(json.dumps({"ingest": ingest}))
    log(json.dumps({"layouts": layouts}))
    return launches


# --- phase 14: micro-batched, captured and replicated serving -----------------

SERVE_SIGN = "deepfm_dim9-serve"
HASH_SERVE_SIGN = "deepfm_dim9_hash-serve"
SERVE_DEVICE = "cuda"         # the device of the registries and replicas
SERVE_BATCH_ROWS = 1024       # --batch-rows of the batched replicas
SERVE_WAIT_US = 200           # the batcher's default window
SERVE_BATCHED_REPLICAS = 3
PARITY_REQUESTS = 96          # mixed-size requests of the parity gate
PARITY_THREADS = 16
DELTA_ROWS = 4096             # rows the hot-swap changes (one or two chunks)
DELTA_FIRST = 1 << 20
BUCKET_REPS = 20
STORM_IDS = 16                # ids a lookup_bin request (graftload's)
STORM_QPS0 = 200.0            # the sweep's first offered rate ...
STORM_STEP = 1.5              # ... times this a step, until saturated
STORM_RATE_S = 5.0
STORM_MIN_SAMPLES = 2000      # arrivals at each rate above the first
STORM_MAX_RATES = 9
STORM_WORKERS = 64
FAILOVER_S = 6.0
KILL_AT_S = 3.0
RESTORE_PROBE = 1 << 16       # ids compared after the peer restore
REPLICA_BOOT_S = 300.0
METRIC_NAMES = ("oe_serving_lookup_rows_bucket",
                "oe_serving_lookup_requests_total",
                "oe_serving_lookup_ids_total", "oe_batch_flushes_total",
                "oe_serving_batch_rows_bucket", "oe_serving_requests_total",
                "oe_span_http_seconds_bucket",
                "oe_span_serving_lookup_seconds_bucket")


def _event_ms(fn, reps: int = BUCKET_REPS) -> float:
    """Median over ``reps`` calls of ``fn`` (a host call that ends by
    copying to the host) between two CUDA events on the current stream:
    the call's wall time on the device's clock."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve_dump(tmp: str):
    """The ``deepfm_dim9`` tables (no slots: serving loads none) from the
    seed, saved as the base of a delta chain (copied to ``<path>_v0``);
    then ``DELTA_ROWS`` consecutive rows of each table changed and saved
    as delta 1 (its payload kept for ``apply_delta``). Returns the dump's
    path, the host rows of version 0 and 1, the delta and the save
    seconds."""
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.data.criteo import SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    specs, mapper = make_fused_specs(SPARSE_NAMES, VOCAB_PER_FEATURE, 9,
                                     optimizer={"category": "default"})
    coll = EmbeddingCollection(specs, device=SERVE_DEVICE, seed=SEED)
    coll.enable_dirty_tracking()
    states = coll.init()
    path = os.path.join(tmp, "dim9")
    t0 = time.perf_counter()
    ck.save_checkpoint(path, coll, states, mode="delta", step=0,
                       model_sign=SERVE_SIGN)
    save_s = time.perf_counter() - t0
    # version 0 alone, for the in-process hot-swap
    shutil.copytree(path, path + "_v0")
    host0 = {n: st.weights.to("cpu", copy=True).numpy()
             for n, st in states.items()}
    ids = np.arange(DELTA_FIRST, DELTA_FIRST + DELTA_ROWS, dtype=np.int64)
    tids = torch.from_numpy(ids).to(coll.device)
    for st in states.values():
        st.weights.index_add_(0, tids, torch.full(
            (ids.size, st.weights.shape[1]), 0.25, device=coll.device))
    coll.mark_dirty({n: ids for n in states})
    delta = cd.save_delta(path, coll, states, step=1, return_payload=True,
                          compact_bytes_ratio=1e18,
                          background_compact=False)["delta"]
    host1 = {n: st.weights.cpu().numpy() for n, st in states.items()}
    return path, mapper, host0, host1, delta, save_s


def _hash_dump(tmp: str):
    """The ``deepfm_dim9_hash`` tables filled to load 0.5 (phase 5's
    keys and seeded rows), saved without slots. Returns the path, the
    served request batches, the stored keys and each table's host
    dictionary."""
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch.data.criteo import SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.hash_table import split64
    from openembedding_tpu_torch.optim.initializers import fold_in, prng_key
    specs, mapper = make_fused_specs(
        SPARSE_NAMES, -1, 9, hash_capacity=HASH_CAPACITY,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    coll = EmbeddingCollection(specs, device=SERVE_DEVICE, seed=SEED)
    states = coll.init()
    batches, keys64 = hash_keys(mapper)
    pairs = torch.from_numpy(split64(keys64)).to(coll.device)
    host = {name: HostRows(keys64, fill_hash(
        st, pairs, fold_in(prng_key(SEED), coll.variable_id(name)))
        .cpu().numpy()) for name, st in states.items()}
    path = os.path.join(tmp, "hash")
    ck.save_checkpoint(path, coll, states, include_optimizer=False,
                       model_sign=HASH_SERVE_SIGN)
    return path, batches, keys64, host


def _concurrent(calls):
    """Run ``calls`` (thunks) from ``PARITY_THREADS`` threads started
    together; their results in order (an exception re-raises)."""
    import threading
    out = [None] * len(calls)
    errors = []
    barrier = threading.Barrier(PARITY_THREADS)

    def worker(k):
        barrier.wait()
        for i in range(k, len(calls), PARITY_THREADS):
            try:
                out[i] = calls[i]()
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(PARITY_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    return out


def _parity_requests(vocab: int, rng) -> list:
    """Mixed-size flat requests (1 to 1024 ids, int32 and int64, invalid
    ids among them) for both variables."""
    sizes = [1, 2, 15, 16, 17, 63, 64, 65, 200, 511, 1000, 1024]
    out = []
    for i in range(PARITY_REQUESTS):
        n = sizes[i % len(sizes)] if i < 2 * len(sizes) \
            else int(rng.randint(1, SERVE_BATCH_ROWS + 1))
        ids = rng.randint(-2, vocab + 2, n).astype(
            (np.int32, np.int64)[(i // 2) % 2])
        out.append((("fields", "fields:linear")[i % 2], ids))
    return out


def _buckets() -> list:
    out, cap = [], 64
    while cap <= SERVE_BATCH_ROWS:
        out.append(cap)
        cap <<= 1
    return out


def _bucket_reading(model, cases, want_of, timed: bool) -> list:
    """Each case ``(variable, ids)`` (a whole bucket) through the captured
    bucket pull and the eager pull on the model's current snapshot: rows
    equal bit for bit and equal to ``want_of(variable, ids)``. The
    captured pull runs twice: a bucket first met on this snapshot is
    captured by its first call, and replayed by the second. With
    ``timed``, each call's median time (``_event_ms``)."""
    out = []
    for name, ids in cases:
        states = model.states
        first = model.pull_bucket(name, ids, states, span=False)
        captured = model.pull_bucket(name, ids, states, span=False)
        eager = model._lookup_impl(name, ids, states, record=False,
                                   span=False).cpu().numpy()
        if not (np.array_equal(first, eager)
                and np.array_equal(captured, eager)
                and np.array_equal(eager, want_of(name, ids))):
            raise AssertionError(f"bucket pull of {name} {ids.dtype} "
                                 f"{ids.shape}: captured, eager and host "
                                 "rows differ")
        row = {"variable": name, "dtype": str(ids.dtype),
               "shape": list(ids.shape)}
        if timed:
            row["captured_ms"] = _event_ms(
                lambda: model.pull_bucket(name, ids, states, span=False))
            row["eager_ms"] = _event_ms(
                lambda: model._lookup_impl(name, ids, states, record=False,
                                           span=False).cpu())
        out.append(row)
    return out


def serve_in_process(path: str, host0, host1, delta) -> dict:
    """Phase 14's in-process gates on the ``deepfm_dim9`` dump at version
    0 (``<path>_v0``; the replicas load ``path`` at version 1):
    ``warm_batch_programs``; concurrent mixed requests whose batched
    rows equal the unbatched ones and the host's; each bucket's captured
    pull against the eager one, timed; the delta hot-swapped and the
    captured pulls (captured anew) equal the new version's rows."""
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    from openembedding_tpu_torch.utils import observability as obs
    base = path + "_v0"
    reg = ModelRegistry(device=SERVE_DEVICE)
    reg.enable_batching(max_batch_rows=SERVE_BATCH_ROWS,
                        max_wait_us=SERVE_WAIT_US)
    try:
        sign = reg.create_model(base, model_sign=SERVE_SIGN)
        model = reg.find_model(sign)
        if model.version != 0:
            raise AssertionError(f"base loaded at version {model.version}")
        t0 = time.perf_counter()
        warmed = reg.warm_batch_programs()
        warm_s = time.perf_counter() - t0
        graphs = model.graph_reading()
        vocab = host0["fields"].shape[0]
        rng = np.random.RandomState(SEED + 14)
        reqs = _parity_requests(vocab, rng)
        flushes0 = obs.GLOBAL.snapshot().get("batch_flushes",
                                             {}).get("count", 0)
        batched = _concurrent([lambda v=v, ids=ids: reg.lookup(sign, v, ids)
                               for v, ids in reqs])
        flushes = obs.GLOBAL.snapshot()["batch_flushes"]["count"] - flushes0
        for (v, ids), got in zip(reqs, batched):
            direct = model.lookup(v, ids).cpu().numpy()
            if not (np.array_equal(got, direct)
                    and np.array_equal(got, expected_rows(host0[v], ids))):
                raise AssertionError(f"batched {v} {ids.dtype} "
                                     f"[{ids.size}] differs")
        cases = [(v, rng.randint(0, vocab, cap).astype(dt))
                 for cap in _buckets() for dt in (np.int32, np.int64)
                 for v in ("fields", "fields:linear")]
        buckets = _bucket_reading(
            model, cases, lambda v, ids: expected_rows(host0[v], ids), True)
        res = reg.apply_delta(sign, delta)
        if not res["applied"] or model.version != 1:
            raise AssertionError(f"apply_delta: {res}")
        # the first flushes on the new snapshot capture its buckets while
        # other threads launch eager lookups above the row cap
        touched = np.arange(DELTA_FIRST - 8, DELTA_FIRST + 56,
                            dtype=np.int32)
        reqs = _parity_requests(vocab, rng) + [
            (v, np.concatenate([touched, rng.randint(
                0, vocab, 4 * SERVE_BATCH_ROWS).astype(np.int32)]))
            for v in ("fields", "fields:linear") for _ in range(8)]
        got = _concurrent([lambda v=v, ids=ids: reg.lookup(sign, v, ids)
                           for v, ids in reqs])
        for (v, ids), rows in zip(reqs, got):
            if isinstance(rows, torch.Tensor):
                rows = rows.cpu().numpy()
            if not np.array_equal(rows, expected_rows(host1[v], ids)):
                raise AssertionError(f"{v} [{ids.size}] after the swap, "
                                     "beside captures, differs")
        after = [(v, np.concatenate([touched, rng.randint(
            0, vocab, cap - touched.size).astype(np.int32)]))
            for cap in _buckets() for v in ("fields", "fields:linear")]
        after += [(v, ids.astype(np.int64)) for v, ids in after]
        swapped = _bucket_reading(
            model, after, lambda v, ids: expected_rows(host1[v], ids), False)
        batched1 = reg.lookup(sign, "fields", touched)
        if not np.array_equal(batched1, expected_rows(host1["fields"],
                                                      touched)):
            raise AssertionError("batched lookup after the swap differs")
        return {"warm_batch_programs": warmed, "warm_s": warm_s,
                "graphs": graphs, "graphs_after_swap": model.graph_reading(),
                "parity_requests": PARITY_REQUESTS,
                "parity_flushes": flushes, "buckets": buckets,
                "swap_requests": len(reqs), "swap_cases": len(swapped)}
    finally:
        reg.close()
        shutil.rmtree(base, ignore_errors=True)


def serve_hash_in_process(path: str, batches, keys64, host) -> dict:
    """The hash twin's gates in process: batched pair, narrow int32 and
    int64 requests equal to the unbatched rows and the host dictionary;
    each bucket's captured pull against the eager one, timed."""
    from openembedding_tpu_torch.hash_table import split64
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    reg = ModelRegistry(device=SERVE_DEVICE)
    reg.enable_batching(max_batch_rows=SERVE_BATCH_ROWS,
                        max_wait_us=SERVE_WAIT_US)
    try:
        sign = reg.create_model(path, model_sign=HASH_SERVE_SIGN)
        model = reg.find_model(sign)
        t0 = time.perf_counter()
        warmed = reg.warm_batch_programs()
        warm_s = time.perf_counter() - t0
        rng = np.random.RandomState(SEED + 15)
        flat = np.concatenate([b.reshape(-1, 2) for b in batches[:2]])
        narrow_keys = keys64[keys64 < 2**31]
        reqs = []
        for i in range(PARITY_REQUESTS):
            n = int(rng.randint(1, SERVE_BATCH_ROWS + 1))
            v = ("fields", "fields:linear")[i % 2]
            pick = flat[rng.randint(0, flat.shape[0], n)].copy()
            pick[::9] = split64(rng.randint(1 << 40, 1 << 41, pick[::9]
                                            .shape[0]))     # misses
            kind = (i // 2) % 3
            if kind == 0:
                reqs.append((v, pick))
            else:
                j = narrow_keys[rng.randint(0, narrow_keys.size, n)]
                reqs.append((v, j.astype(np.int32 if kind == 1
                                         else np.int64)))
        got = _concurrent([lambda v=v, q=q: reg.lookup(sign, v, q)
                           for v, q in reqs])
        for (v, q), rows in zip(reqs, got):
            want = host[v].expect(q if q.ndim == 2 else q.astype(np.int64))
            if not (np.array_equal(rows, model.lookup(v, q).cpu().numpy())
                    and np.array_equal(rows, want)):
                raise AssertionError(f"hash batched {v} {q.dtype} "
                                     f"{q.shape} differs")
        cases = []
        for cap in _buckets():
            pick = flat[rng.randint(0, flat.shape[0], cap)]
            narrow = narrow_keys[rng.randint(0, narrow_keys.size, cap)]
            cases += [("fields", pick), ("fields", narrow.astype(np.int32)),
                      ("fields:linear", pick)]
        buckets = _bucket_reading(
            model, cases,
            lambda v, q: host[v].expect(q if q.ndim == 2
                                        else q.astype(np.int64)), True)
        return {"warm_batch_programs": warmed, "warm_s": warm_s,
                "graphs": model.graph_reading(),
                "parity_requests": len(reqs), "buckets": buckets}
    finally:
        reg.close()


def _replica_output(proc) -> str:
    """A replica's whole output, after it has ended."""
    try:
        out, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return out or ""


def _stop_replicas(procs) -> dict:
    """SIGTERM every live replica (an orderly shutdown that reports its
    kernel launches), SIGKILL a straggler; the launch sums."""
    import signal
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    sums = {"gather_rows": 0, "probe_gather": 0, "find_or_insert": 0}
    for p in procs:
        for line in _replica_output(p).splitlines():
            if line.startswith("replica: kernel launches "):
                for k, v in json.loads(line.split("launches ", 1)[1]).items():
                    sums[k] += v
    return sums


def _await_replicas(procs, eps, sign) -> list:
    from openembedding_tpu_torch.serving.ha import wait_ready
    t0 = time.perf_counter()
    ready = []
    for p, ep in zip(procs, eps):
        if not wait_ready(ep, REPLICA_BOOT_S, sign=sign):
            p.kill()
            raise AssertionError(f"replica {ep} not ready: "
                                 f"{_replica_output(p)[-3000:]}")
        ready.append(time.perf_counter() - t0)
    return ready


def _storm_line(label: str, res, extra=None) -> dict:
    s = res.summary()
    s.update(extra or {})
    log(f"storm {label}: offered {s['offered_qps']:.1f} QPS, achieved "
        f"{s['achieved_qps']:.1f}, p50 {s['p50_ms']:.3f} p95 "
        f"{s['p95_ms']:.3f} p99 {s['p99_ms']:.3f} ms, {s['calls']} calls, "
        f"{s['errors']} errors, {s['rejected']} rejected, sender late p99 "
        f"{s['late_p99_ms']:.3f} ms")
    return s


def sweep(router, label: str, vocab: int, eps, seed: int):
    """Offered rates from ``STORM_QPS0``, x ``STORM_STEP`` a step, until a
    rate is not sustained (``find_knee``): each ``STORM_RATE_S`` seconds
    (and ``STORM_MIN_SAMPLES`` arrivals above the first) of Poisson
    ``lookup_bin`` requests of ``STORM_IDS`` uniform ids. Returns the
    storms' summaries (with the batcher counters each moved) and the
    knee's summary."""
    from openembedding_tpu_torch.serving import load
    results, out = [], []
    rate = STORM_QPS0
    for k in range(STORM_MAX_RATES):
        duration = STORM_RATE_S if k == 0 \
            else max(STORM_RATE_S, STORM_MIN_SAMPLES / rate)
        before = load.scrape_batch_stats(eps)
        res = load.run_storm(
            load.make_rest_sender(router, SERVE_SIGN, "fields", vocab,
                                  STORM_IDS, seed=seed + k),
            load.poisson_arrivals(rate, duration, seed=seed + k),
            route=label, offered_qps=rate, duration=duration,
            workers=STORM_WORKERS)
        after = load.scrape_batch_stats(eps)
        moved = {key: after.get(key, 0.0) - before.get(key, 0.0)
                 for key in after}
        if moved.get("batch_flushes"):
            moved["requests_per_flush"] = moved["batch_requests"] \
                / moved["batch_flushes"]
            moved["rows_per_flush"] = moved["batch_rows"] \
                / moved["batch_flushes"]
        results.append(res)
        out.append(_storm_line(f"{label} #{k}", res, {"batcher": moved}))
        if load.find_knee(results) is not res:
            break
        rate *= STORM_STEP
    knee = load.find_knee(results)
    return out, (knee.summary() if knee is not None else None)


def _check_rows(ep: str, sign: str, host, rng, vocab: int) -> int:
    """Lookups through one replica equal the host rows (``host``: the
    version the replica loaded): int32 and int64 requests, a bucket-sized
    one and one above the row cap (the direct path), each with ids the
    delta changed."""
    from openembedding_tpu_torch.serving.ha import RoutingClient
    n = 0
    touched = np.arange(DELTA_FIRST - 4, DELTA_FIRST + 12)
    with RoutingClient([ep], timeout=60) as rc:
        for size, dt in ((16, np.int32), (1000, np.int64),
                         (4 * SERVE_BATCH_ROWS, np.int32)):
            ids = np.concatenate([touched, rng.randint(
                -1, vocab + 1, size - touched.size)]).astype(dt)
            for v in ("fields", "fields:linear"):
                if not np.array_equal(rc.lookup(sign, v, ids),
                                      expected_rows(host[v], ids)):
                    raise AssertionError(f"replica {ep}: {v} {dt} "
                                         f"[{size}] differs")
                n += 1
    return n


def failover(router, procs, eps, rate: float, vocab: int) -> dict:
    """A ``FAILOVER_S`` storm at ``rate`` through the batched replicas,
    one of them SIGKILLed ``KILL_AT_S`` seconds in: no read may fail."""
    import signal
    import threading
    from openembedding_tpu_torch.serving import load
    victim = procs[1]
    timer = threading.Timer(KILL_AT_S + 0.05,
                            lambda: victim.send_signal(signal.SIGKILL))
    timer.start()
    try:
        res = load.run_storm(
            load.make_rest_sender(router, SERVE_SIGN, "fields", vocab,
                                  STORM_IDS, seed=SEED + 99),
            load.poisson_arrivals(rate, FAILOVER_S, seed=SEED + 99),
            route="failover", offered_qps=rate, duration=FAILOVER_S,
            workers=STORM_WORKERS)
    finally:
        timer.cancel()
    victim.wait(60)
    _replica_output(victim)
    reading = _storm_line("failover", res, {"killed": eps[1],
                                            "kill_at_s": KILL_AT_S})
    if res.errors:
        raise AssertionError(f"failover storm: {res.errors} failed reads "
                             f"({getattr(res, 'first_error', '')})")
    return reading


def restore_from_peers_reading(path: str, eps, ports, rng, vocab) -> tuple:
    """Respawn the killed replica with ``--peers`` while the dump is
    unreadable: it restores from a living peer's rows; its rows must
    equal a survivor's for ``RESTORE_PROBE`` ids of each variable."""
    from openembedding_tpu_torch.serving.ha import RoutingClient, spawn_replica
    gone = path + "_gone"
    os.rename(path, gone)
    try:
        t0 = time.perf_counter()
        proc = spawn_replica(ports[1], peers=[eps[0], eps[2]],
                             batch_rows=SERVE_BATCH_ROWS,
                             device=SERVE_DEVICE)
        _await_replicas([proc], [eps[1]], SERVE_SIGN)
        restore_s = time.perf_counter() - t0
    finally:
        os.rename(gone, path)
    probe = np.concatenate([
        np.arange(0, 64), np.arange(DELTA_FIRST - 8, DELTA_FIRST + 56),
        np.arange(vocab - 64, vocab),
        rng.randint(0, vocab, RESTORE_PROBE - 192)]).astype(np.int64)
    with RoutingClient([eps[1]], timeout=120) as fresh, \
            RoutingClient([eps[0]], timeout=120) as survivor:
        for v in ("fields", "fields:linear"):
            got = fresh.lookup(SERVE_SIGN, v, probe)
            if not np.array_equal(got, survivor.lookup(SERVE_SIGN, v,
                                                       probe)):
                raise AssertionError(f"peer-restored {v} rows differ from "
                                     "the survivor's")
    return proc, {"restore_s": restore_s, "probed_ids": int(probe.size)}


def _metric_names(ep: str) -> list:
    import urllib.request
    with urllib.request.urlopen(f"http://{ep}/metrics", timeout=30) as r:
        body = r.read().decode()
    missing = [n for n in METRIC_NAMES if n not in body]
    if missing:
        raise AssertionError(f"/metrics of {ep} lacks {missing}")
    return [n for n in METRIC_NAMES]


def _hash_storm(router, keys64, rate: float) -> dict:
    """One storm on the hash replica: 16 stored keys a request, as
    int32 pairs."""
    from openembedding_tpu_torch.hash_table import split64
    from openembedding_tpu_torch.serving import load
    rng = np.random.RandomState(SEED + 7)
    pool = split64(keys64[rng.randint(0, keys64.size, (256, STORM_IDS))])

    def send(i):
        rows = router.lookup(HASH_SERVE_SIGN, "fields", pool[i % 256])
        if rows.shape[0] != STORM_IDS:
            raise RuntimeError(f"short read: {rows.shape}")

    res = load.run_storm(send, load.poisson_arrivals(rate, STORM_RATE_S,
                                                     seed=SEED + 7),
                         route="hash", offered_qps=rate,
                         duration=STORM_RATE_S, workers=STORM_WORKERS)
    return _storm_line("hash", res)


def phase_serving_batched() -> dict:
    """Phase 14: micro-batched, captured and replicated serving of
    ``deepfm_dim9`` (and one storm of ``deepfm_dim9_hash``) under open
    load (module docstring). Prints one ``{"serving_batched": ...}``
    line; returns the kernels' launches: in this process (its counters
    zeroed at the start) plus the replicas' own, as each reports them
    at its orderly shutdown."""
    import tempfile
    from openembedding_tpu_torch.hash_table import split64
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.serving.ha import RoutingClient, spawn_replica
    wrappers = (gather_rows, probe_gather)
    for w in wrappers:
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_serve_")
    t0 = time.perf_counter()
    procs, routers = [], []
    reading = {}
    try:
        path, _mapper, host0, host1, delta, save_s = _serve_dump(tmp)
        hpath, hbatches, keys64, hhost = _hash_dump(tmp)
        torch.cuda.empty_cache()
        reading["dump_save_s"] = save_s
        reading["in_process"] = serve_in_process(path, host0, host1, delta)
        reading["hash_in_process"] = serve_hash_in_process(
            hpath, hbatches, keys64, hhost)
        in_process = {w.__name__: w.launches for w in wrappers}
        del host0
        torch.cuda.empty_cache()
        vocab = host1["fields"].shape[0]
        ports = [_free_port() for _ in range(SERVE_BATCHED_REPLICAS + 2)]
        eps = [f"127.0.0.1:{p}" for p in ports]
        load_arg = [f"{SERVE_SIGN}={path}"]
        for p in ports[:SERVE_BATCHED_REPLICAS]:
            procs.append(spawn_replica(p, load=load_arg,
                                       batch_rows=SERVE_BATCH_ROWS,
                                       device=SERVE_DEVICE))
        procs.append(spawn_replica(ports[-2], load=load_arg,
                                   device=SERVE_DEVICE))
        procs.append(spawn_replica(
            ports[-1], load=[f"{HASH_SERVE_SIGN}={hpath}"],
            batch_rows=SERVE_BATCH_ROWS, device=SERVE_DEVICE))
        reading["replicas_ready_s"] = _await_replicas(
            procs[:-1], eps[:-1], SERVE_SIGN) + _await_replicas(
            procs[-1:], eps[-1:], HASH_SERVE_SIGN)
        rng = np.random.RandomState(SEED + 16)
        reading["replica_lookups_checked"] = sum(
            _check_rows(ep, SERVE_SIGN, host1, rng, vocab)
            for ep in eps[:-1])
        batched_eps = eps[:SERVE_BATCHED_REPLICAS]
        batched = RoutingClient(batched_eps, timeout=30)
        unbatched = RoutingClient([eps[-2]], timeout=30)
        routers += [batched, unbatched]
        reading["batched"], knee_b = sweep(batched, "batched", vocab,
                                           batched_eps, SEED + 20)
        reading["unbatched"], knee_u = sweep(unbatched, "unbatched", vocab,
                                             [eps[-2]], SEED + 40)
        reading["knee_batched"], reading["knee_unbatched"] = knee_b, knee_u
        reading["metrics"] = _metric_names(batched_eps[0])
        rate = (knee_b["offered_qps"] if knee_b else STORM_QPS0) / 2
        reading["failover"] = failover(batched, procs, eps, rate, vocab)
        procs[1], reading["peer_restore"] = restore_from_peers_reading(
            path, eps, ports, rng, vocab)
        hrouter = RoutingClient([eps[-1]], timeout=30)
        routers.append(hrouter)
        pairs = split64(keys64[rng.randint(0, keys64.size, 4096)])
        for v in ("fields", "fields:linear"):
            if not np.array_equal(hrouter.lookup(HASH_SERVE_SIGN, v, pairs),
                                  hhost[v].expect(pairs)):
                raise AssertionError(f"hash replica {v} rows differ")
        reading["hash_storm"] = _hash_storm(hrouter, keys64, rate)
    finally:
        for r in routers:
            r.close()
        replica_launches = _stop_replicas(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    reading["phase_s"] = time.perf_counter() - t0
    reading["launches_in_process"] = in_process
    reading["launches_replicas"] = replica_launches
    launches = {k: in_process[k] + replica_launches[k] for k in in_process}
    reading["launches"] = launches
    log(json.dumps({"serving_batched": reading}))
    idle = [f"{where} {k}" for where, counts in (
        ("in process", in_process), ("in the replicas", replica_launches))
        for k, n in counts.items() if not n and k in in_process]
    launches["find_or_insert_replicas"] = replica_launches["find_or_insert"]
    if idle:
        raise AssertionError(f"phase 14 launched no {', no '.join(idle)}")
    return launches


# --- phase 15: host offload (offload_ab_k4) -----------------------------------

OFFLOAD_VOCAB = 50_000_000     # offload_ab_* (bench.py:1662-1670)
OFFLOAD_CACHE = 1 << 22
OFFLOAD_DIM = 8
OFFLOAD_CTX = 100_000
OFFLOAD_ZIPF = 1.08
OFFLOAD_SMALL_CACHE = 1 << 16  # smaller than the working set: evicts
OFFLOAD_CHECK_STEPS = 4        # card steps held against CPU steps
OFFLOAD_EVICT_STEPS = 48       # steps through the small cache
OFFLOAD_WARMUP = 3
OFFLOAD_TIMED = 32             # timed steps a mode and a round
OFFLOAD_ROUNDS = 2             # rounds of serial, K=1, K=4 in turns
OFFLOAD_TRACE_STEPS = 10
OFFLOAD_SYNC_STEPS = 4         # hand-driven K=4 steps under sync debug
OFFLOAD_DEVICE = "cuda"
OFFLOAD_SAMPLE = 1 << 20       # untouched store rows compared bit for bit
BIGVOCAB = 400_000_000         # offload_bigvocab (bench.py:1650)
BIGVOCAB_STEPS = 24            # its timed K=4 steps


def _zipf_uid_batch_maker(rng, batch, vocab, zipf_a):
    """bench.py's synthetic stream of the offload benches (copied, not
    imported): zipf-skewed ``uid`` over the whole store, a bounded
    ``ctx``."""
    def make_batch():
        z = rng.zipf(zipf_a, size=batch)
        uid = ((z * 2654435761) % vocab).astype(np.int32)
        ctx = rng.randint(0, OFFLOAD_CTX, batch).astype(np.int32)
        return {"label": (rng.rand(batch) > 0.75).astype(np.float32),
                "dense": rng.randn(batch, 13).astype(np.float32),
                "sparse": {"uid": uid, "uid:linear": uid,
                           "ctx": ctx, "ctx:linear": ctx}}
    return make_batch


def build_offload_trainer(device, cache=None, backing=None, depth=4,
                          offloaded=True, vocab=None, mesh=None):
    """``run_offload``'s trainer (bench.py:286-341): ``uid`` and
    ``uid:linear`` as ``ShardedOffloadedTable`` s (vocab 5 x 10^7, dims 8
    and 1, Adagrad 0.01, constant 0.01, host store a disk memmap under
    ``backing`` when given), ``ctx`` and ``ctx:linear`` array tables of
    10^5 rows, ``DeepFM`` over (uid, ctx), dense Adagrad 0.01.
    ``offloaded=False``: ``uid`` as in-HBM array tables instead, the same
    configs. ``cache``: rows of each cache (``OFFLOAD_CACHE`` unless
    given); ``vocab``: the host stores' rows (``OFFLOAD_VOCAB`` unless
    given, ``offload_bigvocab``'s 4 x 10^8); ``mesh``: a one-process
    ``(data, model)`` shape every table shards over (the caches too, as
    ``run_offload`` builds them on its mesh), else one device. Returns
    ``(trainer, {name: table})``."""
    cache = cache or OFFLOAD_CACHE
    vocab = vocab or OFFLOAD_VOCAB
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.meta import EmbeddingVariableMeta
    from openembedding_tpu_torch.models import deepctr
    from openembedding_tpu_torch.offload import ShardedOffloadedTable
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.training import Trainer
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    opt = {"category": "adagrad", "learning_rate": 0.01}
    init = {"category": "constant", "value": 0.01}
    where = {"device": device} if mesh is None \
        else {"mesh": create_mesh(*mesh, device=device)}
    tables = {}
    if offloaded:
        tables = {name: ShardedOffloadedTable(
            name, EmbeddingVariableMeta(embedding_dim=d,
                                        vocabulary_size=vocab),
            opt, init, vocab=vocab, cache_capacity=cache,
            backing_dir=backing, **where)
            for name, d in (("uid", OFFLOAD_DIM), ("uid:linear", 1))}
        uid_specs = tuple(t.embedding_spec() for t in tables.values())
    else:
        uid_specs = tuple(
            EmbeddingSpec(name=name, input_dim=vocab, output_dim=d,
                          optimizer=opt, initializer=init)
            for name, d in (("uid", OFFLOAD_DIM), ("uid:linear", 1)))
    specs = uid_specs + (
        EmbeddingSpec(name="ctx", input_dim=OFFLOAD_CTX,
                      output_dim=OFFLOAD_DIM, optimizer=opt),
        EmbeddingSpec(name="ctx:linear", input_dim=OFFLOAD_CTX,
                      output_dim=1, optimizer=opt))
    coll = EmbeddingCollection(specs, **where)
    trainer = Trainer(deepctr.build_model("deepfm", ("uid", "ctx"),
                                          embedding_dim=OFFLOAD_DIM),
                      coll, dense.adagrad(0.01), offload=tables,
                      pipeline_depth=depth)
    return trainer, tables


def _offload_steps(trainer, state, batches, prefetch: bool):
    """Steps over ``batches``, hand-driven as bench.py drives them (with
    ``prefetch`` of the batch and ``pipeline_depth`` after it, or
    serially); the losses as floats, read after the last step."""
    losses = []
    for i, b in enumerate(batches):
        if prefetch:
            trainer.prefetch(batches[i:i + 1 + trainer.pipeline_depth])
        state, m = trainer.train_step(state, b)
        losses.append(m["loss"])
    return state, [float(x) for x in losses]


def _join_tables(tables, state):
    """Flush every dirty row of every table and join the writers (a join
    point: the host stores are current after it)."""
    for name, t in tables.items():
        t.finish()
        t.flush(state.emb[name])
        t._join_writeback()


def _store_close(what, a, b, exact, rng) -> float:
    """Two tables' host stores: the rows either stamped (touched), exactly
    or within atol 1e-5 + rtol 1e-4, with their work ids, and a sample
    of ``OFFLOAD_SAMPLE`` untouched rows bit for bit; the largest
    difference."""
    stamped = (a.host_work_id > 0) | (b.host_work_id > 0)
    touched = np.nonzero(stamped)[0]
    sample = rng.randint(0, a.vocab, OFFLOAD_SAMPLE)
    sample = sample[~stamped[sample]]
    worst = 0.0
    for name, x, y in [("weights", a.host_weights, b.host_weights)] + [
            (k, a.host_slots[k], b.host_slots[k]) for k in a.host_slots]:
        xs, ys = x[touched], y[touched]
        diff = float(np.abs(xs - ys).max()) if xs.size else 0.0
        worst = max(worst, diff)
        ok = np.array_equal(xs, ys) if exact else np.allclose(
            xs, ys, atol=1e-5, rtol=1e-4)
        if not ok or not np.array_equal(x[sample], y[sample]):
            raise AssertionError(f"{what}: host {name} differ (largest "
                                 f"difference {diff})")
    if not np.array_equal(a.host_work_id[touched], b.host_work_id[touched]):
        raise AssertionError(f"{what}: host work ids differ")
    return worst


def _keys_equal(what, sa, sb, names=("uid", "uid:linear")) -> None:
    for name in names:
        if not torch.equal(sa.emb[name].keys.cpu(), sb.emb[name].keys.cpu()):
            raise AssertionError(f"{what}: {name} cache keys differ")


def _rel_close(what, got, want, rtol=1e-4) -> None:
    if not np.allclose(got, want, rtol=rtol, atol=0):
        raise AssertionError(f"{what}: losses {got} against {want}")


def offload_gates(make_batch, tmp) -> dict:
    """The correctness gates, under deterministic algorithms: a card
    trainer driven serially (host store a memmap) and one prefetched at
    K=4 from the same seed, and a CPU trainer from the card state's copy,
    ``OFFLOAD_CHECK_STEPS`` steps each; then the in-HBM array twin; then
    the small cache against a CPU twin, evicting."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.training import copy_state
    check = [make_batch() for _ in range(OFFLOAD_CHECK_STEPS + 1)]
    out = {}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        t_ser, tab_ser = build_offload_trainer(
            OFFLOAD_DEVICE, backing=os.path.join(tmp, "store"))
        out["alloc_s"] = time.perf_counter() - t0
        out["store_bytes"] = sum(t.memory_stats()["store_bytes"]
                                 for t in tab_ser.values())
        out["store_memmap"] = bool(tab_ser["uid"].memory_stats()[
            "store_memmap"])
        s_ser = t_ser.init(prng_key(SEED), check[0])
        t_k4, tab_k4 = build_offload_trainer(OFFLOAD_DEVICE)
        s_k4 = t_k4.init(prng_key(SEED), check[0])
        t_cpu, tab_cpu = build_offload_trainer("cpu")
        s_cpu = copy_state(s_ser, "cpu")
        s_ser, l_ser = _offload_steps(t_ser, s_ser, check[1:], False)
        s_k4, l_k4 = _offload_steps(t_k4, s_k4, check[1:], True)
        s_cpu, l_cpu = _offload_steps(t_cpu, s_cpu, check[1:], False)
        _keys_equal("card K=4 against CPU", s_k4, s_cpu)
        _keys_equal("card K=4 against serial", s_k4, s_ser)
        for tabs, st in ((tab_ser, s_ser), (tab_k4, s_k4),
                         (tab_cpu, s_cpu)):
            _join_tables(tabs, st)
        _rel_close("card K=4 against CPU", l_k4, l_cpu)
        if l_k4 != l_ser:
            raise AssertionError(f"K=4 losses {l_k4} != serial {l_ser}")
        rng = np.random.RandomState(SEED)
        out["cpu_max_abs"] = max(_store_close(
            f"{n} card against CPU", tab_k4[n], tab_cpu[n], False, rng)
            for n in tab_k4)
        for n in tab_k4:
            _store_close(f"{n} K=4 against serial", tab_k4[n], tab_ser[n],
                         True, rng)
        out["losses"] = {"card_k4": l_k4, "card_serial": l_ser,
                         "cpu": l_cpu}
        # the same ids in in-HBM array tables (constant init)
        t_arr, _ = build_offload_trainer(OFFLOAD_DEVICE, offloaded=False)
        s_arr = t_arr.init(prng_key(SEED), check[0])
        s_arr, l_arr = _offload_steps(t_arr, s_arr, check[1:], False)
        _rel_close("offloaded against in-HBM", l_ser, l_arr)
        uids = np.unique(np.concatenate([b["sparse"]["uid"]
                                         for b in check[1:]]))
        arr = {"uid": s_arr.emb["uid"], "uid:linear": s_arr.emb["uid:linear"]}
        worst, exact = 0.0, True
        for n, st in arr.items():
            idx = torch.from_numpy(uids.astype(np.int64)).to(
                st.weights.device)
            for k, want in [("weights", st.weights)] + list(
                    st.slots.items()):
                w = want.index_select(0, idx).cpu().numpy()
                got = tab_ser[n].host_weights[uids] if k == "weights" \
                    else tab_ser[n].host_slots[k][uids]
                worst = max(worst, float(np.abs(got - w).max()))
                exact = exact and np.array_equal(got, w)
                if not np.allclose(got, w, atol=1e-5, rtol=1e-4):
                    raise AssertionError(
                        f"{n} {k}: offloaded rows differ from the in-HBM "
                        f"table's by {float(np.abs(got - w).max())}")
        out["against_in_hbm"] = {"max_abs": worst, "bit_identical": exact,
                                 "losses_equal": l_arr == l_ser,
                                 "rows": int(uids.size)}
        del t_arr, s_arr, arr, t_cpu, s_cpu, tab_cpu, t_k4, s_k4, tab_k4
        torch.cuda.empty_cache()
        # a cache smaller than the working set evicts, card against CPU
        small = [make_batch() for _ in range(OFFLOAD_EVICT_STEPS)]
        t_sm, tab_sm = build_offload_trainer(OFFLOAD_DEVICE,
                                             cache=OFFLOAD_SMALL_CACHE)
        s_sm = t_sm.init(prng_key(SEED), check[0])
        t_smc, tab_smc = build_offload_trainer("cpu",
                                               cache=OFFLOAD_SMALL_CACHE)
        s_smc = copy_state(s_sm, "cpu")
        t0 = time.perf_counter()
        s_sm, l_sm = _offload_steps(t_sm, s_sm, small, True)
        card_s = time.perf_counter() - t0
        s_smc, l_smc = _offload_steps(t_smc, s_smc, small, False)
        _keys_equal("small cache, card against CPU", s_sm, s_smc)
        _join_tables(tab_sm, s_sm)
        _join_tables(tab_smc, s_smc)
        _rel_close("small cache, card against CPU", l_sm, l_smc)
        ev = tab_sm["uid"].evictions
        if ev < 2 or ev != tab_smc["uid"].evictions:
            raise AssertionError(f"small cache: {ev} evictions on the "
                                 f"card, {tab_smc['uid'].evictions} on "
                                 "the CPU (2 or more expected)")
        if t_sm.builds != 1:
            raise AssertionError(f"small cache: {t_sm.builds} step "
                                 "programs built (evictions recaptured)")
        out["small_cache"] = {
            "rows": OFFLOAD_SMALL_CACHE, "steps": OFFLOAD_EVICT_STEPS,
            "evictions": ev, "gen_retries": tab_sm["uid"].gen_retries,
            "recaptures": t_sm.builds - 1,
            "card_steps_s": card_s,
            "max_abs": max(_store_close(f"{n} small cache", tab_sm[n],
                                        tab_smc[n], False, rng)
                           for n in tab_sm)}
        del t_sm, s_sm, tab_sm, t_smc, s_smc, tab_smc
    finally:
        torch.use_deterministic_algorithms(False)
    # the serial trainer goes on to the timed blocks: its program was
    # captured under deterministic algorithms, so it is dropped
    t_ser.programs.clear()
    torch.cuda.empty_cache()
    return out, (t_ser, tab_ser, s_ser), check


def _timed_mode(trainer, table, state, batches, mode, prep_times):
    """One timed block: ``batches`` serially or prefetched at the
    trainer's depth; step ms, examples/s, host-prepare ms a step and the
    uid cache's hits and misses (residency read before each step)."""
    uniqs = [np.unique(b["sparse"]["uid"]) for b in batches]
    hits = misses = 0
    prep_times.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, b in enumerate(batches):
        was = int(table._resident[uniqs[i]].sum())
        hits += was
        misses += uniqs[i].size - was
        if mode != "serial":
            trainer.prefetch(batches[i:i + 1 + trainer.pipeline_depth])
        state, m = trainer.train_step(state, b)
    float(m["loss"])
    dt = time.perf_counter() - t0
    return state, {"seconds": dt, "steps": len(batches),
                   "prepare_s": sum(prep_times), "hits": hits,
                   "misses": misses}


def offload_throughput(make_batch, serial, check) -> dict:
    """Serial, K=1 and K=4 on the same batches: the gates' serial trainer
    (no prefetch), and two fresh card trainers (prefetched at depth 1 and
    4) that first take the gates' batches, so that all three enter the
    timed rounds with the same residency; ``OFFLOAD_WARMUP`` steps, then
    ``OFFLOAD_ROUNDS`` rounds of ``OFFLOAD_TIMED`` steps each mode in
    turns, each round on new batches."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    modes = {"serial": serial}
    for name, depth in (("k1", 1), ("k4", 4)):
        tr, tabs = build_offload_trainer(OFFLOAD_DEVICE, depth=depth)
        st = tr.init(prng_key(SEED), check[0])
        st, _ = _offload_steps(tr, st, check[1:], True)
        modes[name] = (tr, tabs, st)
    prep = {}
    for name, (tr, tabs, st) in modes.items():
        prep[name] = []
        for t in tabs.values():
            def timed_hp(ids, _orig=t.host_prepare, _acc=prep[name]):
                t0 = time.perf_counter()
                out = _orig(ids)
                _acc.append(time.perf_counter() - t0)
                return out
            t.host_prepare = timed_hp
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = (gather_rows, probe_gather, init_rows, init_flat)
    before = {w.__name__: w.launches for w in wrappers}
    warm = [make_batch() for _ in range(OFFLOAD_WARMUP)]
    for name, (tr, tabs, st) in modes.items():
        st, _ = _offload_steps(tr, st, warm, name != "serial")
        modes[name] = (tr, tabs, st)
    blocks = {name: [] for name in modes}
    builds = {name: m[0].builds for name, m in modes.items()}
    for _ in range(OFFLOAD_ROUNDS):
        timed = [make_batch() for _ in range(OFFLOAD_TIMED)]
        for name, (tr, tabs, st) in modes.items():
            st, r = _timed_mode(tr, tabs["uid"], st, timed, name,
                                prep[name])
            modes[name] = (tr, tabs, st)
            blocks[name].append(r)
    out = {}
    for name, rs in blocks.items():
        steps = sum(r["steps"] for r in rs)
        secs = sum(r["seconds"] for r in rs)
        hits = sum(r["hits"] for r in rs)
        misses = sum(r["misses"] for r in rs)
        out[name] = {
            "examples_per_s": steps * BATCH / secs,
            "step_ms": 1e3 * secs / steps,
            "prepare_ms": 1e3 * sum(r["prepare_s"] for r in rs) / steps,
            "block_step_ms": [1e3 * r["seconds"] / r["steps"] for r in rs],
            "cache_hit_rate": hits / max(hits + misses, 1),
            "evictions": modes[name][1]["uid"].evictions,
            "recaptures": modes[name][0].builds - builds[name]}
    steps = len(modes) * (OFFLOAD_WARMUP + OFFLOAD_ROUNDS * OFFLOAD_TIMED)
    per_step = {w.__name__: (w.launches - before[w.__name__]) / steps
                for w in wrappers}
    for name, (tr, tabs, st) in modes.items():
        for t in tabs.values():
            del t.host_prepare
    return out, modes, per_step


class _Prefetching:
    """A trainer whose ``train_step`` prefetches the step's window of a
    batch list first (``training_trace`` drives ``train_step`` alone)."""

    def __init__(self, trainer, batches):
        self.trainer, self.batches = trainer, batches

    def train_step(self, state, batch):
        i = next(k for k, b in enumerate(self.batches) if b is batch)
        self.trainer.prefetch(
            self.batches[i:i + 1 + self.trainer.pipeline_depth])
        return self.trainer.train_step(state, batch)


def _memcpy_rate(trace_path: str, kind: str) -> dict:
    """Bytes, device microseconds and GB/s of a trace's memcpy events of
    ``kind`` (e.g. ``"Pinned -> Device"``)."""
    with open(trace_path) as f:
        ev = [e for e in json.load(f).get("traceEvents", [])
              if e.get("cat") == "gpu_memcpy" and kind in e.get("name", "")]
    nbytes = sum(int(e.get("args", {}).get("bytes", 0)) for e in ev)
    us = sum(float(e.get("dur", 0.0)) for e in ev)
    return {"copies": len(ev), "bytes": nbytes, "device_us": us,
            "gb_per_s": nbytes / us / 1e3 if us else None}


def offload_joins(trainer, tables, state, make_batch, tmp) -> dict:
    """On the K=4 trainer: hand-driven steps under sync debug "error" (no
    device read between two join points), a traced window of
    ``OFFLOAD_TRACE_STEPS`` steps, the writeback of every dirty row timed
    (CUDA events around its copies), and ``uid:linear`` persisted (base,
    then an increment) and restored into a fresh table bit for bit."""
    from openembedding_tpu_torch.meta import EmbeddingVariableMeta
    from openembedding_tpu_torch.offload import ShardedOffloadedTable
    out = {}
    batches = [make_batch() for _ in range(OFFLOAD_SYNC_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = []
        for i, b in enumerate(batches):
            trainer.prefetch(batches[i:i + 1 + trainer.pipeline_depth])
            state, m = trainer.train_step(state, b)
            losses.append(m["loss"])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["sync_debug_steps"] = len(losses)
    # the trace (launch counts from counters and trace must agree)
    traced = [make_batch() for _ in range(OFFLOAD_TRACE_STEPS)]
    lead = make_batch()
    trace_path = os.path.join(tmp, "offload_trace.json")
    inserted = sum(t.insert_bytes for t in tables.values())
    out["trace"] = training_trace(_Prefetching(trainer, [lead] + traced),
                                  state, traced, trace_path, lead,
                                  steps=OFFLOAD_TRACE_STEPS)
    out["insert_h2d"] = _memcpy_rate(trace_path, "Pinned -> Device")
    out["insert_bytes_per_step"] = (sum(t.insert_bytes for t in
                                        tables.values()) - inserted) \
        / (OFFLOAD_TRACE_STEPS + 1)
    os.remove(trace_path)
    # the writeback of the dirty rows: device copies and the scatter
    uid = tables["uid"]
    for t in tables.values():
        t.finish()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = uid.flush(state.emb["uid"])
    uid._join_writeback()
    wall = time.perf_counter() - t0
    ms = uid.writeback_ms()
    out["writeback_d2h"] = {"dirty_rows": rows, "bytes": uid.writeback_bytes,
                            "device_ms": ms,
                            "gb_per_s": uid.writeback_bytes / ms / 1e6
                            if ms else None,
                            "wall_s_with_scatter": wall}
    # persist (base, then an increment after 4 more steps) and restore
    lin = tables["uid:linear"]
    pdir = os.path.join(tmp, "persist_uid_linear")
    t0 = time.perf_counter()
    base = lin.persist(state.emb["uid:linear"], pdir)
    base_s = time.perf_counter() - t0
    more = [make_batch() for _ in range(4)]
    state, _ = _offload_steps(trainer, state, more, True)
    t0 = time.perf_counter()
    inc = lin.persist(state.emb["uid:linear"], pdir)
    inc_s = time.perf_counter() - t0
    fresh = ShardedOffloadedTable(
        "uid:linear", EmbeddingVariableMeta(embedding_dim=1,
                                            vocabulary_size=OFFLOAD_VOCAB),
        {"category": "adagrad", "learning_rate": 0.01},
        {"category": "constant", "value": 0.01}, vocab=OFFLOAD_VOCAB,
        cache_capacity=OFFLOAD_CACHE, device=OFFLOAD_DEVICE)
    t0 = time.perf_counter()
    fresh.restore(pdir)
    restore_s = time.perf_counter() - t0
    same = np.array_equal(fresh.host_weights, lin.host_weights) and all(
        np.array_equal(fresh.host_slots[k], lin.host_slots[k])
        for k in lin.host_slots) and np.array_equal(fresh.host_work_id,
                                                    lin.host_work_id)
    if not same:
        raise AssertionError("uid:linear: restored host store differs")
    size = sum(os.path.getsize(os.path.join(pdir, f))
               for f in os.listdir(pdir))
    out["persist_uid_linear"] = {
        "base_s": base_s, "base_rows": base["rows"], "inc_s": inc_s,
        "inc_rows": inc["rows"], "bytes": size, "restore_s": restore_s,
        "restored_bit_equal": same}
    for t in tables.values():
        t.finish()
    return out, state


def offload_bigvocab(tmp) -> dict:
    """``offload_bigvocab`` (bench.py:1650): the K=4 trainer over 4 x 10^8-
    row host stores (~35 GB, disk memmaps under ``tmp``), the same cache,
    batch and stream; ``OFFLOAD_WARMUP`` steps, then ``BIGVOCAB_STEPS``
    timed. Run only when the disk holds the stores with a quarter to
    spare; the reading says so otherwise."""
    import gc
    from openembedding_tpu_torch.optim.initializers import prng_key
    row_bytes = {OFFLOAD_DIM: OFFLOAD_DIM * 8 + 8, 1: 1 * 8 + 8}
    need = sum(row_bytes.values()) * BIGVOCAB
    free = shutil.disk_usage(tmp).free
    if free < 1.25 * need:
        return {"skipped": f"{free / 1e9:.1f} GB free on disk, "
                           f"{need / 1e9:.1f} GB of store"}
    make_batch = _zipf_uid_batch_maker(np.random.RandomState(SEED + 1),
                                       BATCH, BIGVOCAB, OFFLOAD_ZIPF)
    backing = os.path.join(tmp, "bigvocab")
    t0 = time.perf_counter()
    tr, tabs = build_offload_trainer(OFFLOAD_DEVICE, backing=backing,
                                     vocab=BIGVOCAB)
    alloc_s = time.perf_counter() - t0
    first = make_batch()
    st = tr.init(prng_key(SEED), first)
    prep = []
    for t in tabs.values():
        def timed_hp(ids, _orig=t.host_prepare):
            t1 = time.perf_counter()
            out = _orig(ids)
            prep.append(time.perf_counter() - t1)
            return out
        t.host_prepare = timed_hp
    st, _ = _offload_steps(tr, st, [make_batch()
                                    for _ in range(OFFLOAD_WARMUP)], True)
    timed = [make_batch() for _ in range(BIGVOCAB_STEPS)]
    st, r = _timed_mode(tr, tabs["uid"], st, timed, "k4", prep)
    for t in tabs.values():
        t.finish()
    out = {"vocab": BIGVOCAB, "store_bytes": sum(
               t.memory_stats()["store_bytes"] for t in tabs.values()),
           "alloc_s": alloc_s, "steps": r["steps"],
           "examples_per_s": r["steps"] * BATCH / r["seconds"],
           "step_ms": 1e3 * r["seconds"] / r["steps"],
           "prepare_ms": 1e3 * r["prepare_s"] / r["steps"],
           "cache_hit_rate": r["hits"] / max(r["hits"] + r["misses"], 1),
           "evictions": tabs["uid"].evictions, "builds": tr.builds}
    del tr, tabs, st
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(backing, ignore_errors=True)
    return out


def offload_ki_cases(trainer, state, batch) -> list:
    """KI against its plain version with the base key read from the
    device, as an offload cache holds it (``ShardedOffloadedTable.
    adopt``): the uid pull's own skip flags on the K=4 trainer's cache
    (constant draw, dims 8 and 1) and the same keys all missing under a
    uniform draw. Its launches here are not counted as the main path's."""
    from openembedding_tpu_torch import hash_table as hash_lib
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    dev = trainer.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    counted = init_rows.launches, probe_gather.launches
    cache = state.emb["uid"]
    keys = torch.from_numpy(batch["sparse"]["uid"]).to(dev)
    bsz, _, chain = hash_lib.table_layout(cache.capacity,
                                          hash_lib.DEFAULT_MAX_PROBES)
    _, hit = hash_lib.probe_gather(cache.keys, cache.weights, keys,
                                   chain=chain, bucket=bsz, empty=EMPTY32)
    none = torch.zeros_like(hit)
    cfg = trainer.collection.initializer("uid").to_config()
    uniform = {"category": "uniform", "minval": -1e-3, "maxval": 1e-3}
    key = cache.init_rng
    cases = [
        check_ki_case("offload_pull_uid_dim8_constant_device_key", keys,
                      hit, OFFLOAD_DIM, torch.float32, cfg, flush, key),
        check_ki_case("offload_pull_linear_dim1_constant_device_key", keys,
                      hit, 1, torch.float32, cfg, flush, key),
        check_ki_case("offload_all_missing_dim8_uniform_device_key", keys,
                      none, OFFLOAD_DIM, torch.float32, uniform, flush, key),
    ]
    init_rows.launches, probe_gather.launches = counted
    return cases


def phase_offload() -> dict:
    """Phase 15: ``offload_ab_k4`` (bench.py:1668-1670) at full width on
    the card, run as ``run_offload`` runs it: the gates
    (``offload_gates``), serial / K=1 / K=4 throughput on the same
    batches (``offload_throughput``), then the joins on the K=4 trainer
    (``offload_joins``). Host stores (one a disk memmap) and the persist
    chain under a ``tempfile.mkdtemp()``, removed at the end. Prints one
    ``{"offload": ...}`` line; returns the kernels' launches of the
    phase's steps (counters zeroed at its start) and KI's cases with a
    device-held key (``offload_ki_cases``)."""
    import tempfile
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = (gather_rows, probe_gather, init_rows, init_flat)
    for w in wrappers:
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_offload_")
    t0 = time.perf_counter()
    reading = {"config": {"vocab": OFFLOAD_VOCAB, "cache": OFFLOAD_CACHE,
                          "dim": OFFLOAD_DIM, "batch": BATCH,
                          "zipf_a": OFFLOAD_ZIPF},
               "disk_free_gb": shutil.disk_usage(tmp).free / 1e9}
    try:
        make_batch = _zipf_uid_batch_maker(np.random.RandomState(SEED),
                                           BATCH, OFFLOAD_VOCAB,
                                           OFFLOAD_ZIPF)
        gates, serial, check = offload_gates(make_batch, tmp)
        reading["gates"] = gates
        modes_reading, modes, per_step = offload_throughput(
            make_batch, serial, check)
        want = {"gather_rows": 2, "probe_gather": 2, "init_rows": 4,
                "init_flat": 0}
        if per_step != want:
            raise AssertionError(f"offload launches a step {per_step}, "
                                 f"expected {want}")
        reading["modes"] = modes_reading
        reading["launches_per_step"] = per_step
        tr, tabs, st = modes.pop("k4")
        del modes
        joins, st = offload_joins(tr, tabs, st, make_batch, tmp)
        reading.update(joins)
        reading["init_rows_cases"] = offload_ki_cases(tr, st, make_batch())
        del tr, tabs, st, serial
        reading["bigvocab"] = offload_bigvocab(tmp)
        traced = joins["trace"]["launches_per_step"]
        if {k: traced[k] for k in want if k in traced} != {
                k: float(v) for k, v in want.items() if k in traced}:
            raise AssertionError(f"offload trace launches {traced}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    reading["phase_s"] = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    reading["launches"] = launches
    log(json.dumps({"offload": reading}))
    return launches, reading["init_rows_cases"]


# --- phase 16: the drivers and export_dense -----------------------------------

DRIVER_BUCKETS = 1 << 20       # --num_buckets (deepfm_dim9's vocabulary)
DRIVER_STEPS = 4


def _driver(argv) -> str:
    """``python -m openembedding_tpu_torch.examples.criteo_deepctr argv``
    in this process (the card, ``--device cuda``); its standard output."""
    import contextlib
    import io
    from openembedding_tpu_torch.examples import criteo_deepctr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = criteo_deepctr.main(list(argv) + ["--device", OFFLOAD_DEVICE])
    text = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"criteo_deepctr {argv}: rc {rc}\n{text}")
    return text


def _driver_reading(text: str) -> dict:
    import re
    losses = [float(v) for v in re.findall(r"^step \d+: loss=([0-9.]+)$",
                                           text, re.M)]
    eps = re.search(r"^trained (\d+) steps, (\d+) examples/s$", text, re.M)
    auc = re.search(r"^eval AUC over \d+ batches: ([0-9.]+)$", text, re.M)
    if any(not np.isfinite(x) for x in losses):
        raise AssertionError(f"driver losses not finite: {losses}")
    return {"losses": losses,
            "examples_per_s": int(eps.group(2)) if eps else None,
            "eval_auc": float(auc.group(1)) if auc else None}


def _serve_every_variable(path: str, coll) -> dict:
    """The checkpoint at ``path`` through ``POST /models`` of a
    ``ControllerServer`` on the card: ``lookup_bin`` of 4096 seeded ids
    (and the last row) of every variable equals the saved state's rows
    (``load_checkpoint`` into ``coll``)."""
    from openembedding_tpu_torch import checkpoint as ckpt
    from openembedding_tpu_torch.serving.rest import ControllerServer
    states = ckpt.load_checkpoint(path, coll)
    server = ControllerServer(port=0, device=coll.device).start()
    rng = np.random.RandomState(SEED)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        status, body = _post(conn, "/models", json.dumps(
            {"model_uri": path, "model_sign": "driver-hybrid",
             "block": True}).encode())
        if status != 201:
            raise AssertionError(f"POST /models: HTTP {status} {body!r}")
        sign = json.loads(body)["model_sign"]
        n = 0
        for name, spec in coll.specs.items():
            ids = np.concatenate([rng.randint(0, spec.input_dim, 4096),
                                  [spec.input_dim - 1]]).astype(np.int64)
            rows, _ = lookup_bin(conn, sign, name, ids)
            want = states[name].weights[torch.from_numpy(ids).to(
                states[name].weights.device)].cpu().numpy()
            if not np.array_equal(rows, want):
                raise AssertionError(f"served {name} differs from the "
                                     "saved state")
            n += 1
        conn.close()
    finally:
        server.stop()
    return {"variables": n, "ids_each": 4097}


def phase_drivers() -> dict:
    """Phase 16: the command-line driver on the card
    (``openembedding_tpu_torch/examples/criteo_deepctr.py``, in process):
    ``criteo_hist_hybrid``'s flags (``--no-fused --hist_len 32
    --sparse_as_dense 64``, batch 4096, ``DRIVER_STEPS`` steps,
    ``--save``), that checkpoint served back through the registry and
    every variable's rows checked; the default fused ``deepfm`` saved,
    then ``--load`` with ``--eval_steps 2``; then ``export_dense`` of
    the ``deepfm_dim9`` tables against their host copy, timed. Prints one
    ``{"drivers": ...}`` line; returns the kernels' launches."""
    import tempfile
    from openembedding_tpu_torch import checkpoint as ckpt
    from openembedding_tpu_torch.data import criteo
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    from openembedding_tpu_torch.hybrid import split_sparse_dense
    from openembedding_tpu_torch.models import deepctr
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = (gather_rows, probe_gather, init_rows, init_flat)
    for w in wrappers:
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_drivers_")
    t0 = time.perf_counter()
    out = {}
    common = ["--batch_size", str(BATCH), "--steps", str(DRIVER_STEPS),
              "--num_buckets", str(DRIVER_BUCKETS), "--log_every", "1"]
    try:
        hyb = os.path.join(tmp, "hybrid")
        before = gather_rows.launches
        text = _driver(["--no-fused", "--hist_len", "32",
                        "--sparse_as_dense", "64", *common, "--save", hyb])
        out["hybrid"] = _driver_reading(text)
        out["hybrid"]["k1_launches"] = gather_rows.launches - before
        specs = deepctr.make_feature_specs(
            criteo.SPARSE_NAMES, DRIVER_BUCKETS, 9, hash_capacity=1 << 22)
        specs, kept = split_sparse_dense(specs, 64, batch_size=BATCH)
        specs = tuple(specs) + (
            EmbeddingSpec(name="hist", input_dim=DRIVER_BUCKETS,
                          output_dim=9, pooling="mean"),
            EmbeddingSpec(name="hist:linear", input_dim=DRIVER_BUCKETS,
                          output_dim=1, pooling="sum"))
        out["hybrid"]["served"] = _serve_every_variable(
            hyb, EmbeddingCollection(specs, device=OFFLOAD_DEVICE))
        torch.cuda.empty_cache()
        fused = os.path.join(tmp, "fused")
        out["fused"] = _driver_reading(_driver([*common, "--save", fused]))
        text = _driver(["--batch_size", str(BATCH), "--steps", "0",
                        "--num_buckets", str(DRIVER_BUCKETS),
                        "--load", fused, "--eval_steps", "2"])
        if f"loaded checkpoint from {fused}" not in text:
            raise AssertionError(f"--load: {text}")
        out["fused_load_eval"] = _driver_reading(text)
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        # export_dense of deepfm_dim9's tables
        coll, states, _, host, _ = setup_array()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dense = ckpt.export_dense(coll, states)
        secs = time.perf_counter() - t1
        nbytes = sum(a.nbytes for a in dense.values())
        for name, arr in dense.items():
            if arr.shape != host[name].shape \
                    or not np.array_equal(arr, host[name]):
                raise AssertionError(f"export_dense {name} differs")
        out["export_dense"] = {
            "shapes": {k: list(v.shape) for k, v in dense.items()},
            "seconds": secs, "gb_per_s": nbytes / secs / 1e9}
        del coll, states, host, dense
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    out["launches"] = launches
    log(json.dumps({"drivers": out}))
    return launches


# --- phase 17: sharded tables on a one-process mesh --------------------------

SHARD_MESH = (2, 2)            # bench.py:150-152: deepfm_dim9 on 4 chips
SHARD_CHECK_STEPS = 2          # card steps held against CPU steps
SHARD_TRACE_STEPS = 5
PARITY_STEPS = 3               # SGD + constant init steps a plane
INT64_OFFSET = 1 << 40         # raw ids of the int64 run: 64-bit keys
SHARD_DEVICE = "cuda"          # the device of phase 17's meshes


def _wrappers():
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_flat, init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    return {"gather_rows": gather_rows, "probe_gather": probe_gather,
            "init_rows": init_rows, "init_flat": init_flat}


def _k3():
    """K3's wrapper, whose launches ``main`` sums phase by phase
    (``K3_LAUNCHES``) rather than each phase zeroing its counter."""
    from openembedding_tpu_torch.ops.find_or_insert import find_or_insert
    return find_or_insert


class _Uncounted:
    """Launches inside the ``with`` body (comparisons, timings) are not
    the main path's: the wrappers' counters (K3's too) are put back at its
    end."""

    def __enter__(self):
        self.wrappers = {**_wrappers(), "find_or_insert": _k3()}
        self.saved = {k: w.launches for k, w in self.wrappers.items()}
        return self

    def __exit__(self, *exc):
        for k, w in self.wrappers.items():
            w.launches = self.saved[k]


def build_sharded_trainer(device, plane="a2a", hashed=False,
                          key_dtype="wide", per_feature=False, sgd=False,
                          cache_k=0, mesh=SHARD_MESH):
    """``deepfm_dim9`` (the fused tables), ``deepfm_dim9_hash``
    (``hashed``: fused hash tables of ``HASH_CAPACITY`` slots with
    ``key_dtype`` keys) or ``deepfm_dim9_per_feature`` (``per_feature``:
    52 variables of ``PER_FEATURE_VOCAB`` rows, dims 9 and 1) on a
    ``mesh`` of one process whose positions all name ``device``, on
    ``plane``: sparse Adagrad, or SGD (lr 0.05) from constant 0 with
    ``sgd`` (the plane-parity recipe, bench.py:1153-1213); ``cache_k``
    replica rows refreshed every ``PLANE_CACHE_REFRESH`` steps;
    ``DeepFM`` (256, 128), dense Adagrad. ``mesh``: its ``(data,
    model)`` shape, or a mesh (phase 19's across processes). Returns the
    trainer and the fused batches' mapper (None per feature)."""
    from openembedding_tpu_torch.data.criteo import NUM_DENSE, SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.models.deepctr import (build_model,
                                                        make_feature_specs)
    from openembedding_tpu_torch.optim import dense
    from openembedding_tpu_torch.parallel.mesh import Mesh, create_mesh
    from openembedding_tpu_torch.training import Trainer
    kw = {"plane": plane, "optimizer": {"category": "adagrad",
                                        "learning_rate": 0.01}}
    if sgd:
        kw["optimizer"] = {"category": "sgd", "learning_rate": 0.05}
        kw["initializer"] = {"category": "constant", "value": 0.0}
    if cache_k:
        kw.update(cache_k=cache_k, cache_refresh_every=PLANE_CACHE_REFRESH)
    if hashed:
        kw.update(hash_capacity=HASH_CAPACITY, key_dtype=key_dtype)
    if per_feature:
        specs = make_feature_specs(SPARSE_NAMES, PER_FEATURE_VOCAB, 9, **kw)
        mapper = None
    else:
        specs, mapper = make_fused_specs(
            SPARSE_NAMES, -1 if hashed else VOCAB_PER_FEATURE, 9, **kw)
    module = build_model("deepfm", SPARSE_NAMES, embedding_dim=9,
                         num_dense=NUM_DENSE, dnn_units=(256, 128))
    if not isinstance(mesh, Mesh):
        mesh = create_mesh(*mesh, device=device)
    coll = EmbeddingCollection(specs, mesh, seed=SEED)
    return Trainer(module, coll, dense.adagrad(0.01)), mapper


def sharded_batches(count, hashed=False, key_dtype="wide",
                    per_feature=False, **_) -> list:
    """``count`` batches of 4096 for the ``build_sharded_trainer``
    configuration of these keywords, as ``bench.py``'s ``make_batches``
    gives each: ``synthetic_criteo`` (zipfian), fused, on int64 keys the
    raw ids moved up by ``INT64_OFFSET`` so that the keys fill 64 bits;
    per feature, uniform ids from ``RandomState(0)`` with their
    ``:linear`` columns."""
    from openembedding_tpu_torch.data.criteo import (NUM_DENSE,
                                                     SPARSE_NAMES,
                                                     add_linear_columns,
                                                     synthetic_criteo)
    from openembedding_tpu_torch.fused import make_fused_specs
    if per_feature:
        rng = np.random.RandomState(0)
        raw = [{"sparse": {f: rng.randint(0, PER_FEATURE_VOCAB, BATCH)
                           .astype(np.int32) for f in SPARSE_NAMES},
                "label": (rng.rand(BATCH) > 0.75).astype(np.float32),
                "dense": rng.randn(BATCH, NUM_DENSE).astype(np.float32)}
               for _ in range(count)]
        return list(add_linear_columns(raw))
    mapper = make_fused_specs(SPARSE_NAMES,
                              -1 if hashed else VOCAB_PER_FEATURE, 9,
                              key_dtype=key_dtype)[1]
    out = []
    for b in synthetic_criteo(BATCH, num_buckets=HASH_VOCAB if hashed
                              else VOCAB_PER_FEATURE, seed=SEED,
                              num_batches=count):
        if key_dtype == "int64":
            b = {**b, "sparse": {k: np.asarray(v).astype(np.int64)
                                 + INT64_OFFSET
                                 for k, v in b["sparse"].items()}}
        out.append(mapper.fuse_batch(b))
    return out


def skewed_batch(batch, coll, rng):
    """``batch`` with every key of ``fields`` and ``fields:linear``
    congruent to 1 modulo the shard count: each sender's uniques all go
    to shard 1, so round 1 overflows its bucket."""
    from openembedding_tpu_torch.hash_table import split64
    name = "fields"
    spec, sspec = coll.specs[name], coll.sharding_spec(name)
    s = sspec.num_shards
    shape = (BATCH, 26)
    if spec.use_hash:
        keys = rng.integers(0, 1 << 40, size=shape, dtype=np.int64) * s + 1
        ids = split64(keys) if spec.key_dtype == "wide" else keys
    else:
        ids = (rng.integers(0, spec.input_dim // s, size=shape) * s
               + 1).astype(np.int32)
    return {**batch, "sparse": {name: ids, name + ":linear": ids}}


def check_sharded_init(trainer, state, build) -> dict:
    """The card's ``Trainer.init(prng_key(SEED), batch)`` against the CPU's
    draws, nothing copied: the dense parameters, each array shard's first
    and last ``INIT_ROWS`` rows (the first and last shard held: 0 and S -
    1 in one process) from ``fold_in(variable_key, shard)``, each hash
    table's init key and empty keys (its shards held)."""
    from openembedding_tpu_torch.models.deepctr import init_params
    from openembedding_tpu_torch.optim import initializers as ti
    coll = trainer.collection
    cpu_trainer, _ = build("cpu")
    emb_rng, dense_rng = ti.split(ti.prng_key(SEED))
    params = init_params(cpu_trainer.module, dense_rng, "cpu")
    from openembedding_tpu_torch.parallel.hot_cache import unwrap
    tables = {}
    for name, st in state.emb.items():
        st = unwrap(st)
        sspec = coll.sharding_spec(name)
        if coll.specs[name].use_hash:
            if st.init_rng != coll.hash_init_rng(name, emb_rng) \
                    or st.num_used():
                raise AssertionError(f"sharded init: hash table {name} "
                                     "differs from the CPU's")
            tables[name] = {"init_rng": list(st.init_rng), "shards":
                            sspec.num_shards, "slots": st.capacity}
            continue
        init = coll.initializer(name)
        kind, prm = ti.keyed_params(init)
        vkey = coll.variable_key(name, emb_rng)
        rps, dim, errs = sspec.rows_per_shard, st.dim, []
        held = st.held
        for s in sorted({held.start, held.stop - 1}):
            for r0 in (0, rps - INIT_ROWS):
                want = ti.flat_rows(kind, prm, ti.fold_in(vkey, s),
                                    r0 * dim, INIT_ROWS * dim,
                                    st.weights.dtype).reshape(INIT_ROWS, dim)
                p0 = (s - held.start) * rps + r0
                errs.append(_init_agrees(
                    f"{name} shard {s} rows {r0}..",
                    st.weights[p0:p0 + INIT_ROWS], want, kind,
                    getattr(init, "stddev", 1.0)))
        tables[name] = {"shards": sspec.num_shards, "rows_per_shard": rps,
                        "rows_checked": 4 * INIT_ROWS,
                        "max_abs_diff": max(errs)}
    return {"dense_max_abs_diff": _dense_init_agrees(state.params, params),
            "tables": tables}


def _emb_close(what, state, cstate) -> dict:
    """Every table of a card state against a CPU state: keys and failure
    counts bit for bit, rows and slots within ``_close``'s tolerance."""
    from openembedding_tpu_torch.parallel.hot_cache import unwrap
    out = {}
    for name, st in state.emb.items():
        st, cs = unwrap(st), unwrap(cstate.emb[name])
        if hasattr(st, "keys") and (
                not torch.equal(st.keys.cpu(), cs.keys)
                or not torch.equal(st.shard_failures.cpu(),
                                   cs.shard_failures)):
            raise AssertionError(f"{what}: {name} keys or insert failures "
                                 "differ between the card and the CPU")
        out[name] = max([_close(f"{what} {name} weights", st.weights,
                                cs.weights)]
                        + [_close(f"{what} {name} {k}", v, cs.slots[k])
                           for k, v in st.slots.items()])
    return out


def sharded_against_cpu(what, trainer, state, batches, build):
    """``SHARD_CHECK_STEPS`` captured card steps (the first builds the
    program) against the same eager steps of a CPU trainer on a CPU mesh
    of the same shape, from a copy of the card's state: losses rtol
    1e-4, every table and the dense parameters within ``_close``, and a
    plane's derived state after each step (``_derived_close``)."""
    from openembedding_tpu_torch.training import copy_state
    cpu_trainer, _ = build("cpu")
    t0 = time.perf_counter()
    cstate = copy_state(state, "cpu")
    spent = {"copy_s": time.perf_counter() - t0, "cpu_steps_s": 0.0}
    card, cpu, derived = [], [], []
    for i, b in enumerate(batches[:SHARD_CHECK_STEPS]):
        state, m = trainer.train_step(state, b)
        t0 = time.perf_counter()
        with _EFScales() as kept:
            cstate, cm = cpu_trainer.train_step(cstate, b)
        spent["cpu_steps_s"] += time.perf_counter() - t0
        card.append(float(m["loss"]))
        cpu.append(float(cm["loss"]))
        derived.append(_derived_close(f"{what} step {i}", state, cstate,
                                      kept))
    if not np.allclose(card, cpu, rtol=1e-4):
        raise AssertionError(f"{what}: card losses {card}, CPU {cpu}")
    t0 = time.perf_counter()
    reading = {"steps": len(card), "card_losses": card, "cpu_losses": cpu,
               "tables_max_abs_diff": _emb_close(what, state, cstate),
               "dense_max_abs_diff": max(
                   _close(f"{what} parameter {k}", state.params[k], v)
                   for k, v in cstate.params.items())}
    spent["compare_s"] = time.perf_counter() - t0
    reading["seconds"] = spent
    if any(derived):
        reading["derived_state"] = derived
    return state, reading, cpu_trainer, cstate


class _EFScales:
    """Keeps, while the ``with`` body runs, the outputs of every int8_ef
    quantization (``alltoall._quantize_ef``): each residual's rows and
    their per-row scales, the units a card residual is held against."""

    def __enter__(self):
        from openembedding_tpu_torch.parallel import alltoall
        self.kept, self.real = [], alltoall._quantize_ef

        def keep(*args):
            out = self.real(*args)
            resid, scale = out[2][1], out[1]
            self.kept.append((resid.reshape(-1, resid.shape[-1]),
                              scale.reshape(-1)))
            return out
        alltoall._quantize_ef = keep
        return self

    def __exit__(self, *exc):
        from openembedding_tpu_torch.parallel import alltoall
        alltoall._quantize_ef = self.real

    def scale_of(self, what, resid) -> torch.Tensor:
        """The per-row scales of the quantization that left ``resid``."""
        for r, scale in self.kept:
            if r.shape == resid.shape and torch.equal(r, resid):
                return scale
        raise AssertionError(f"{what}: no int8 quantization of the step "
                             "left this residual")


def _resid_close(what, got, want, scale) -> dict:
    """An int8_ef residual of the card (``got``) against the CPU's
    (``want``) in units of the CPU's per-row ``scale`` (one int8 unit):
    each element equal to the CPU's within ``RESID_TOL`` of a unit, or
    one unit from it within that tolerance: there the card's pre-reduce
    (its deterministic ``index_add_`` adds a sender's entries in another
    order than the CPU) rounded a total across an int8 rounding
    boundary. Counts those flips; anything else raises."""
    units = (got.detach().cpu().double() - want.double()).abs() \
        / scale.double()[:, None]
    same = units <= RESID_TOL
    flip = (units - 1).abs() <= RESID_TOL
    bad = ~(same | flip)
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {units.numel()} card residuals "
            "are neither the CPU's nor one int8 unit from it (in units: "
            f"{float(units[bad].min())} to {float(units[bad].max())})")
    return {"elements": units.numel(), "one_unit_flips": int(flip.sum()),
            "max_units_from_equal": float(units[same].max())
            if bool(same.any()) else 0.0,
            "max_units_from_one_unit": float((units[flip] - 1).abs().max())
            if bool(flip.any()) else 0.0}


def _derived_close(what, state, cstate, kept) -> dict:
    """A plane's derived state on the card against the CPU's after one
    step: a replica's keys bit for bit and rows and slots within
    ``_close``; a residual's keys bit for bit and its values against the
    CPU step's scales (``kept``, an ``_EFScales``) by ``_resid_close``,
    then the CPU takes the card's residual, so that the next step's
    flips are its own; the prefetched rows within ``_close``."""
    from openembedding_tpu_torch.parallel.hot_cache import CachedState
    from openembedding_tpu_torch.parallel.precision import EFState
    out = {}
    for name, st in state.emb.items():
        cs = cstate.emb[name]
        if isinstance(st, CachedState):
            if not torch.equal(st.cache.keys.cpu(), cs.cache.keys):
                raise AssertionError(f"{what}: {name} replica keys differ")
            out[name] = {"replica_max_abs_diff": max(
                [_close(f"{what} {name} replica", st.cache.rows,
                        cs.cache.rows)]
                + [_close(f"{what} {name} replica {k}", v, cs.cache.slots[k])
                   for k, v in st.cache.slots.items()])}
        elif isinstance(st, EFState):
            if not torch.equal(st.keys.cpu(), cs.keys):
                raise AssertionError(f"{what}: {name} residual keys differ")
            out[name] = {"residual": _resid_close(
                f"{what} {name} residual", st.resid, cs.resid,
                kept.scale_of(f"{what} {name}", cs.resid))}
            cs.resid.copy_(st.resid.cpu())
    if state.pipe is not None:
        out["pipe_max_abs_diff"] = max(
            _close(f"{what} prefetched {k}", v, cstate.pipe.rows[k])
            for k, v in state.pipe.rows.items())
    return out


def skew_step(what, trainer, state, cpu_trainer, cstate, batch) -> tuple:
    """The adversarial-skew step: ``batch`` (``skewed_batch``) through a
    replay of the captured step (its rounds are static: the worst case)
    against the CPU's eager step on the same state, then the counters of
    an eager skewed step on a copy: the residue entries of round 1 (the
    ``psum`` plane routes nothing: its step is checked, its counters
    stay 0)."""
    from openembedding_tpu_torch.parallel import alltoall
    from openembedding_tpu_torch.training import copy_state
    from openembedding_tpu_torch.utils import observability as obs
    builds = trainer.builds
    t0 = time.perf_counter()
    state, m = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    cstate, cm = cpu_trainer.train_step(cstate, batch)
    if trainer.builds != builds:
        raise AssertionError(f"{what}: the skewed batch built a program")
    if not np.isclose(float(m["loss"]), float(cm["loss"]), rtol=1e-4):
        raise AssertionError(f"{what}: skewed step loss {float(m['loss'])}"
                             f", CPU {float(cm['loss'])}")
    tables = _emb_close(f"{what} skewed step", state, cstate)
    with _Uncounted():
        obs.GLOBAL.reset()
        obs.set_evaluate_performance(True)
        try:
            trainer.train_step_eager(copy_state(state, trainer.device),
                                     batch)
            alltoall.flush_stats()
            snap = obs.GLOBAL.snapshot()
            timings = obs.plane_timings()
        finally:
            obs.set_evaluate_performance(False)
            obs.GLOBAL.reset()
    extra = {k: snap.get(k, {}).get("count", 0)
             for k in ("a2a_extra_entries_pull", "a2a_extra_entries_push")}
    a2a = trainer.collection.sharding_spec("fields").plane == "a2a"
    if a2a and not extra["a2a_extra_entries_pull"]:
        raise AssertionError(f"{what}: the skewed batch routed in one round")
    return state, cstate, {"loss": float(m["loss"]),
                           "cpu_loss": float(cm["loss"]),
                           "replay_s": step_s, "tables_max_abs_diff": tables,
                           "extra_entries": extra,
                           "eager_plane_ms": timings}


def rounds_reading(trainer, state, batch) -> dict:
    """The exchange of ``fields`` on the main batch: slice, bucket
    capacity and rounds, and the pull timed (CUDA events) with its static
    rounds against the same pull with one round (buckets as large as the
    slice): the cost of the extra rounds. The rows must agree."""
    import dataclasses
    from openembedding_tpu_torch.parallel import alltoall
    from openembedding_tpu_torch.parallel import sharded_hash as sh
    from openembedding_tpu_torch.parallel import sharded_table as st
    coll, name = trainer.collection, "fields"
    spec, sspec = coll.specs[name], coll.sharding_spec(name)
    idx = trainer.place_batch(batch)["sparse"][name]
    n = idx.numel() // (2 if spec.key_dtype == "wide" and spec.use_hash
                        else 1)
    data = coll.mesh.shape["data"]
    m = -(-(n // data) // (sspec.num_shards // data))
    cap = alltoall.bucket_capacity(m, sspec.num_shards, sspec.a2a_capacity,
                                   sspec.a2a_slack)
    one = dataclasses.replace(sspec, a2a_capacity=m)
    if spec.use_hash:
        init = coll.initializer(name)

        def pull(sp):
            return sh.pull_sharded(state.emb[name], idx, init,
                                   mesh=coll.mesh, spec=sp)
    else:
        def pull(sp):
            return st.pull_sharded(state.emb[name], idx, mesh=coll.mesh,
                                   spec=sp)
    with _Uncounted():
        if not torch.equal(pull(sspec), pull(one)):
            raise AssertionError("rounds: one-round and static-round pulls "
                                 "differ")
        ms, ms1 = _event_ms(lambda: pull(sspec)), _event_ms(lambda: pull(one))
    return {"slice": m, "bucket_capacity": cap,
            "rounds": alltoall.max_rounds(m, cap), "pull_ms": ms,
            "one_round_pull_ms": ms1, "extra_rounds_ms": ms - ms1}


def sharded_save_serve(what, trainer, state, batch, tmp) -> dict:
    """The trained 2 x 2 state saved (JAX's logical layout), loaded on a
    1 x 1 mesh by the serving registry, and every table's rows of
    ``batch`` looked up equal to the sharded state's, bit for bit."""
    from openembedding_tpu_torch import checkpoint as ckpt
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    coll = trainer.collection
    path = os.path.join(tmp, what)
    t0 = time.perf_counter()
    ckpt.save_checkpoint(path, coll, state.emb)
    save_s = time.perf_counter() - t0
    reg = ModelRegistry(device=SHARD_DEVICE)
    try:
        t0 = time.perf_counter()
        sign = reg.create_model(path)
        load_s = time.perf_counter() - t0
        model = reg.find_model(sign)
        with _Uncounted():
            for name in state.emb:
                ids = batch["sparse"][name]
                want = coll.pull(state.emb, {name: ids}, read_only=True,
                                 serving_rows=True)[name]
                got = model.lookup(name, ids)
                if not torch.equal(got.reshape(want.shape), want):
                    raise AssertionError(f"{what}: served rows of {name} "
                                         "differ from the sharded state")
    finally:
        reg.close()
        shutil.rmtree(path, ignore_errors=True)
    return {"save_s": save_s, "load_s": load_s, "served_rows_equal": True}


def sharded_kernel_cases(trainer, state, batch, flush) -> tuple:
    """K2's int64 mode and KI's int64 keys against their plain versions on
    the main path's shape: owner 0's request of a round (its keys of an
    unseen batch, misses but for the keys earlier batches inserted, then
    EMPTY to ``S * cap``) against shard 0 of ``fields``; KI fills the
    misses, as the owner's pull does."""
    from openembedding_tpu_torch.hash_table import DEFAULT_MAX_PROBES
    from openembedding_tpu_torch.hash_table import table_layout
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    coll = trainer.collection
    sspec = coll.sharding_spec("fields")
    shard = state.emb["fields"].shard(0)
    keys = trainer.place_batch(batch)["sparse"]["fields"].reshape(-1)
    own = torch.unique(keys[sspec.owner_shard(keys) == 0])
    from openembedding_tpu_torch.parallel import alltoall
    s = sspec.num_shards
    cap = alltoall.bucket_capacity(keys.numel() // s, s)
    query = torch.full((s * cap,), torch.iinfo(torch.int64).min,
                       dtype=torch.int64, device=keys.device)
    query[:min(own.numel(), s * cap)] = own[:s * cap]
    with _Uncounted():
        pcase = check_probe_case("int64_owner_request", shard.keys,
                                 shard.weights, query, flush)
        bsz, _nb, chain = table_layout(shard.capacity, DEFAULT_MAX_PROBES)
        _, hit = probe_gather(shard.keys, shard.weights, query, chain=chain,
                              bucket=bsz, empty=torch.iinfo(torch.int64).min)
        skip = hit | (query == torch.iinfo(torch.int64).min)
        kcase = check_ki_case("int64_keys_owner_misses", query, skip, 9,
                              torch.float32,
                              coll.initializer("fields").to_config(), flush,
                              base=shard.init_rng)
    return pcase, kcase


def sharded_run(what, build, batches, blocks, tmp=None, flush=None,
                unseen=None) -> tuple:
    """One run of phase 17 or 18 (module note) on ``batches``: the card
    trainer (``build``) from ``prng_key(SEED)``, its init against the
    CPU's draws with nothing copied, card against CPU steps
    (``sharded_against_cpu``), captured against eager bit for bit,
    examples/s in ``blocks`` timed blocks (or ``(blocks, steps a
    block)``) of each with every step's
    lookahead and no program built, launches a step, a trace, and the
    plane's own readings. Phase 17 (``tmp`` given) also takes the skewed
    step, reads the exchange's rounds and their cost, serves the save on
    1 x 1 and, with ``unseen``, checks the int64 kernel cases; phase 18
    runs its oracle under deterministic algorithms. Returns the reading
    and the kernel cases (``(None, None)`` but for ``unseen``)."""
    import copy
    from openembedding_tpu_torch.optim.initializers import prng_key
    phase17 = tmp is not None
    trainer, _ = build(SHARD_DEVICE)
    coll, dev = trainer.collection, trainer.device
    t0 = time.perf_counter()
    state = trainer.init(prng_key(SEED), batches[0])
    torch.cuda.synchronize()
    sspec = coll.sharding_spec(next(iter(state.emb)))
    reading = {"config": what, "mesh": dict(coll.mesh.shape),
               "variables": len(state.emb), "plane": sspec.plane_label,
               "shards": sspec.num_shards,
               "init_s": time.perf_counter() - t0}
    spent = reading["seconds_by_part"] = {}
    mark = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        spent[part] = now - mark[0]
        mark[0] = now
    with _Uncounted():
        init = check_sharded_init(trainer, state, build)
        if len(init["tables"]) > 4:
            init["tables"] = {"checked": len(init["tables"]),
                              "max_abs_diff": max(
                                  t.get("max_abs_diff", 0.0)
                                  for t in init["tables"].values())}
        reading["init_without_copy"] = init
    lap("init_check")
    reserved = torch.cuda.memory_stats(dev)["reserved_bytes.all.current"]
    state, reading["check"], cpu_trainer, cstate = sharded_against_cpu(
        what, trainer, state, batches, build)
    if len(reading["check"]["tables_max_abs_diff"]) > 4:
        reading["check"]["tables_max_abs_diff"] = max(
            reading["check"]["tables_max_abs_diff"].values())
    lap("cpu_check")
    if phase17:
        state, cstate, reading["skew"] = skew_step(
            what, trainer, state, cpu_trainer, cstate,
            skewed_batch(batches[1], coll, np.random.default_rng(SEED)))
        lap("skew")
    del cpu_trainer, cstate
    reading["program"] = program_reading(trainer, reserved)
    hot = copy.deepcopy(trainer._hot)

    def reset():
        # each run starts from the same sketches and refresh clocks
        trainer._hot = copy.deepcopy(hot)
    reading["captured_vs_eager"] = captured_against_eager(
        what, trainer, state, batches, deterministic=not phase17,
        reset=reset, steps=0 if phase17 else PLANE_ORACLE_STEPS)
    reset()     # the main state did not take the oracle's steps
    lap("captured_vs_eager")
    before = {k: w.launches for k, w in _wrappers().items()}
    blocks, block_steps = blocks if isinstance(blocks, tuple) \
        else (blocks, BLOCK_STEPS)
    state, m, speed = compare_steps(
        trainer, state, lambda kind, k, i: batches[i % len(batches)], BATCH,
        num_blocks=blocks, lookahead=True, block_steps=block_steps)
    if speed["recaptures"]:
        raise AssertionError(f"{what}: {speed['recaptures']} step programs "
                             "built over the timed steps")
    steps = 2 * (WARMUP_STEPS + blocks * block_steps)
    reading["launches_per_step"] = {k: (w.launches - before[k]) / steps
                                    for k, w in _wrappers().items()}
    reading.update(speed)
    lap("throughput")
    trace_path = os.path.join(ROOT, "_smoke_sharded_trace.json")
    try:
        reading["trace"] = training_trace(
            trainer, state, batches, trace_path, batches[-1],
            steps=SHARD_TRACE_STEPS if phase17 else PLANE_TRACE_STEPS)
    finally:
        if os.path.exists(trace_path):
            os.remove(trace_path)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"{what}: loss {loss}")
    reading["last_loss"] = loss
    lap("trace")
    reading["readings"] = plane_readings(what, trainer, state, batches[1],
                                         batches[2])
    lap("readings")
    cases = (None, None)
    if phase17:
        if sspec.plane == "a2a":
            reading["exchange"] = rounds_reading(trainer, state, batches[0])
        if unseen is not None:
            cases = sharded_kernel_cases(trainer, state, unseen, flush)
        reading["serve"] = sharded_save_serve(what, trainer, state,
                                              batches[2], tmp)
        lap("rounds_cases_serve")
    reading["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(
        dev)
    del trainer, state
    torch.cuda.empty_cache()
    return reading, cases


def plane_parity_run(build, batches, refresh_after=None) -> dict:
    """A fresh trainer (``build``) from ``prng_key(SEED)``:
    ``PARITY_STEPS`` eager steps with their lookahead under
    deterministic algorithms (replicas refreshed after step
    ``refresh_after``, so that the later steps hit them), then the rows
    of the next batch, read only: ``{"losses", "rows"}`` on the host."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    trainer, _ = build(SHARD_DEVICE)
    state = trainer.init(prng_key(SEED), batches[0])
    losses = []
    torch.use_deterministic_algorithms(True)
    try:
        for i, b in enumerate(batches[:PARITY_STEPS]):
            nxt = batches[i + 1] if i + 1 < PARITY_STEPS else None
            state, m = trainer.train_step_eager(state, b, next_batch=nxt)
            losses.append(float(m["loss"]))
            if i == refresh_after:
                for name, mgr in trainer._hot.items():
                    mgr.refresh(state.emb[name])
    finally:
        torch.use_deterministic_algorithms(False)
    probe = batches[PARITY_STEPS]["sparse"]
    rows = {n: r.cpu() for n, r in trainer.collection.pull(
        state.emb, {n: probe[n] for n in state.emb},
        read_only=True).items()}
    del trainer, state
    torch.cuda.empty_cache()
    return {"losses": losses, "rows": rows}


def plane_parity(bases) -> dict:
    """``bench.py``'s ``plane_parity`` recipe at full width: SGD from
    constant 0, the same batches through ``deepfm_dim9`` on the 2 x 2
    ``a2a`` and ``psum`` meshes and on 1 x 1 (``plane_parity_run``); the
    losses and the rows of a probe batch against 1 x 1's within rtol
    1e-5 (bit-identical where the reading says so). The runs are kept in
    ``bases`` under ``(label, (hashed, per_feature, sgd))``: phase 18's
    ``a2a`` SGD baseline is this one."""
    from functools import partial
    batches = sharded_batches(PARITY_STEPS + 1)
    group = (False, False, True)
    for label, kw in (("1x1", {"mesh": (1, 1)}), ("a2a", {}),
                      ("psum", {"plane": "psum"})):
        bases[(label, group)] = plane_parity_run(
            partial(build_sharded_trainer, sgd=True, **kw), batches)
    base = bases[("1x1", group)]
    out = {"steps": PARITY_STEPS,
           "losses": {label: bases[(label, group)]["losses"][0]
                      for label in ("1x1", "a2a", "psum")}}
    for label in ("a2a", "psum"):
        got = bases[(label, group)]
        out[label] = parity_against(f"plane parity: {label}", got, base,
                                    "close")
        out[label]["bit_identical"] = out[label]["max_abs_row_diff"] == 0.0 \
            and got["losses"] == base["losses"]
    return out


# (config, build keywords, timed blocks): the int64 run's last batch stays
# unseen (its keys are the kernel cases' misses)
SHARD_RUNS = (
    ("deepfm_dim9-2x2-a2a", {}, BLOCKS),      # phase 18's a2a baseline
    ("deepfm_dim9-2x2-psum", {"plane": "psum"}, 3),
    ("deepfm_dim9_hash-2x2-a2a", {"hashed": True}, 3),
    ("deepfm_dim9_hash_int64-1x4-a2a",
     {"hashed": True, "key_dtype": "int64", "mesh": (1, 4)}, 3),
)


def phase_sharded() -> dict:
    """Phase 17: sharded tables on a 2 x 2 mesh of one process (returns
    the main path's kernel launches, the int64 kernel cases, the
    ``deepfm_dim9`` ``a2a`` run's reading and the parity runs, which
    phase 18 takes as its baselines)."""
    import tempfile
    from functools import partial
    for w in _wrappers().values():
        w.launches = 0
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=SHARD_DEVICE)
    tmp = tempfile.mkdtemp(prefix="oe-smoke-sharded-")
    t0 = time.perf_counter()
    runs, cases, bases = {}, (None, None), {}
    try:
        for what, kw, blocks in SHARD_RUNS:
            int64 = kw.get("key_dtype") == "int64"
            batches = sharded_batches(TRAIN_BATCHES + int64, **kw)
            runs[what], got = sharded_run(
                what, partial(build_sharded_trainer, **kw),
                batches[:TRAIN_BATCHES], blocks, tmp, flush,
                batches[-1] if int64 else None)
            if got[0] is not None:
                cases = got
        with _Uncounted():
            parity = plane_parity(bases)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: w.launches for k, w in _wrappers().items()}
    for k in ("gather_rows", "probe_gather", "init_rows"):
        if not launches[k]:
            raise AssertionError(f"sharded: {k} never launched")
    log(json.dumps({"sharded": {"runs": runs, "plane_parity": parity,
                                "int64_kernel_cases": list(cases),
                                "launches": launches,
                                "seconds": time.perf_counter() - t0}}))
    return {**launches, "pcase": cases[0], "kcase": cases[1],
            "a2a_run": runs["deepfm_dim9-2x2-a2a"], "parity_runs": bases}


# --- phase 18: the other exchange planes ---------------------------------------

PLANE_TRACE_STEPS = 2
PLANE_ORACLE_STEPS = 2          # captured steps held against eager ones
PLANE_STAGE_REPS = 3            # armed replays of the stage split
PLANE_CACHE_K = 4096            # deepfm_dim9_zipf (bench.py:1578-1582)
PLANE_CACHE_REFRESH = 16
PER_FEATURE_VOCAB = 1 << 18     # deepfm_dim9_per_feature (bench.py:1632)
# JAX's trajectory bound of the compressed planes
# (tests/test_compressed.py:232-262): the largest deviation of a trained
# row from the f32 plane's within 5 % of the f32 rows' largest value
PLANE_ROW_BOUND = 0.05
OBSERVE_REPS = 20
# of a row's int8 unit: a card residual equal to the CPU's, or one unit
# from it (a flipped rounding), within this share of the unit
RESID_TOL = 1e-3


def parity_against(label, got, base, mode) -> dict:
    """A plane's parity run against its baseline's: ``exact`` (losses and
    rows bit for bit), ``close`` (rtol 1e-5, atol 1e-7: phase 17's plane
    parity) or ``bound`` (the compressed planes: the largest row
    deviation within ``PLANE_ROW_BOUND`` of the baseline's largest row
    value, JAX's trajectory bound; the loss gap reported)."""
    diff = max(float((got["rows"][n] - base["rows"][n]).abs().max())
               for n in base["rows"])
    gap = max(abs(a - b) for a, b in zip(got["losses"], base["losses"]))
    out = {"mode": mode, "losses": got["losses"],
           "base_losses": base["losses"], "max_loss_gap": gap,
           "max_abs_row_diff": diff}
    if mode == "exact":
        ok = got["losses"] == base["losses"] and diff == 0.0
    elif mode == "close":
        ok = np.allclose(got["losses"], base["losses"], rtol=1e-5,
                         atol=0.0) and all(
            torch.allclose(got["rows"][n], base["rows"][n], rtol=1e-5,
                           atol=1e-7) for n in base["rows"])
    else:
        top = max(float(r.abs().max()) for r in base["rows"].values())
        out["row_bound"] = PLANE_ROW_BOUND * top
        ok = diff <= out["row_bound"]
    if not ok:
        raise AssertionError(f"{label}: parity ({mode}) fails: "
                             f"{json.dumps(out)[:2000]}")
    return out


def plane_readings(what, trainer, state, batch, after) -> dict:
    """What each plane shows of itself, on a copy of the trained state
    (one eager step, not the main path's launches): the exchanges a step
    and each verb's wire bytes a step (keys and payload, summed over the
    variables, from the buffers that crossed) with the payload dtype;
    the int8 quantization error's largest element and a sender's largest
    residual norm (``quant_error_max``, ``quant_residual_norm``: the
    largest over senders and variables, read from the residuals the last
    training step left); the replica's hits, misses, bytes saved,
    refreshes and the last refresh's ms, and the host sketch's cost a
    step; the step's own stage split over an armed window on the copy
    (``step_stages``; the replica managers are put back after it)."""
    import copy
    from openembedding_tpu_torch.parallel import alltoall
    from openembedding_tpu_torch.parallel.precision import EFState
    from openembedding_tpu_torch.training import copy_state
    from openembedding_tpu_torch.utils import observability as obs
    coll = trainer.collection
    out = {}
    with _Uncounted():
        s = copy_state(state, trainer.device)
        wire = {v: {"keys": 0, "payload": 0, "dtypes": set()}
                for v in ("pull", "push")}
        placed = trainer.place_batch(batch)
        n0 = dict(alltoall.EXCHANGES)
        obs.GLOBAL.reset()
        obs.set_evaluate_performance(True)
        try:
            for name in coll.specs:
                ids = {name: placed["sparse"][name]}
                alltoall.WIRE.clear()
                rows = coll.pull(s.emb, ids)
                w = alltoall.WIRE.get("pull")
                if w and name not in coll.grouped_names():
                    wire["pull"]["keys"] += w["keys"]
                    wire["pull"]["payload"] += w["payload"]
                    wire["pull"]["dtypes"].add(w["payload_dtype"])
                alltoall.WIRE.clear()
                coll.apply_gradients(s.emb, ids,
                                     {name: torch.ones_like(rows[name])
                                      * 1e-3})
                w = alltoall.WIRE.get("push")
                if w and name not in coll.grouped_names():
                    wire["push"]["keys"] += w["keys"]
                    wire["push"]["payload"] += w["payload"]
                    wire["push"]["dtypes"].add(w["payload_dtype"])
            torch.cuda.synchronize()
            alltoall.flush_stats()
            out["cache"] = obs.cache_stats()
        finally:
            obs.set_evaluate_performance(False)
            obs.GLOBAL.reset()
        n1 = dict(alltoall.EXCHANGES)
        # a step's exchanges: the whole collection at once (groups batch)
        s2 = copy_state(state, trainer.device)
        trainer.train_step_eager(s2, batch, next_batch=after)
        m0 = dict(alltoall.EXCHANGES)
        trainer.train_step_eager(s2, after, next_batch=batch)
        out["exchanges_per_step"] = {v: alltoall.EXCHANGES[v] - m0[v]
                                     for v in m0}
        out["per_table_exchanges"] = {v: n1[v] - n0[v] for v in n0}
        out["wire_bytes_per_step"] = {
            v: {"keys": d["keys"], "payload": d["payload"],
                "payload_dtypes": sorted(d["dtypes"])}
            for v, d in wire.items()}
        out["quant"] = {"quant_error_max": 0.0, "quant_residual_norm": 0.0}
        for name, st in state.emb.items():
            if isinstance(st, EFState):
                blocks = st.resid.view(coll.sharding_spec(name).num_shards,
                                       -1)
                out["quant"] = {
                    "quant_error_max": max(out["quant"]["quant_error_max"],
                                           float(blocks.abs().max())),
                    "quant_residual_norm": max(
                        out["quant"]["quant_residual_norm"],
                        float(blocks.norm(dim=1).max()))}
        # the stage window's steps must not move the shared replica
        # managers, whose counters are read below
        hot = copy.deepcopy(trainer._hot)
        _, out["stages"] = step_stages(trainer, s,
                                       [batch] * (PLANE_STAGE_REPS + 1))
        trainer._hot = hot
        del s, s2
    if trainer._hot:
        from openembedding_tpu_torch.parallel.hot_cache import FreqSketch
        mgr = next(iter(trainer._hot.values()))
        keys = mgr._valid_keys(batch["sparse"][next(iter(trainer._hot))])
        scratch = FreqSketch(dense_vocab=len(mgr.sketch._dense)
                             if mgr.sketch._dense is not None else None)
        t0 = time.perf_counter()
        for _ in range(OBSERVE_REPS):
            scratch.update(keys)
        out["replica"] = {
            name: {"refreshes": m.refreshes,
                   "last_refresh_ms": m.last_refresh_s * 1e3,
                   "live_keys": int((state.emb[name].cache.keys
                                     != torch.iinfo(state.emb[name].cache
                                                    .keys.dtype).min)
                                    .sum()) if not state.emb[name].cache
                   .wide else None,
                   "replica_bytes": m.last_replica_bytes}
            for name, m in trainer._hot.items()}
        out["sketch_update_ms"] = (time.perf_counter() - t0) \
            / OBSERVE_REPS * 1e3
    return out


# (config, plane, build keywords, timed blocks, parity: (mode, baseline)):
# deepfm_dim9 on a2a is phase 17's run
PLANE_RUNS = (
    # 3 timed blocks for the wires (phase 17's a2a baseline keeps its
    # 5); 2 for the pipelined and cached ones, whose runs across
    # processes are phase 19's
    ("deepfm_dim9", "a2a+bf16", {}, 3, ("bound", "adagrad")),
    ("deepfm_dim9", "a2a+int8", {}, 3, ("bound", "adagrad")),
    ("deepfm_dim9", "a2a+pipelined", {}, 2, ("exact", "adagrad")),
    ("deepfm_dim9_zipf", "a2a+cache", {"cache_k": PLANE_CACHE_K}, 2,
     ("close", "sgd")),
    # its eager step is ~0.55 s (24,000 device operations): 1 block of
    # 6 steps; the grouped ones' eager ~0.22 s: 1 block
    ("deepfm_dim9_per_feature", "a2a", {"per_feature": True}, (1, 6),
     None),
    ("deepfm_dim9_per_feature", "a2a+grouped", {"per_feature": True},
     1, ("close", "sgd")),
    ("deepfm_dim9_per_feature", "a2a+grouped+pipelined",
     {"per_feature": True}, 1, ("close", "sgd")),
    ("deepfm_dim9_hash", "a2a+int8", {"hashed": True}, 2,
     ("bound", "adagrad")),
    ("deepfm_dim9_hash", "a2a+cache", {"hashed": True,
                                       "cache_k": PLANE_CACHE_K}, 1,
     ("close", "sgd")),
)


def phase_planes(a2a_run=None, bases=None) -> dict:
    """Phase 18: the compressed wires, the grouped exchange, the
    pipelined schedule and the hot-row cache, trained at full width on a
    2 x 2 mesh of one process (returns the main path's kernel launches).
    ``deepfm_dim9`` on ``a2a`` is phase 17's run (``a2a_run``; run here
    when phase 18 runs alone). Each run's parity is held against its
    group's ``a2a`` run on the same batches (``plane_parity_run``; phase
    17's ``bases`` are reused)."""
    from functools import partial
    for w in _wrappers().values():
        w.launches = 0
    t0 = time.perf_counter()
    runs, parity, bases = {}, {}, dict(bases or {})
    todo = PLANE_RUNS
    if a2a_run is None:
        todo = (("deepfm_dim9", "a2a", {}, BLOCKS, None),) + todo
    else:
        runs["deepfm_dim9-2x2-a2a"] = "phase 17's run"
    for config, plane, kw, blocks, par in todo:
        what = f"{config}-2x2-{plane}"
        build = partial(build_sharded_trainer, plane=plane, **kw)
        batches = sharded_batches(TRAIN_BATCHES, **kw)
        t1 = time.perf_counter()
        runs[what] = sharded_run(what, build, batches, blocks)[0]
        runs[what]["seconds"] = time.perf_counter() - t1
        if par is None:
            continue
        mode, recipe = par
        group = (kw.get("hashed", False), kw.get("per_feature", False),
                 recipe == "sgd")
        base_kw = {k: v for k, v in kw.items() if k != "cache_k"}

        def parity_of(p, **extra):
            # one parity run a (plane, group): later planes reuse it
            if (p, group) not in bases:
                bases[(p, group)] = plane_parity_run(partial(
                    build_sharded_trainer, plane=p, sgd=group[2],
                    **extra), batches,
                    refresh_after=0 if extra.get("cache_k") else None)
            return bases[(p, group)]
        with _Uncounted():
            got = parity_of(plane, **kw)
            parity[what] = parity_against(what, got,
                                          parity_of("a2a", **base_kw),
                                          mode)
            if plane == "a2a+grouped+pipelined":
                # pipelining adds nothing to the grouped plane's numbers
                parity[what]["against_grouped"] = parity_against(
                    what + " vs a2a+grouped", got,
                    parity_of("a2a+grouped", **kw), "exact")
    launches = {k: w.launches for k, w in _wrappers().items()}
    for k in ("gather_rows", "probe_gather", "init_rows"):
        if not launches[k]:
            raise AssertionError(f"planes: {k} never launched")
    log(json.dumps({"planes": {"runs": runs, "parity": parity,
                               "launches": launches,
                               "seconds": time.perf_counter() - t0}},
                   default=str))
    return launches


# --- phase 19: training across processes, shard-group serving ----------------

MP_WORKERS = 2                 # processes on the one card, over gloo
MP_WARMUP = 3                  # the a2a run's untimed first steps
MP_BLOCKS, MP_BLOCK_STEPS = 3, 5
MP_PROFILE_STEPS = 2           # profiled steps (busy share), after the blocks
MP_CHECK_STEPS = 2             # the psum, hash and grouped runs' steps
MP_TIMEOUT_S = 480.0           # a worker's whole run; collectives' timeout
MP_GROUPS, MP_REPLICAS = 2, 2  # shard groups x replicas of the serving grid
MP_LOOKUP_IDS = 4096           # ids of every variable through the router
MP_LOOKUP_CHUNK = 256          # ids a lookup of the timed runs
MP_STEADY_S = 2.0              # lookups timed with every replica alive
MP_KILL_RUN_S = 4.0            # lookups across the kills ...
MP_KILLS = ((1.0, (0, 0)), (2.0, (1, 1)))   # ... (at s, (group, replica))
# the router's socket timeout: a killed replica's connections hang until
# its CUDA context is torn down, and a timed-out request fails over
MP_ROUTER_TIMEOUT_S = 2.0
MP_SIGN = "mp-deepfm_dim9"
MP_ATOL, MP_RTOL = 1e-6, 1e-5  # two-process tables against one process
MP_LOSS_RTOL = 1e-4
MP_DEVICE = "cuda"             # the workers', references' and replicas'
# the sizes a parent hands its workers (``out/config.json``): the workers
# train what the one-process references train
MP_CONFIG = ("VOCAB_PER_FEATURE", "HASH_CAPACITY", "HASH_VOCAB", "BATCH",
             "INIT_ROWS", "TRAIN_BATCHES", "MP_WARMUP", "MP_BLOCKS",
             "MP_BLOCK_STEPS", "MP_PROFILE_STEPS", "MP_CHECK_STEPS",
             "MP_TIMEOUT_S", "MP_DEVICE", "PER_FEATURE_VOCAB",
             "PLANE_CACHE_K", "PLANE_CACHE_REFRESH", "MP_RUNS")
# (run, build keywords): the a2a run is timed and served
MP_RUNS = (("a2a", {}), ("psum", {"plane": "psum"}),
           ("hash", {"hashed": True}),
           # the other planes across the processes: deepfm_dim9_zipf and
           # deepfm_dim9_hash on the replica (bench.py:1580, :1624),
           # deepfm_dim9 pipelined, the 52 per-feature variables grouped
           # (bench.py:1640), none cut in width
           ("zipf-cache", {"plane": "a2a+cache", "cache_k": PLANE_CACHE_K}),
           ("hash-cache", {"plane": "a2a+cache", "hashed": True,
                           "cache_k": PLANE_CACHE_K}),
           ("pipelined", {"plane": "a2a+pipelined"}),
           ("grouped", {"plane": "a2a+grouped", "per_feature": True}),
           ("grouped-pipelined", {"plane": "a2a+grouped+pipelined",
                                  "per_feature": True}))
# the runs whose init is held against the CPU's draws; the plane runs
# are held by their steps
MP_INIT_CHECKED = ("a2a", "psum", "hash")


def _mp_sync() -> None:
    if MP_DEVICE != "cpu":
        torch.cuda.synchronize()


def mp_steps(what: str) -> int:
    """Steps of a phase 19 run, the same in the workers and in the
    one-process reference: a cached run refreshes once after step
    ``PLANE_CACHE_REFRESH`` and takes two steps on the replica; a
    pipelined run one step more than a check, so that a step between the
    first and the last prefetches the next."""
    if what == "a2a":
        return MP_WARMUP + MP_BLOCKS * MP_BLOCK_STEPS + MP_PROFILE_STEPS
    if what.endswith("cache"):
        return PLANE_CACHE_REFRESH + 2
    if what == "pipelined":
        return MP_CHECK_STEPS + 1
    return MP_CHECK_STEPS


def _replica_hits(trainer, state, batches) -> dict:
    """This process's hits and valid ids in ``batches`` against each
    cached variable's replica keys, counted on the host as the step's
    lookup counts them: ``{name: [hits, valid]}``."""
    out = {}
    for name in trainer.collection.cached_names():
        mgr = trainer._hot[name]
        keys = mgr._valid_keys(state.emb[name].cache.keys)
        hits = valid = 0
        for b in batches:
            ids = mgr._valid_keys(b["sparse"][name])
            hits += int(np.isin(ids, keys).sum())
            valid += int(ids.size)
        out[name] = [hits, valid]
    return out


def mp_plane_steps(trainer, state, order, rank: int, out: str):
    """The steps of a plane run in a worker: the first a warm-up, the
    ones between timed (examples/s of the global batch, the
    collectives' calls, seconds and bytes a step), the last profiled
    (the card's busy share; a two-step run's examples/s comes from it),
    each pipelined step but the last with its lookahead. Returns the
    state, the losses and the readings: those, the kernels' launches a
    step and, on a cached run, the hits of the steps after the refresh
    (``_replica_hits``)."""
    from openembedding_tpu_torch import distributed
    pipelined = bool(trainer._pipelined)
    n = len(order)
    losses = []
    before = {k: w.launches for k, w in _wrappers().items()}

    def step(i):
        nonlocal state
        kw = {"next_batch": order[i + 1]} if pipelined else {}
        state, m = trainer.train_step(state, order[i], **kw)
        losses.append(float(m["loss"]))
    step(0)
    _mp_sync()
    distributed.reset_stats()
    t0 = time.perf_counter()
    for i in range(1, n - 1):
        step(i)
    _mp_sync()
    wall = time.perf_counter() - t0
    state, more, prof = _eager_busy(trainer, state, order[n - 1:], 1,
                                    os.path.join(out, f"trace{rank}.json"))
    losses += more
    st_ = distributed.STATS
    timed = n - 2
    step_s = wall / timed if timed else prof["wall_ms_per_step"] / 1e3
    reading = {
        "examples_per_s": BATCH / step_s, "step_ms": step_s * 1e3,
        "timed_steps": timed if timed else "the profiled step",
        "collective_ms_per_step": st_["seconds"] / (n - 1) * 1e3,
        "collectives_per_step": st_["calls"] / (n - 1),
        "cross_bytes_per_step": st_["bytes"] / (n - 1),
        "profile": prof,
        "launches_per_step": {k: (w.launches - before[k]) / n
                              for k, w in _wrappers().items()}}
    if trainer._hot:
        reading["replica_hits"] = _replica_hits(
            trainer, state, order[PLANE_CACHE_REFRESH:])
        reading["refreshes"] = {k: m.refreshes
                                for k, m in trainer._hot.items()}
    return state, losses, reading


def _batch_rows(batch, lo: int, hi: int):
    """Rows ``lo:hi`` of every leaf of a batch: one process's slice."""
    if isinstance(batch, dict):
        return {k: _batch_rows(v, lo, hi) for k, v in batch.items()}
    return None if batch is None else np.asarray(batch)[lo:hi]


def bitwise_equal(what: str, got, want) -> None:
    """A gate: ``got`` equal to ``want`` bit for bit (arrays or tensors,
    compared on the host), else it raises naming the first difference."""
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    w = want.detach().cpu().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"{what}: {g.dtype} {g.shape}, expected "
                             f"{w.dtype} {w.shape}")
    bad = np.nonzero(np.ascontiguousarray(g).reshape(-1).view(np.uint8)
                     != np.ascontiguousarray(w).reshape(-1).view(np.uint8))[0]
    if bad.size:
        i = int(bad[0]) // max(1, g.itemsize)
        raise AssertionError(
            f"{what}: {bad.size} bytes differ, the first in element {i} "
            f"({g.reshape(-1)[i]!r} against {w.reshape(-1)[i]!r})")


def tables_close(what: str, got: torch.Tensor, want: torch.Tensor,
                 atol: float = MP_ATOL, rtol: float = MP_RTOL) -> float:
    """A gate: ``got`` within ``atol + rtol * |want|`` of ``want``
    everywhere (on ``got``'s device); returns the largest difference."""
    want = want.to(got.device)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)}, expected "
                             f"{tuple(want.shape)}")
    d = (got.double() - want.double()).abs()
    over = d > atol + rtol * want.double().abs()
    if bool(over.any()):
        raise AssertionError(f"{what}: {int(over.sum())} elements beyond "
                             f"atol {atol} + rtol {rtol}, the largest "
                             f"difference {float(d.max())}")
    return float(d.max()) if d.numel() else 0.0


def wait_procs(procs: dict, timeout: float, what: str) -> None:
    """A gate: every process of ``procs`` (name -> ``Popen``, output in a
    file of ``proc.out``) exits 0 within ``timeout`` seconds. The first
    nonzero exit or the timeout kills the rest and raises with the
    failed process's last output."""
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = {k: p.poll() for k, p in procs.items()}
            failed = next((k for k, c in codes.items()
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes.values()):
                break
            if time.monotonic() > deadline:
                failed = next(k for k, c in codes.items() if c is None)
                break
            time.sleep(0.1)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is not None:
        p = procs[failed]
        tail = ""
        if getattr(p, "out", None) and os.path.exists(p.out):
            with open(p.out, errors="replace") as f:
                tail = f.read()[-4000:]
        raise AssertionError(
            f"{what}: {failed} exited {p.returncode}"
            f"{' (timed out)' if p.returncode in (-9, 137) else ''}:\n{tail}")


def _spawn(name: str, argv: list, out_dir: str):
    """A child interpreter (never a fork of this CUDA process) with the
    repo on its path, its output in ``<out_dir>/<name>.log``."""
    env = {**os.environ,
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    path = os.path.join(out_dir, f"{name}.log")
    with open(path, "w") as f:
        p = subprocess.Popen([sys.executable] + argv, env=env, stdout=f,
                             stderr=subprocess.STDOUT, cwd=ROOT)
    p.out = path
    return p


def _eager_busy(trainer, state, batches, steps: int, trace: str) -> tuple:
    """``steps`` profiled steps (their trace at ``trace``, then removed):
    the device's busy share of their wall time (the union of kernels,
    copies and fills), device operations a step, and the collectives'
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from openembedding_tpu_torch import distributed
    _mp_sync()
    before = dict(distributed.STATS)
    losses = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRACE_WINDOW):
            t0 = time.perf_counter()
            for i in range(steps):
                state, m = trainer.train_step(state, batches[i])
                losses.append(float(m["loss"]))
            _mp_sync()
            wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    try:
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(trace)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    coll_s = distributed.STATS["seconds"] - before["seconds"]
    return state, losses, {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_share": busy / 1e6 / wall if spans else None,
        "device_ops_per_step": len(spans) / steps,
        "collectives_share": coll_s / wall}


def mp_worker(rank: int, port: int, out: str) -> None:
    """One worker of phase 19 (``chip_smoke.py --mp-worker RANK PORT
    OUT``): joins the gloo cluster on ``cuda:0``, then each of
    ``MP_RUNS`` on the 2 x 2 mesh across the processes with its half of
    ``bench.py``'s batches: init (``MP_INIT_CHECKED`` against the CPU's
    draws), the steps (``a2a``: warm-up, timed blocks with the
    collectives' seconds and bytes, profiled steps; a plane run:
    ``mp_plane_steps``), a part save (a pipelined state drained first).
    Writes ``out/worker<rank>.json`` (losses, readings, the kernels'
    launches), the dense parameters to ``out/dense<rank>_<run>.npz``, a
    cached run's replica keys to ``out/replica<rank>_<run>.npz`` and a
    cached hash run's table keys, slot for slot, to
    ``out/keys<rank>_<run>.npz``."""
    from functools import partial
    from openembedding_tpu_torch import checkpoint as ckpt
    from openembedding_tpu_torch import distributed
    from openembedding_tpu_torch.optim.initializers import prng_key
    with open(os.path.join(out, "config.json")) as f:
        globals().update(json.load(f))
    if MP_DEVICE != "cpu" and not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    device = "cpu" if MP_DEVICE == "cpu" else "cuda:0"
    distributed.initialize(f"127.0.0.1:{port}", MP_WORKERS, rank,
                           backend="gloo", device=device,
                           timeout=MP_TIMEOUT_S)
    mesh = distributed.create_global_mesh(*SHARD_MESH)
    for w in _wrappers().values():
        w.launches = 0
    half = BATCH // MP_WORKERS
    res = {"rank": rank, "mesh": dict(mesh.shape),
           "positions": list(mesh.local_positions), "runs": {}}
    for what, kw in MP_RUNS:
        batches = sharded_batches(TRAIN_BATCHES, **kw)
        local = [_batch_rows(b, rank * half, (rank + 1) * half)
                 for b in batches]
        trainer, _ = build_sharded_trainer(MP_DEVICE, mesh=mesh, **kw)
        t0 = time.perf_counter()
        state = trainer.init(prng_key(SEED), local[0])
        _mp_sync()
        run = {"init_s": time.perf_counter() - t0}
        if what in MP_INIT_CHECKED:
            with _Uncounted():
                run["init_without_copy"] = check_sharded_init(
                    trainer, state, partial(build_sharded_trainer, **kw))
        order = [local[i % TRAIN_BATCHES] for i in range(mp_steps(what))]
        losses = []

        def step(b):
            nonlocal state
            state, m = trainer.train_step(state, b)
            losses.append(float(m["loss"]))
        if what == "a2a":
            for b in order[:MP_WARMUP]:
                step(b)
            distributed.reset_stats()
            blocks = []
            for k in range(MP_BLOCKS):
                _mp_sync()
                t0 = time.perf_counter()
                lo = MP_WARMUP + k * MP_BLOCK_STEPS
                for b in order[lo:lo + MP_BLOCK_STEPS]:
                    step(b)
                _mp_sync()
                blocks.append(BATCH * MP_BLOCK_STEPS
                              / (time.perf_counter() - t0))
            timed = MP_BLOCKS * MP_BLOCK_STEPS
            st_ = distributed.STATS
            run["throughput"] = {
                "examples_per_s": statistics.median(blocks),
                "block_eps": blocks,
                "step_ms": BATCH / statistics.median(blocks) * 1e3,
                "collective_ms_per_step": st_["seconds"] / timed * 1e3,
                "collectives_per_step": st_["calls"] / timed,
                "cross_bytes_per_step": st_["bytes"] / timed}
            lo = MP_WARMUP + timed
            state, more, run["profile"] = _eager_busy(
                trainer, state, order[lo:], MP_PROFILE_STEPS,
                os.path.join(out, f"trace{rank}.json"))
            losses += more
        elif what not in MP_INIT_CHECKED:
            state, losses, run["throughput"] = mp_plane_steps(
                trainer, state, order, rank, out)
        else:
            for b in order:
                step(b)
        run["losses"] = losses
        run["builds"] = trainer.builds
        kinds = {type(p).__name__ for p in trainer.programs.values()}
        if kinds != {"_EagerProgram"}:
            raise AssertionError(f"multiprocess {what}: programs {kinds}, "
                                 "expected the eager step")
        run["program"] = "eager (gloo)"
        np.savez(os.path.join(out, f"dense{rank}_{what}.npz"),
                 **{k: v.detach().cpu().numpy()
                    for k, v in state.params.items()})
        cached = trainer.collection.cached_names()
        if cached:
            np.savez(os.path.join(out, f"replica{rank}_{what}.npz"),
                     **{n: state.emb[n].cache.keys.cpu().numpy()
                        for n in cached})
            if kw.get("hashed"):
                np.savez(os.path.join(out, f"keys{rank}_{what}.npz"),
                         **{n: state.emb[n].table.keys.cpu().numpy()
                            for n in cached})
        if trainer._pipelined:
            state = trainer.drain_pipeline(state)
        info = ckpt.save_checkpoint(os.path.join(out, what),
                                    trainer.collection, state.emb,
                                    model_sign=f"{MP_SIGN}-{what}")
        run["save"] = {"seconds": info["seconds"],
                       "part_bytes": info["bytes"]}
        res["runs"][what] = run
        del trainer, state
        torch.cuda.empty_cache()
    res["launches"] = {k: w.launches for k, w in _wrappers().items()}
    res["launches"]["find_or_insert"] = _k3().launches
    with open(os.path.join(out, f"worker{rank}.json"), "w") as f:
        json.dump(res, f)
    distributed.barrier("done")
    distributed.shutdown()


def mp_nccl_check(rank: int, port: int) -> None:
    """``chip_smoke.py --mp-nccl RANK PORT``: two ranks on one card ask
    for ``nccl``; ``distributed.initialize`` must refuse, naming gloo."""
    from openembedding_tpu_torch import distributed
    try:
        distributed.initialize(f"127.0.0.1:{port}", MP_WORKERS, rank,
                               backend="nccl", device="cuda:0",
                               timeout=60.0)
    except ValueError as e:
        if "NCCL refuses two ranks on one device" not in str(e):
            raise
        print(f"rank {rank}: refused: {e}", flush=True)
        return
    raise AssertionError("nccl with two ranks on one device was accepted")


def mp_reference(what: str, kw: dict) -> dict:
    """The run ``what`` in one process on the 2 x 2 mesh (phase 17's
    ``build_sharded_trainer``), the same steps on the global batches:
    eager; the ``a2a`` run's blocks timed as the workers' are, a plane
    run's steps after the first each timed alone (the median). Returns
    its state, losses and examples/s."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    batches = sharded_batches(TRAIN_BATCHES, **kw)
    trainer, _ = build_sharded_trainer(MP_DEVICE, **kw)
    state = trainer.init(prng_key(SEED), batches[0])
    order = [batches[i % TRAIN_BATCHES] for i in range(mp_steps(what))]
    losses, blocks = [], []
    plane = what not in MP_INIT_CHECKED
    for i, b in enumerate(order):
        k = i - MP_WARMUP
        if what == "a2a" and 0 <= k < MP_BLOCKS * MP_BLOCK_STEPS \
                and k % MP_BLOCK_STEPS == 0 or plane and i:
            _mp_sync()
            t0 = time.perf_counter()
        state, m = trainer.train_step_eager(state, b)
        losses.append(float(m["loss"]))
        if what == "a2a" and 0 <= k < MP_BLOCKS * MP_BLOCK_STEPS \
                and k % MP_BLOCK_STEPS == MP_BLOCK_STEPS - 1:
            _mp_sync()
            blocks.append(BATCH * MP_BLOCK_STEPS
                          / (time.perf_counter() - t0))
        elif plane and i:
            _mp_sync()
            blocks.append(BATCH / (time.perf_counter() - t0))
    out = {"trainer": trainer, "state": state, "losses": losses}
    if blocks:
        out["eager_examples_per_s"] = statistics.median(blocks)
        out["eager_block_eps"] = blocks
    return out


def _hash_by_key(st) -> dict:
    """A hash table's live rows sorted by key: ``{"keys", "weights",
    slots...}`` on the host (wide pairs joined)."""
    from openembedding_tpu_torch.hash_table import join64
    live = st.live().cpu().numpy()
    keys = st.keys.cpu().numpy()[live]
    k64 = join64(keys) if keys.ndim == 2 else keys.astype(np.int64)
    order = np.argsort(k64, kind="stable")
    out = {"keys": k64[order],
           "weights": st.weights.cpu().numpy()[live][order]}
    for k, v in st.slots.items():
        out[k] = v.cpu().numpy()[live][order]
    return out


def _replicas_equal(what: str, state, out: str) -> dict:
    """Gates of a cached run: each replica's keys equal on both ranks
    and to the one-process replica's bit for bit (and some admitted: a
    refresh ran), and a hash run's table
    keys, the ranks' shards in rank order, equal to one process's slot
    for slot. Returns the replicas' admitted keys (none without a
    cached run)."""
    from openembedding_tpu_torch.parallel.hot_cache import unwrap
    got = {}
    path = os.path.join(out, f"replica{{}}_{what}.npz")
    if not os.path.exists(path.format(0)):
        return got
    ranks = [dict(np.load(path.format(r))) for r in range(MP_WORKERS)]
    for name, keys in ranks[0].items():
        for r in range(1, MP_WORKERS):
            bitwise_equal(f"multiprocess {what}: {name} replica keys of "
                          f"rank {r}", ranks[r][name], keys)
        bitwise_equal(f"multiprocess {what}: {name} replica keys",
                      keys, state.emb[name].cache.keys)
        live = keys if keys.ndim == 1 else keys[:, 1]
        got[name] = int((live != np.iinfo(np.int32).min).sum())
        if not got[name]:
            raise AssertionError(f"multiprocess {what}: {name}'s replica "
                                 "admitted no key (no refresh ran)")
    path = os.path.join(out, f"keys{{}}_{what}.npz")
    if os.path.exists(path.format(0)):
        ranks = [dict(np.load(path.format(r))) for r in range(MP_WORKERS)]
        for name in ranks[0]:
            bitwise_equal(f"multiprocess {what}: {name} keys slot for slot",
                          np.concatenate([r[name] for r in ranks]),
                          unwrap(state.emb[name]).keys)
    return got


def mp_compare(what: str, kw: dict, ref: dict, results: list,
               out: str) -> dict:
    """A worker run against its one-process reference: the losses of the
    ranks equal bit for bit and within ``MP_LOSS_RTOL`` of the
    reference's; the dense parameters equal on both ranks bit for bit and
    close to the reference's; the part dump, loaded in one process on the
    2 x 2 mesh, within ``MP_ATOL + MP_RTOL`` of the reference's tables
    (hash tables key by key, the live keys the same); a cached run's
    replicas (``_replicas_equal``)."""
    from openembedding_tpu_torch import checkpoint as ckpt
    from openembedding_tpu_torch.parallel.hot_cache import unwrap
    runs = [r["runs"][what] for r in results]
    bitwise_equal(f"multiprocess {what}: losses of the ranks",
                  runs[1]["losses"], runs[0]["losses"])
    if not np.allclose(runs[0]["losses"], ref["losses"], rtol=MP_LOSS_RTOL):
        raise AssertionError(f"multiprocess {what}: losses "
                             f"{runs[0]['losses']}, one process "
                             f"{ref['losses']}")
    dense = [dict(np.load(os.path.join(out, f"dense{r}_{what}.npz")))
             for r in range(MP_WORKERS)]
    state = ref["state"]
    dense_diff = 0.0
    for k, v in dense[0].items():
        bitwise_equal(f"multiprocess {what}: dense {k} of the ranks",
                      dense[1][k], v)
        # the card-against-CPU tolerance of the dense half (phase 7's)
        dense_diff = max(dense_diff, tables_close(
            f"multiprocess {what}: dense {k}",
            torch.from_numpy(v).to(MP_DEVICE),
            state.params[k], atol=1e-5, rtol=1e-4))
    coll = ref["trainer"].collection
    t0 = time.perf_counter()
    loaded = ckpt.load_checkpoint(os.path.join(out, what), coll)
    _mp_sync()
    load_s = time.perf_counter() - t0
    diffs = {}
    for name, st in loaded.items():
        st, rs = unwrap(st), unwrap(state.emb[name])
        if coll.specs[name].use_hash:
            got, want = _hash_by_key(st), _hash_by_key(rs)
            bitwise_equal(f"multiprocess {what}: {name} live keys",
                          got["keys"], want["keys"])
            diffs[name] = max(
                tables_close(f"multiprocess {what}: {name} {f}",
                             torch.from_numpy(got[f]),
                             torch.from_numpy(want[f]))
                for f in got if f != "keys")
            diffs[name + "_keys"] = int(got["keys"].size)
            continue
        diffs[name] = max(
            [tables_close(f"multiprocess {what}: {name} weights",
                          st.weights, rs.weights)]
            + [tables_close(f"multiprocess {what}: {name} {k}", v,
                            rs.slots[k]) for k, v in st.slots.items()])
    del loaded
    torch.cuda.empty_cache()
    replicas = _replicas_equal(what, state, out)
    return {**({"replica_live_keys": replicas} if replicas else {}),"losses": runs[0]["losses"], "one_process_losses": ref["losses"],
            "loss_max_rel_diff": float(np.max(
                np.abs(np.subtract(runs[0]["losses"], ref["losses"]))
                / np.abs(ref["losses"]))),
            "dense_max_abs_diff": dense_diff,
            "tables_max_abs_diff": diffs, "dump_load_s": load_s,
            "init_without_copy": [r.get("init_without_copy")
                                  for r in runs],
            "program": runs[0]["program"], "builds": runs[0]["builds"],
            "save": [r["save"] for r in runs]}


def mp_serving(path: str, procs: dict, eps: list, ready_s: dict,
               router) -> dict:
    """Phase 19's serving: the 2 x 2 grid (``procs``, group-major
    ``eps``) has loaded its slices of the ``a2a`` dump (each replica's
    seconds from the create request: ``ready_s``). Its
    ``ShardedRoutingClient`` (``router``) looks up ``MP_LOOKUP_IDS`` ids
    of every variable: rows equal bit for bit to a one-process registry's
    on the
    whole dump. Then lookups of ``MP_LOOKUP_CHUNK`` ids, timed: with
    every replica alive, and across the kills of one replica of each
    group (``MP_KILLS``): every lookup must succeed with the registry's
    rows."""
    import signal
    import threading
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    spent = {}
    mark = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        spent[part] = now - mark[0]
        mark[0] = now
    reg = ModelRegistry(device=MP_DEVICE)
    t0 = time.perf_counter()
    sign = reg.create_model(path, model_sign=MP_SIGN)
    full_load_s = time.perf_counter() - t0
    model = reg.find_model(sign)
    rng = np.random.RandomState(SEED + 19)
    want = {}
    with _Uncounted():
        for name, spec in model.collection.specs.items():
            ids = rng.randint(0, spec.input_dim, MP_LOOKUP_IDS).astype(
                np.int64)
            want[name] = (ids, model.lookup(name, ids).cpu().numpy())
    reg.close()
    del reg, model
    torch.cuda.empty_cache()
    lap("one_process_registry")
    out = {"one_process_load_s": full_load_s,
           "slice_load_s": ready_s, "seconds": spent}
    try:
        for name, (ids, rows) in want.items():
            bitwise_equal(f"multiprocess serving: {name} through the router",
                          router.lookup(sign, name, ids), rows)
        out["rows_checked"] = {n: len(i) for n, (i, _) in want.items()}
        lap("rows_checked")
        names = list(want)

        def lookups(seconds: float) -> tuple:
            lat, failed, i = [], [], 0
            end = time.perf_counter() + seconds
            while time.perf_counter() < end:
                name = names[i % len(names)]
                ids, rows = want[name]
                lo = (i // len(names) * MP_LOOKUP_CHUNK) % MP_LOOKUP_IDS
                t1 = time.perf_counter()
                try:
                    got = router.lookup(sign, name,
                                        ids[lo:lo + MP_LOOKUP_CHUNK])
                    lat.append((time.perf_counter() - t1) * 1e3)
                    if not np.array_equal(got, rows[lo:lo + MP_LOOKUP_CHUNK]):
                        failed.append(f"{name}@{lo}: rows differ")
                except Exception as e:  # noqa: BLE001 — counted, then gated
                    failed.append(f"{name}@{lo}: {type(e).__name__}: {e}")
                i += 1
            return lat, failed

        def summary(lat, failed):
            return {"lookups": len(lat) + len(failed),
                    "failed": len(failed),
                    "p50_ms": float(np.percentile(lat, 50)) if lat else None,
                    "p99_ms": float(np.percentile(lat, 99)) if lat else None,
                    "max_ms": max(lat) if lat else None}
        lat, failed = lookups(MP_STEADY_S)
        out["steady"] = summary(lat, failed)
        lap("steady")
        timers = [threading.Timer(at, procs[key].send_signal,
                                  (signal.SIGKILL,)) for at, key in MP_KILLS]
        for t in timers:
            t.start()
        lat2, failed2 = lookups(MP_KILL_RUN_S)
        for t in timers:
            t.join()
        # the killed replicas are reaped with the others at the end
        killed = [key for _, key in MP_KILLS]
        lap("across_kills")
        out["across_kills"] = {**summary(lat2, failed2),
                               "killed": [list(k) for k in killed]}
        if failed or failed2:
            raise AssertionError(
                f"multiprocess serving: {len(failed) + len(failed2)} failed "
                f"lookups, the first: {(failed + failed2)[0]}")
    finally:
        router.close()
    return out


def mp_driver_start(tmp: str) -> dict:
    """``examples.multihost_train`` at its defaults on two ranks of the
    card over gloo, and two ranks asking for ``nccl`` on the one card,
    which ``distributed.initialize`` must refuse; all four processes
    started at once. :func:`mp_driver_finish` waits for them."""
    ports = (_free_port(), _free_port())
    procs = {}
    for r in range(MP_WORKERS):
        procs[f"driver rank {r}"] = _spawn(
            f"driver{r}", ["-m", "openembedding_tpu_torch.examples."
                           "multihost_train", "--master",
                           f"127.0.0.1:{ports[0]}", "--num_workers",
                           str(MP_WORKERS), "--worker_rank", str(r),
                           "--backend", "gloo", "--device", MP_DEVICE], tmp)
        if MP_DEVICE != "cpu":
            # nccl needs a card
            procs[f"nccl rank {r}"] = _spawn(
                f"nccl{r}", [os.path.join(ROOT, "chip_smoke.py"),
                             "--mp-nccl", str(r), str(ports[1])], tmp)
    return procs


def mp_driver_finish(procs: dict, t0: float) -> dict:
    """A gate: the processes of :func:`mp_driver_start` (started at
    ``t0``) exit 0, the driver logs two finite losses and finishes,
    nccl is refused."""
    wait_procs(procs, MP_TIMEOUT_S, "multiprocess driver")
    with open(procs["driver rank 0"].out) as f:
        text = f.read()
    losses = [float(x) for x in
              __import__("re").findall(r"loss=([0-9.]+)", text)]
    if len(losses) != 2 or not np.isfinite(losses).all() \
            or "multihost training done" not in text:
        raise AssertionError(f"multihost driver: {text[-2000:]}")
    refusal = None
    if "nccl rank 0" in procs:
        with open(procs["nccl rank 0"].out) as f:
            refusal = f.read().strip().splitlines()[-1]
    return {"seconds": time.perf_counter() - t0, "losses": losses,
            "nccl_refusal": refusal}


def _note_ready(ready: dict, key: str, ep: str) -> None:
    """``ready[key]``: seconds from now until the replica at ``ep``
    serves ``MP_SIGN`` (its slice loaded), None if it never does."""
    from openembedding_tpu_torch.serving.ha import wait_ready
    t0 = time.perf_counter()
    ok = wait_ready(ep, REPLICA_BOOT_S, sign=MP_SIGN)
    ready[key] = time.perf_counter() - t0 if ok else None


def _boot_grid(daemons: dict) -> list:
    """The serving grid's replicas, booted with no model (a replica of
    group ``k`` loads group ``k``'s slice when a model is created):
    ``daemons[(k, i)]``; returns the endpoints, group-major."""
    from openembedding_tpu_torch.serving.ha import spawn_replica, wait_ready
    eps = [[None] * MP_REPLICAS for _ in range(MP_GROUPS)]
    for k in range(MP_GROUPS):
        for i in range(MP_REPLICAS):
            p = _free_port()
            eps[k][i] = f"127.0.0.1:{p}"
            daemons[(k, i)] = spawn_replica(
                p, device=MP_DEVICE, shard_index=k, shard_count=MP_GROUPS)
    for (k, i), p in daemons.items():
        if not wait_ready(eps[k][i], REPLICA_BOOT_S):
            p.kill()
            raise AssertionError(f"replica {eps[k][i]} did not boot: "
                                 f"{_replica_output(p)[-3000:]}")
    return eps


def mp_plane_readings(results: list) -> dict:
    """The plane runs' readings over both ranks: rank 0's examples/s,
    each rank's timings and profile, the kernels' launches a step summed
    over the ranks, and a cached run's hit rate over the steps after its
    refresh (the ranks' hits over their valid ids)."""
    out = {}
    for what, _ in MP_RUNS:
        if what in MP_INIT_CHECKED:
            continue
        per = [r["runs"][what]["throughput"] for r in results]
        reading = {"examples_per_s": per[0]["examples_per_s"],
                   "per_rank": per,
                   "launches_per_step": {
                       k: sum(p["launches_per_step"][k] for p in per)
                       for k in per[0]["launches_per_step"]}}
        if "replica_hits" in per[0]:
            reading["hit_rate"] = {
                name: sum(p["replica_hits"][name][0] for p in per)
                / max(1, sum(p["replica_hits"][name][1] for p in per))
                for name in per[0]["replica_hits"]}
        out[what] = reading
    return out


def phase_multiprocess() -> dict:
    """Phase 19: ``deepfm_dim9`` (``a2a``, ``psum``, ``a2a+pipelined``),
    ``deepfm_dim9_hash`` (``a2a``, ``a2a+cache``), ``deepfm_dim9_zipf``
    (``a2a+cache``) and the 52 per-feature variables (``a2a+grouped``,
    ``a2a+grouped+pipelined``) trained by two processes on a 2 x 2 mesh
    that spans them (one data row each, gloo through host memory, both on
    the one card) and held against one process's mesh on the same
    batches (a cached run's replica keys too, bit for bit);
    the ``a2a`` dump served by a 2 x 2 grid of shard groups and replicas
    through a ``ShardedRoutingClient`` with a replica of each group
    killed; the multihost driver and the nccl refusal. Prints one
    ``{"multiprocess": ...}`` line; returns the main path's launches (the
    workers' and the surviving replicas')."""
    import tempfile
    import threading
    from openembedding_tpu_torch.serving.ha import ShardedRoutingClient
    for w in _wrappers().values():
        w.launches = 0
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="oe-smoke-mp-")
    reading, seconds, daemons = {}, {}, {}
    refs, driver = {}, {}
    # seconds since the phase began at which each milestone was reached
    at = reading["at_s"] = {}

    def milestone(name):
        at[name] = time.perf_counter() - t0
    try:
        # the serving grid boots first (not during the timed steps)
        mark = time.perf_counter()
        eps = _boot_grid(daemons)
        seconds["grid_boot"] = time.perf_counter() - mark
        milestone("grid_booted")
        mark = time.perf_counter()
        with _Uncounted():
            for what, kw in MP_RUNS:
                refs[what] = mp_reference(what, kw)
        _mp_sync()
        one_eps = {k: refs["a2a"][k] for k in ("eager_examples_per_s",
                                                 "eager_block_eps")}
        one_plane_eps = {w: refs[w]["eager_examples_per_s"]
                         for w in refs if w not in MP_INIT_CHECKED}
        seconds["references"] = time.perf_counter() - mark
        mark = time.perf_counter()
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump({k: globals()[k] for k in MP_CONFIG}, f)
        port = _free_port()
        workers = {f"worker {r}": _spawn(
            f"worker{r}", [os.path.join(ROOT, "chip_smoke.py"),
                           "--mp-worker", str(r), str(port), tmp], tmp)
            for r in range(MP_WORKERS)}
        milestone("workers_spawned")
        wait_procs(workers, MP_TIMEOUT_S, "multiprocess training")
        milestone("workers_done")
        seconds["workers"] = time.perf_counter() - mark
        results = []
        for r in range(MP_WORKERS):
            with open(os.path.join(tmp, f"worker{r}.json")) as f:
                results.append(json.load(f))
        # the grid loads its slices of the a2a dump, each replica its
        # group's (ShardedRoutingClient.create_model), and the multihost
        # driver runs, both beside the comparisons (all on the host and
        # disk more than on the card; the overlap is in the readings)
        router = ShardedRoutingClient(eps, timeout=MP_ROUTER_TIMEOUT_S)
        router.create_model(os.path.join(tmp, "a2a"), model_sign=MP_SIGN,
                            block=False)
        ready, pollers = {}, []
        for (k, i) in daemons:
            pollers.append(threading.Thread(
                target=_note_ready, args=(ready, f"{k}.{i}", eps[k][i]),
                daemon=True))
            pollers[-1].start()
        driver.update(mp_driver_start(tmp))
        driver_t0 = time.perf_counter()
        milestone("loads_and_driver_started")
        mark = time.perf_counter()
        runs = {}
        with _Uncounted():
            for what, kw in MP_RUNS:
                runs[what] = mp_compare(what, kw, refs.pop(what), results,
                                        tmp)
                if what != "a2a":
                    # only the a2a dump is served below
                    shutil.rmtree(os.path.join(tmp, what),
                                  ignore_errors=True)
                torch.cuda.empty_cache()
        for what, per in mp_plane_readings(results).items():
            runs[what]["two_process"] = {
                **per, "one_process_eager_examples_per_s":
                one_plane_eps[what],
                "contention": "two processes time-sliced on one card"}
        seconds["compare"] = time.perf_counter() - mark
        milestone("compared")
        a2a = [r["runs"]["a2a"] for r in results]
        runs["a2a"]["two_process"] = {
            "examples_per_s": a2a[0]["throughput"]["examples_per_s"],
            "one_process_eager": one_eps,
            "per_rank": [r["throughput"] for r in a2a],
            "profile": [r["profile"] for r in a2a],
            "contention": "two processes time-sliced on one card"}
        mark = time.perf_counter()
        reading["driver"] = mp_driver_finish(driver, driver_t0)
        seconds["driver_after_compare"] = time.perf_counter() - mark
        mark = time.perf_counter()
        for t in pollers:
            t.join()
        milestone("replicas_ready")
        for (k, i), p in daemons.items():
            if ready.get(f"{k}.{i}") is None:
                p.kill()
                raise AssertionError(f"replica {eps[k][i]} not ready: "
                                     f"{_replica_output(p)[-3000:]}")
        reading["serving"] = mp_serving(os.path.join(tmp, "a2a"), daemons,
                                        eps, ready, router)
        milestone("served")
        seconds["serving"] = time.perf_counter() - mark
        reading["runs"] = runs
    finally:
        refs.clear()
        for p in driver.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        replica = _stop_replicas(list(daemons.values()))
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in results)
                for k in results[0]["launches"]}
    reading["launches_workers"] = dict(launches)
    reading["launches_replicas"] = replica
    launches["gather_rows"] += replica["gather_rows"]
    launches["probe_gather"] += replica["probe_gather"]
    launches["find_or_insert"] += replica["find_or_insert"]
    reading["launches"] = launches
    reading["seconds"] = {**seconds, "phase": time.perf_counter() - t0}
    log(json.dumps({"multiprocess": reading}, default=str))
    for k in ("gather_rows", "probe_gather", "init_rows", "init_flat"):
        if not reading["launches_workers"][k]:
            raise AssertionError(f"multiprocess: {k} never launched in the "
                                 "workers")
    if not replica["gather_rows"]:
        raise AssertionError("multiprocess: the replicas launched no "
                             "gather_rows")
    return launches



# --- phase 20: sharded delta checkpoints, hot-swap, sharded offload -----------

SD_DEVICE = "cuda"            # the device of phase 20's meshes
SD_AB_MESH = (1, 4)           # run_ckpt_delta_ab's create_mesh(1, n_dev)
SD_FIT_STEPS = 3              # the 2 x 2 fit: 3 captured steps, an autosave
SD_AUTOSAVE = 1               # after each (a full base, then 2 deltas); the
SD_KILLED_AT = 2              # interrupted fit stops after its 2nd, the
                              # resumed one appends the 3rd to its chain
SD_CHUNKS = 1 << 20           # the fit's dirty chunks (26 rows of
                              # `fields` each; JAX's default 1024 marks
                              # every chunk of this table a step)
SD_GROUPS = 2                 # the shard group the deltas also go to
SD_HASH_STEPS = 2             # deepfm_dim9_hash: a base and a delta
SD_OFFLOAD_MESH = (1, 4)      # run_offload's create_mesh(1, n_dev)
SD_OFFLOAD_CHECK = 4          # gate steps, 1 x 4 against one shard
SD_OFFLOAD_TIMED = 16         # timed K=4 steps a trainer and a round
SD_OFFLOAD_ROUNDS = 2
SD_PERSIST_PUSHES = 2         # pushes after the persist, both ways
SD_EVICT_CACHE = 1 << 15      # caches smaller than the working set: evict
SD_EVICT_STEPS = 24           # steps through them, 1 x 4 and one shard
SD_STORE_RTOL, SD_STORE_ATOL = 1e-5, 1e-6     # 1 x 4 against one shard
SD_RESTORE_RTOL, SD_RESTORE_ATOL = 1e-6, 1e-7  # restored against kept


def _logical_rows(trainer, state, name: str, ids: np.ndarray) -> np.ndarray:
    """A sharded table's rows of logical ``ids`` read from its stacked
    shards (no kernel)."""
    st_ = state.emb[name]
    phys = trainer.collection.sharding_spec(name).physical_rows(
        torch.from_numpy(ids.astype(np.int64)).to(st_.weights.device))
    return st_.weights.index_select(0, phys).cpu().numpy()


@contextlib.contextmanager
def _recorded_saves(saves: list, published: list | None = None):
    """``checkpoint_delta.save_delta`` wrapped: each save's mode, seconds,
    bytes, rows and seq appended to ``saves``; with ``published``, each
    delta's ``Delta`` taken from memory into it, compaction parked."""
    from openembedding_tpu_torch import checkpoint_delta as cd
    orig = cd.save_delta

    def recording(*a, **k):
        if published is not None:
            k = {**k, "return_payload": True, "compact_chain_len": 10 ** 6,
                 "compact_bytes_ratio": float("inf")}
        info = orig(*a, **k)
        saves.append({f: info.get(f) for f in ("mode", "seconds", "bytes",
                                               "rows", "seq")})
        if published is not None and "delta" in info:
            published.append(info.pop("delta"))
        return info
    cd.save_delta = recording
    try:
        yield
    finally:
        cd.save_delta = orig


def _fit_publishing(trainer, state, batches, auto: str):
    """``fit(autosave_every=SD_AUTOSAVE, retrace_budget=0)`` over
    ``batches`` into ``auto``, its deltas published from memory
    (``_recorded_saves``); after the first autosave (the full base) a
    one-shard registry and the ``SD_GROUPS`` members of a shard group load
    the base in process. Returns the state, the saves, the published
    ``Delta`` s, the registries (``{key: (registry, k, G, load s)}``), the
    fit's seconds and its program builds."""
    from openembedding_tpu_torch.serving.registry import ModelRegistry
    published, saves, registries = [], [], {}
    orig_step, calls = trainer.train_step, [0]

    def hooked_step(state_, b, **kw):
        i, calls[0] = calls[0], calls[0] + 1
        if i == SD_AUTOSAVE:
            # after the first autosave, the full base: load it whole and
            # as the shard group's members (version 0)
            for key, k, g in [("whole", 0, 1)] + [
                    (f"slice{k}", k, SD_GROUPS) for k in range(SD_GROUPS)]:
                reg = ModelRegistry(device=SD_DEVICE)
                t0 = time.perf_counter()
                reg.create_model(auto, model_sign="sd", shard_index=k,
                                 shard_count=g)
                registries[key] = (reg, k, g, time.perf_counter() - t0)
        return orig_step(state_, b, **kw)
    builds0 = trainer.builds
    trainer.train_step = hooked_step
    try:
        with _recorded_saves(saves, published):
            t0 = time.perf_counter()
            state, _ = trainer.fit(state, batches,
                                   autosave_every=SD_AUTOSAVE,
                                   autosave_dir=auto, retrace_budget=0)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
    finally:
        del trainer.train_step
    return (state, saves, published, registries, fit_s,
            trainer.builds - builds0)


def _swap_into(registries, published, probe: np.ndarray, want: dict,
               owner: np.ndarray) -> dict:
    """Each published delta applied to each registry (``apply_delta`` of
    the ``Delta`` in process), seconds each; then every registry's rows of
    ``probe`` equal ``want`` (the trainer's, by table) bit for bit: a
    member ``k`` of the group the ids whose ``owner % G == k``, zeros for
    the rest, the members' sum the whole."""
    swaps = {}
    total = {n: np.zeros_like(w) for n, w in want.items()}
    for key, (reg, k, g, load_s) in registries.items():
        model = reg.find_model("sd")
        if model.version != 0:
            raise AssertionError(f"registry {key}: base version "
                                 f"{model.version}")
        secs = []
        for d in published:
            t0 = time.perf_counter()
            res = reg.apply_delta("sd", d)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not res["applied"] or res["version"] != d.seq:
                raise AssertionError(f"registry {key}: delta {d.seq} {res}")
        owned = (owner % g) == k
        for n, w in want.items():
            got = model.lookup(n, probe).cpu().numpy()
            if not np.array_equal(got[owned], w[owned]) \
                    or np.any(got[~owned]):
                raise AssertionError(f"registry {key}: served {n} rows "
                                     "differ from the trainer's")
            if g > 1:
                total[n] += got
        swaps[key] = {"load_s": load_s, "swap_s": secs,
                      "rows": [d.rows for d in published]}
    for n, w in want.items():
        if not np.array_equal(total[n], w):
            raise AssertionError(f"shard group: {n} rows of the members do "
                                 "not add up to the whole")
    return swaps


def _check_saves(what, saves, published, steps, reading) -> None:
    """One full base, then a delta at every later autosave, each
    published; the bytes into ``reading``."""
    full = [x for x in saves if x["mode"] == "full"]
    deltas = [x for x in saves if x["mode"] == "delta"]
    if len(full) != 1 or len(deltas) != len(published) \
            or len(published) != steps // SD_AUTOSAVE - 1:
        raise AssertionError(f"{what}: saves {json.dumps(saves)}")
    reading["full_base_bytes"] = full[0]["bytes"]
    reading["delta_bytes"] = [x["bytes"] for x in deltas]
    reading["full_over_delta_bytes"] = full[0]["bytes"] / max(
        x["bytes"] for x in deltas)


def sharded_fit_and_swap(tmp: str) -> dict:
    """Phase 20 (b): ``deepfm_dim9`` on the 2 x 2 ``a2a`` mesh with dirty
    tracking armed at ``SD_CHUNKS`` chunks a table (phase 12 keeps JAX's
    default), under deterministic algorithms (two runs must be bit for
    bit equal):

    * uninterrupted: ``_fit_publishing`` over ``SD_FIT_STEPS`` captured
      steps;
    * interrupted: a fresh trainer fits ``SD_KILLED_AT`` steps (default
      compaction) and is dropped; a fresh trainer and collection
      ``fit(resume_from=, retrace_budget=0)`` the rest, autosaving into
      the chain it replayed, and must equal the uninterrupted run bit for
      bit, one program build each; the chain must have grown by a delta
      over the same base, and a third trainer resumed from it (no step
      left) must equal the run too;
    * hot-swap: ``_swap_into`` the three registries, against the
      trainer's logical rows of the last batch's ids (phase 12 sends
      wire bytes over HTTP);
    * the captured step with tracking armed and off, in turns;
    * ``deepfm_dim9_hash`` at reduced depth: ``_fit_publishing`` over
      ``SD_HASH_STEPS`` steps (a base and a delta of the hash tables,
      the payload read from every shard) and ``_swap_into`` the three
      registries (inserted through the owner shards), against the
      trainer's rows of the last batch's keys."""
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.hash_table import join64
    from openembedding_tpu_torch.optim.initializers import prng_key

    def fresh(hashed=False):
        trainer, mapper = build_sharded_trainer(SD_DEVICE, hashed=hashed)
        trainer.collection.enable_dirty_tracking(target_chunks=SD_CHUNKS)
        return trainer, mapper
    trainer, _ = fresh()
    batches = sharded_batches(SD_FIT_STEPS)
    probe = np.unique(batches[-1]["sparse"]["fields"].ravel())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    auto = os.path.join(tmp, "sd_auto")
    registries = {}
    try:
        state = trainer.init(prng_key(SEED), batches[0])
        state, saves, published, registries, fit_s, builds_u = \
            _fit_publishing(trainer, state, batches, auto)

        killed = os.path.join(tmp, "sd_killed")
        t1, _ = fresh()
        t1.fit(t1.init(prng_key(SEED), batches[0]), batches[:SD_KILLED_AT],
               autosave_every=SD_AUTOSAVE, autosave_dir=killed)
        del t1
        torch.cuda.empty_cache()
        t2, _ = fresh()
        s2 = t2.init(prng_key(SEED), batches[0])
        resumed_saves = []
        with _recorded_saves(resumed_saves):
            t0 = time.perf_counter()
            s2, _ = t2.fit(s2, batches, resume_from=killed,
                           autosave_every=SD_AUTOSAVE, autosave_dir=killed,
                           retrace_budget=0)
            torch.cuda.synchronize()
            resumed_fit_s = time.perf_counter() - t0
        diff = _spread(state_tensors(state), state_tensors(s2))
        builds_r = t2.builds
        del t2, s2
        torch.cuda.empty_cache()
        cd.join_compactor(killed)
        chain = cd.chain_state(killed)
        t3, _ = fresh()
        s3, _ = t3.fit(t3.init(prng_key(SEED), batches[0]), batches,
                       resume_from=killed, retrace_budget=0)
        diff_chain = _spread(state_tensors(state), state_tensors(s3))
        del t3, s3
        torch.cuda.empty_cache()
        reading = {"config": "deepfm_dim9", "mesh": list(SHARD_MESH),
                   "plane": "a2a", "steps": SD_FIT_STEPS,
                   "autosave_every": SD_AUTOSAVE, "saves": saves,
                   "fit_s": fit_s, "resumed_fit_s": resumed_fit_s,
                   "builds_uninterrupted": builds_u,
                   "builds_resumed": builds_r,
                   "resumed_vs_uninterrupted": diff,
                   "resumed_saves": resumed_saves, "chain_killed": chain,
                   "chain_restored_vs_uninterrupted": diff_chain}
        appended = [x["mode"] for x in resumed_saves] == ["delta"] * (
            (SD_FIT_STEPS - SD_KILLED_AT) // SD_AUTOSAVE)
        if diff["tensors"] or diff_chain["tensors"] or builds_u != 1 \
                or builds_r != 1 or not appended \
                or chain["last_seq"] != SD_FIT_STEPS // SD_AUTOSAVE - 1:
            raise AssertionError(f"sharded elastic fit: "
                                 f"{json.dumps(reading)}")
        _check_saves("sharded elastic fit", saves, published,
                     SD_FIT_STEPS, reading)
        want = {n: _logical_rows(trainer, state, n, probe)
                for n in ("fields", "fields:linear")}
        reading["swap"] = _swap_into(registries, published, probe, want,
                                     probe.astype(np.int64))
        reading["probe_ids"] = int(probe.size)
    finally:
        torch.use_deterministic_algorithms(False)
        registries.clear()
        cd.join_compactor(auto)
    trainer.programs.clear()
    reading["tracking"] = _tracking_cost(trainer, state, batches)
    del trainer, state
    torch.cuda.empty_cache()

    trainer, _ = fresh(hashed=True)
    batches = sharded_batches(SD_HASH_STEPS, hashed=True)
    probe = np.unique(batches[-1]["sparse"]["fields"].reshape(-1, 2),
                      axis=0)
    auto = os.path.join(tmp, "sd_hash_auto")
    try:
        state = trainer.init(prng_key(SEED), batches[0])
        state, saves, published, registries, fit_s, builds = \
            _fit_publishing(trainer, state, batches, auto)
        hreading = {"config": "deepfm_dim9_hash", "steps": SD_HASH_STEPS,
                  "autosave_every": SD_AUTOSAVE, "saves": saves,
                  "fit_s": fit_s, "builds": builds}
        if builds != 1:
            raise AssertionError(f"sharded hash fit: {json.dumps(hreading)}")
        _check_saves("sharded hash fit", saves, published, SD_HASH_STEPS,
                     hreading)
        want = {n: _expected(state, n, probe, True)
                for n in ("fields", "fields:linear")}
        hreading["swap"] = _swap_into(registries, published, probe, want,
                                    join64(probe))
        hreading["probe_keys"] = int(probe.shape[0])
    finally:
        registries.clear()
        cd.join_compactor(auto)
    reading["hash"] = hreading
    return reading


def _align_offload(t4, s4, s1) -> None:
    """The 1 x 4 trainer's state made the one-shard trainer's: the dense
    parameters and optimizer state, and the ``ctx`` tables' logical rows
    laid out on the shards (``sharded_table.from_logical``); the caches
    start empty and the host stores equal in both."""
    from openembedding_tpu_torch.parallel import sharded_table as st
    coll = t4.collection
    for name in ("ctx", "ctx:linear"):
        laid = st.from_logical(s1.emb[name], coll.sharding_spec(name),
                               coll.specs[name].input_dim,
                               coll.optimizer(name))
        dst = s4.emb[name]
        dst.weights.copy_(laid.weights)
        for k, v in dst.slots.items():
            v.copy_(laid.slots[k])
    for k, v in s4.params.items():
        v.copy_(s1.params[k])
    for k, v in s4.opt_state.items():
        v.copy_(s1.opt_state[k])


def _stores_close(what, a, b, rtol, atol, work_ids=True) -> float:
    """Two tables' host stores: the touched rows within ``rtol``/``atol``
    (with equal work ids unless ``work_ids`` is off), a sample of
    untouched rows bit for bit; the largest difference."""
    stamped = (a.host_work_id > 0) | (b.host_work_id > 0)
    touched = np.nonzero(stamped)[0]
    sample = np.random.RandomState(SEED).randint(0, a.vocab, OFFLOAD_SAMPLE)
    sample = sample[~stamped[sample]]
    worst = 0.0
    for name, x, y in [("weights", a.host_weights, b.host_weights)] + [
            (k, a.host_slots[k], b.host_slots[k]) for k in a.host_slots]:
        xs, ys = x[touched], y[touched]
        worst = max(worst, float(np.abs(xs - ys).max()) if xs.size else 0.0)
        if not np.allclose(xs, ys, rtol=rtol, atol=atol) \
                or not np.array_equal(x[sample], y[sample]):
            raise AssertionError(f"{what}: host {name} differ (largest "
                                 f"difference {worst})")
    if work_ids and not np.array_equal(a.host_work_id[touched],
                                       b.host_work_id[touched]):
        raise AssertionError(f"{what}: host work ids differ")
    return worst


def sharded_offload(tmp: str) -> dict:
    """Phase 20 (c): ``offload_ab_k4`` on the 1 x 4 mesh (the caches 4
    stacked shards, the ``ctx`` tables sharded too), beside phase 15's
    one-shard trainer on the same zipf batches, both prefetched at K=4:

    * gate, under deterministic algorithms: from the same state
      (``_align_offload``), ``SD_OFFLOAD_CHECK`` steps each; losses
      within rtol 1e-5 and the host stores after a flush within
      ``SD_STORE_RTOL``/``SD_STORE_ATOL`` (JAX's eviction tolerance);
    * throughput: ``SD_OFFLOAD_ROUNDS`` rounds of ``SD_OFFLOAD_TIMED``
      steps each trainer in turns, on new batches; examples/s, hit rate,
      evictions, recaptures; the 1 x 4 trainer's K1/K2/KI launches a step
      from the counters, the same in every round;
    * persist, kill, restore and continue on the 1 x 4 ``uid:linear``
      table: persisted, ``SD_PERSIST_PUSHES`` pushes on it
      (uninterrupted); a fresh table restores the persist and takes the
      same pushes; host rows within ``SD_RESTORE_RTOL``/
      ``SD_RESTORE_ATOL``, and the restore resumes one work id past the
      persisted watermark (JAX's rule), so the stamps are not compared."""
    from openembedding_tpu_torch.meta import EmbeddingVariableMeta
    from openembedding_tpu_torch.offload import ShardedOffloadedTable
    from openembedding_tpu_torch.optim.initializers import prng_key
    from openembedding_tpu_torch.parallel import sharded_hash as sh
    from openembedding_tpu_torch.parallel.mesh import create_mesh
    make_batch = _zipf_uid_batch_maker(np.random.RandomState(SEED), BATCH,
                                       OFFLOAD_VOCAB, OFFLOAD_ZIPF)
    check = [make_batch() for _ in range(SD_OFFLOAD_CHECK + 1)]
    out = {"config": {"vocab": OFFLOAD_VOCAB, "cache": OFFLOAD_CACHE,
                      "dim": OFFLOAD_DIM, "batch": BATCH,
                      "zipf_a": OFFLOAD_ZIPF, "depth": 4,
                      "mesh": list(SD_OFFLOAD_MESH)}}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        t1, tab1 = build_offload_trainer(SD_DEVICE)
        t4, tab4 = build_offload_trainer(SD_DEVICE, mesh=SD_OFFLOAD_MESH)
        out["alloc_s"] = time.perf_counter() - t0
        s1 = t1.init(prng_key(SEED), check[0])
        s4 = t4.init(prng_key(SEED), check[0])
        _align_offload(t4, s4, s1)
        shards = {n: s4.emb[n].num_shards for n in tab4}
        if set(shards.values()) != {SD_OFFLOAD_MESH[0] * SD_OFFLOAD_MESH[1]}:
            raise AssertionError(f"offload caches' shards {shards}")
        s1, l1 = _offload_steps(t1, s1, check[1:], True)
        s4, l4 = _offload_steps(t4, s4, check[1:], True)
        _rel_close("1 x 4 against one shard", l4, l1, rtol=1e-5)
        _join_tables(tab1, s1)
        _join_tables(tab4, s4)
        out["gate"] = {"steps": SD_OFFLOAD_CHECK, "losses_1x4": l4,
                       "losses_one_shard": l1,
                       "store_max_abs": max(_stores_close(
                           f"{n} 1 x 4 against one shard", tab4[n], tab1[n],
                           SD_STORE_RTOL, SD_STORE_ATOL) for n in tab4)}
    finally:
        torch.use_deterministic_algorithms(False)
    # both programs were captured under deterministic algorithms
    t1.programs.clear()
    t4.programs.clear()
    wrappers = _wrappers()
    modes = {"one_shard": (t1, tab1, s1), "mesh_1x4": (t4, tab4, s4)}
    warm = [make_batch() for _ in range(OFFLOAD_WARMUP)]
    for name, (tr, tabs, st_) in modes.items():
        st_, _ = _offload_steps(tr, st_, warm, True)
        modes[name] = (tr, tabs, st_)
    builds = {name: m[0].builds for name, m in modes.items()}
    blocks = {name: [] for name in modes}
    per_round = []
    for _ in range(SD_OFFLOAD_ROUNDS):
        timed = [make_batch() for _ in range(SD_OFFLOAD_TIMED)]
        for name, (tr, tabs, st_) in modes.items():
            before = {k: w.launches for k, w in wrappers.items()}
            st_, r = _timed_mode(tr, tabs["uid"], st_, timed, "k4", [])
            modes[name] = (tr, tabs, st_)
            blocks[name].append(r)
            if name == "mesh_1x4":
                per_round.append({k: (w.launches - before[k])
                                  / SD_OFFLOAD_TIMED
                                  for k, w in wrappers.items()})
    out["modes"] = {}
    for name, rs in blocks.items():
        steps = sum(r["steps"] for r in rs)
        secs = sum(r["seconds"] for r in rs)
        hits = sum(r["hits"] for r in rs)
        misses = sum(r["misses"] for r in rs)
        out["modes"][name] = {
            "examples_per_s": steps * BATCH / secs,
            "step_ms": 1e3 * secs / steps,
            "block_step_ms": [1e3 * r["seconds"] / r["steps"] for r in rs],
            "cache_hit_rate": hits / max(hits + misses, 1),
            "evictions": modes[name][1]["uid"].evictions,
            "recaptures": modes[name][0].builds - builds[name]}
    per_step = per_round[0]
    if any(r != per_step for r in per_round) or any(
            v != int(v) for v in per_step.values()) or not (
            per_step["gather_rows"] and per_step["probe_gather"]
            and per_step["init_rows"]):
        raise AssertionError(f"1 x 4 offload launches a step {per_round}")
    out["launches_per_step"] = per_step
    t1, tab1, s1 = modes.pop("one_shard")
    _join_tables(tab1, s1)
    del t1, tab1, s1
    t4, tab4, s4 = modes.pop("mesh_1x4")
    _join_tables(tab4, s4)

    # persist, kill, restore and continue: uid:linear on the mesh
    lin = tab4["uid:linear"]
    pdir = os.path.join(tmp, "sd_persist_uid_linear")
    rng = np.random.RandomState(SEED + 1)
    pushes = [(make_batch()["sparse"]["uid"],
               rng.randn(BATCH, 1).astype(np.float32))
              for _ in range(SD_PERSIST_PUSHES)]

    def run(table, cache):
        for ids, grads in pushes:
            cache = table.prepare(cache, ids)
            sh.apply_gradients_sharded(
                cache, table.optimizer, table.initializer,
                torch.from_numpy(ids).to(SD_DEVICE),
                torch.from_numpy(grads).to(SD_DEVICE), mesh=table.mesh,
                spec=table.spec, batch_sharded=False)
            table.note_update(ids)
        table.flush(cache)
        table._join_writeback()
        return cache
    t0 = time.perf_counter()
    base = lin.persist(s4.emb["uid:linear"], pdir)
    persist_s = time.perf_counter() - t0
    work = lin.work_id
    run(lin, s4.emb["uid:linear"])
    fresh = ShardedOffloadedTable(
        "uid:linear", EmbeddingVariableMeta(embedding_dim=1,
                                            vocabulary_size=OFFLOAD_VOCAB),
        {"category": "adagrad", "learning_rate": 0.01},
        {"category": "constant", "value": 0.01}, vocab=OFFLOAD_VOCAB,
        cache_capacity=OFFLOAD_CACHE,
        mesh=create_mesh(*SD_OFFLOAD_MESH, device=SD_DEVICE))
    t0 = time.perf_counter()
    cache = fresh.restore(pdir)
    restore_s = time.perf_counter() - t0
    if fresh.work_id != work + 1 or fresh.persisted_work != work:
        raise AssertionError(f"uid:linear restored at work id "
                             f"{fresh.work_id} (persisted {work})")
    run(fresh, cache)
    worst = _stores_close("uid:linear restored and continued", fresh, lin,
                          SD_RESTORE_RTOL, SD_RESTORE_ATOL, work_ids=False)
    out["persist_restore"] = {
        "persist_s": persist_s, "base_rows": base["rows"],
        "restore_s": restore_s, "pushes": SD_PERSIST_PUSHES,
        "max_abs": worst, "persisted_work": work}
    for t in tab4.values():
        t.finish()
    del t4, tab4, s4, lin, fresh, cache
    out["small_cache"] = _sharded_evictions(make_batch)
    return out


def _sharded_evictions(make_batch) -> dict:
    """Phase 20 (c), eviction: caches of ``SD_EVICT_CACHE`` rows, smaller
    than the working set, on the 1 x 4 mesh and on one shard, under
    deterministic algorithms, from the same state (``_align_offload``),
    ``SD_EVICT_STEPS`` prefetched steps each: losses within rtol 1e-5,
    the same evictions (one or more, each streaming every shard to the
    host and re-inserting the survivors) and the host stores after a
    flush within ``SD_STORE_RTOL``/``SD_STORE_ATOL``."""
    from openembedding_tpu_torch.optim.initializers import prng_key
    batches = [make_batch() for _ in range(SD_EVICT_STEPS + 1)]
    torch.use_deterministic_algorithms(True)
    try:
        t1, tab1 = build_offload_trainer(SD_DEVICE, cache=SD_EVICT_CACHE)
        t4, tab4 = build_offload_trainer(SD_DEVICE, cache=SD_EVICT_CACHE,
                                         mesh=SD_OFFLOAD_MESH)
        s1 = t1.init(prng_key(SEED), batches[0])
        s4 = t4.init(prng_key(SEED), batches[0])
        _align_offload(t4, s4, s1)
        s1, l1 = _offload_steps(t1, s1, batches[1:], True)
        t0 = time.perf_counter()
        s4, l4 = _offload_steps(t4, s4, batches[1:], True)
        steps_s = time.perf_counter() - t0
        _rel_close("small caches, 1 x 4 against one shard", l4, l1,
                   rtol=1e-5)
        _join_tables(tab1, s1)
        _join_tables(tab4, s4)
        ev = {n: (tab4[n].evictions, tab1[n].evictions) for n in tab4}
        out = {"rows": SD_EVICT_CACHE, "steps": SD_EVICT_STEPS,
               "evictions": {n: e[0] for n, e in ev.items()},
               "gen_retries": tab4["uid"].gen_retries,
               "recaptures": t4.builds - 1, "mesh_steps_s": steps_s}
        if any(a < 1 or a != b for a, b in ev.values()) or t4.builds != 1:
            raise AssertionError(f"small caches on 1 x 4: {json.dumps(out)}"
                                 f", one shard's evictions {ev}")
        out["store_max_abs"] = max(_stores_close(
            f"{n} small caches, 1 x 4 against one shard", tab4[n], tab1[n],
            SD_STORE_RTOL, SD_STORE_ATOL) for n in tab4)
    finally:
        torch.use_deterministic_algorithms(False)
    for t in list(tab1.values()) + list(tab4.values()):
        t.finish()
    return out


def phase_sharded_delta() -> dict:
    """Phase 20: delta checkpoints and hot-swap of sharded variables, and
    ``ShardedOffloadedTable`` over a one-process mesh, at full width:
    (a) ``ckpt_delta_ab`` on the 1 x 4 mesh (``ckpt_delta_ab(tmp,
    SD_AB_MESH)``: full and delta saves, the chain loaded bit for bit);
    (b) ``deepfm_dim9`` on 2 x 2 ``a2a``, then ``deepfm_dim9_hash`` at
    reduced depth (``sharded_fit_and_swap``); (c) ``offload_ab_k4`` on
    1 x 4, then caches small enough to evict (``sharded_offload``,
    ``_sharded_evictions``). Checkpoints and
    host stores under a ``tempfile.mkdtemp()``, removed at the end.
    Prints one ``{"sharded_delta": ...}`` line; returns the kernels'
    launches of the phase (counters zeroed at its start), each of which
    must have launched."""
    import tempfile
    from openembedding_tpu_torch import checkpoint_delta as cd
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    tmp = tempfile.mkdtemp(prefix="oe_smoke_sd_")
    t0 = time.perf_counter()
    reading = {}
    try:
        reading["ckpt_delta_ab"] = ckpt_delta_ab(tmp, SD_AB_MESH)
        reading["ckpt_delta_ab"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        reading["fit_swap"] = sharded_fit_and_swap(tmp)
        reading["fit_swap"]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        reading["offload"] = sharded_offload(tmp)
        reading["offload"]["seconds"] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    finally:
        for d in os.listdir(tmp):
            try:
                cd.join_compactor(os.path.join(tmp, d))
            except RuntimeError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
    reading["phase_s"] = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    reading["launches"] = launches
    log(json.dumps({"sharded_delta": reading}))
    missing = [k for k, v in launches.items() if not v]
    if missing:
        raise AssertionError(f"sharded delta: {missing} never launched")
    return launches


def setup_array():
    """The ``deepfm_dim9`` collection initialized from the seed, its host
    copy and the main-path ids (one fused ``[4096, 26]`` batch, flat)."""
    from openembedding_tpu_torch.data.criteo import (SPARSE_NAMES,
                                                     synthetic_criteo)
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs

    specs, mapper = make_fused_specs(
        SPARSE_NAMES, VOCAB_PER_FEATURE, 9,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    coll = EmbeddingCollection(specs, seed=SEED)
    states = coll.init()
    torch.cuda.synchronize()
    host = {name: states[name].weights.cpu().numpy() for name in states}
    main_ids = mapper.fuse(next(synthetic_criteo(
        BATCH, num_buckets=VOCAB_PER_FEATURE, seed=SEED))["sparse"])[
            "fields"].reshape(-1)
    return coll, states, mapper, host, main_ids


def setup_hash():
    """The ``deepfm_dim9_hash`` collection filled to load 0.5, the served
    batches, the stored keys and each table's host dictionary."""
    from openembedding_tpu_torch.data.criteo import SPARSE_NAMES
    from openembedding_tpu_torch.embedding import EmbeddingCollection
    from openembedding_tpu_torch.fused import make_fused_specs
    from openembedding_tpu_torch.hash_table import split64
    from openembedding_tpu_torch.optim.initializers import fold_in, prng_key

    hspecs, hmapper = make_fused_specs(
        SPARSE_NAMES, -1, 9, hash_capacity=HASH_CAPACITY,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    hcoll = EmbeddingCollection(hspecs, seed=SEED)
    hstates = hcoll.init()
    batches, keys64 = hash_keys(hmapper)
    t0 = time.perf_counter()
    pairs = torch.from_numpy(split64(keys64)).to(hcoll.device)
    hhost = {name: HostRows(keys64, fill_hash(
        st, pairs, fold_in(prng_key(SEED), hcoll.variable_id(name)))
        .cpu().numpy()) for name, st in hstates.items()}
    log(f"hash fill: {keys64.size} keys into each of {len(hstates)} "
        f"tables of {HASH_CAPACITY} slots in "
        f"{time.perf_counter() - t0:.3f} s, 0 insert failures")
    return hcoll, hstates, batches, keys64, hhost


K3_SLOTS = 1 << 26             # deepfm_dim9_hash's table (oebench)
K3_KEYS = 33_762_577           # the keys it holds: load 0.503
K3_ENTRIES = BATCH * 26        # a push's dedup buffer, batch x features
K3_VALID = 16_100              # its distinct keys at zipf 1.2 (share 0.151)
K3_CHUNK = 1 << 20             # keys an insert_rows call of the cell fills


def k3_bound_bytes(keys, query, valid, slot) -> int:
    """Bytes a find of stored keys must move: the key sectors from each
    valid entry's window start through its slot, each sector once over
    all entries (as ``probe_bound_bytes`` counts them); the entries and
    their valid flags read; slot, inserted and failed written."""
    from openembedding_tpu_torch.hash_table import (DEFAULT_MAX_PROBES,
                                                    probe_starts)
    start = probe_starts(query[valid], keys.shape[0], DEFAULT_MAX_PROBES)
    stop = slot[valid]
    start, stop = start.cpu().numpy(), stop.cpu().numpy()
    needed = _union_length(start * 8 // SECTOR, (stop * 8 + 7) // SECTOR)
    n = query.shape[0]
    return needed * SECTOR + n * (8 + 1) + n * (8 + 1 + 1)


def phase_find_kernels() -> dict:
    """``python3 chip_smoke.py --k3``: K3 (``ops/find_or_insert.py``)
    against ``find_or_insert_reference`` at the benchmark's hash cell's
    shape, exact. A wide table of ``K3_SLOTS`` slots is filled with
    ``K3_KEYS`` random keys through ``find_or_insert`` in chunks of
    ``K3_CHUNK`` (every key a miss), and a twin through the plain version:
    the two keys arrays must be equal word for word, each fill timed.
    Then a push's find, ``K3_ENTRIES`` entries of which ``K3_VALID`` are
    stored keys and the rest EMPTY (sorted, as the dedup hands them): the
    outputs equal, timed as the kernel table times K2 (CUDA-event medians
    with the L2 flushed, per-call wall time, the plain version) beside
    its bound, with each of its launches' device time from a profiler
    window; and the same batch with a tenth of its keys new, exact. Prints
    the readings; no result line."""
    from torch.profiler import ProfilerActivity, profile
    from openembedding_tpu_torch import hash_table as th
    from openembedding_tpu_torch.ops import find_or_insert as k3
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k64 = torch.unique(torch.randint(-2**62, 2**62, (K3_KEYS + 40_000,),
                                     device=dev, generator=gen))
    k64 = k64[torch.randperm(k64.numel(), device=dev, generator=gen)]
    stored, fresh = th.widen_ids(k64[:K3_KEYS]), th.widen_ids(k64[K3_KEYS:])
    out = {"slots": K3_SLOTS, "keys": K3_KEYS}
    tables = {}
    for name, fn in (("kernel", th.find_or_insert),
                     ("plain", th.find_or_insert_reference)):
        keys = torch.full((K3_SLOTS, 2), -2**31, dtype=torch.int32,
                          device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, K3_KEYS, K3_CHUNK):
            part = stored[lo:lo + K3_CHUNK]
            fn(keys, part, torch.ones(part.shape[0], dtype=torch.bool,
                                      device=dev))
        torch.cuda.synchronize()
        out[f"fill_{name}_s"] = time.perf_counter() - t0
        tables[name] = keys
    if not torch.equal(tables["kernel"], tables["plain"]):
        raise AssertionError("K3 fill: keys arrays differ from the plain "
                             "version's")
    keys = tables.pop("kernel")
    out["load"] = int((keys[:, 1] != -2**31).sum()) / K3_SLOTS
    del tables
    torch.cuda.empty_cache()

    pick = torch.randperm(K3_KEYS, device=dev, generator=gen)[:K3_VALID]
    found = torch.sort(k64[pick]).values
    mixed = torch.sort(torch.cat([k64[pick[:-K3_VALID // 10]],
                                  k64[K3_KEYS:K3_KEYS + K3_VALID // 10]])
                       ).values
    empty = torch.full((K3_ENTRIES - K3_VALID,), -2**63, dtype=torch.int64,
                       device=dev)
    for case, ids in (("push_found", found), ("push_mixed", mixed)):
        query = th.widen_ids(torch.cat([ids, empty]))
        valid = query[:, 1] != -2**31
        twin = keys.clone()
        counts = k3.key_counts()
        got = th.find_or_insert(keys, query, valid)
        want = th.find_or_insert_reference(twin, query, valid)
        torch.cuda.synchronize()
        same = torch.equal(keys, twin) and all(
            torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
        del twin
        if not same:
            raise AssertionError(f"K3 != plain on case {case}")
        reading = {"entries": K3_ENTRIES, "valid": int(valid.sum()),
                   "inserted": int(want[2].sum()),
                   "failed": int(want[3].sum()),
                   "counted": {k: v - counts[k]
                               for k, v in k3.key_counts().items()}}
        if case == "push_found":
            fns = {"kernel": lambda: th.find_or_insert(keys, query, valid),
                   "plain": lambda: th.find_or_insert_reference(
                       keys, query, valid)}
            for k, fn in fns.items():
                reading[f"{k}_ms"] = _median_ms(fn, flush)
            reading["kernel_call_ms"] = _call_ms(fns["kernel"])
            bound = k3_bound_bytes(keys, query, valid, got[1])
            reading["bound_bytes"] = bound
            reading["bound_ms"] = bound / HBM_BYTES_PER_S * 1e3
            before = k3.find_or_insert.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fns["kernel"]()
                torch.cuda.synchronize()
            reading["launches_a_call"] = (k3.find_or_insert.launches
                                          - before) / 20
            device_us = {e.key[:48]: getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0)
                         for e in prof.key_averages()}
            reading["device_us_a_call"] = {k: v / 20 for k, v in
                                           device_us.items() if v > 0}
        out[case] = reading
        log(f"k3 {case}: {json.dumps(reading)}")
    log(f"k3: {json.dumps({k: v for k, v in out.items() if 'push' not in k})}")
    return out


def phase_find_check() -> dict:
    """``phase_find_kernels`` in the main run, after phase 6; its launches
    are not the main path's."""
    with _Uncounted():
        return phase_find_kernels()


def ki_only() -> None:
    """``python3 chip_smoke.py --ki``: KI's per-key cases alone, for
    comparing two versions of the kernel in turns within one call (run it
    in each tree): the ``deepfm_dim9_hash`` trainer on the card from
    ``prng_key(SEED)``, ``TRAIN_BATCHES`` steps on ``bench.py``'s batches,
    then ``phase_ki_kernels`` on the stream's next batch. Prints the
    cases; no result line."""
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
    from openembedding_tpu_torch.optim.initializers import prng_key
    trainer, mapper = build_hash_trainer("cuda")
    stream = synthetic_criteo(BATCH, num_buckets=HASH_VOCAB, seed=SEED)
    batches = [mapper.fuse_batch(next(stream))
               for _ in range(TRAIN_BATCHES + 1)]
    state = trainer.init(prng_key(SEED), batches[0])
    for b in batches[:TRAIN_BATCHES]:
        state, _ = trainer.train_step(state, b)
    phase_ki_kernels(trainer, state, batches[-1])


PHASE_SECONDS: dict = {}
# K3's main-path launches in this process by phase (``_timed``); the phase
# 14 and 19 children's come back in those phases' launches
K3_LAUNCHES: dict = {}


def _timed(name, fn, *args):
    """``fn(*args)``, its wall seconds kept under ``name``, and K3's
    launches in this process during it under ``name`` in ``K3_LAUNCHES``
    where it made any."""
    k3 = _k3()
    t0, before = time.perf_counter(), k3.launches
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        if k3.launches != before:
            K3_LAUNCHES[name] = k3.launches - before


def main() -> None:
    if sys.argv[1:2] in (["--mp-worker"], ["--mp-nccl"]):
        # a phase 19 child: the parent built the kernels
        sys.path.insert(0, ROOT)
        if sys.argv[1] == "--mp-worker":
            mp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        else:
            mp_nccl_check(int(sys.argv[2]), int(sys.argv[3]))
        return
    t_main = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, ROOT)
    _timed("build", phase_build)
    if sys.argv[1:] == ["--ki"]:
        ki_only()
        return
    if sys.argv[1:] == ["--k3"]:
        phase_find_kernels()
        return
    if sys.argv[1:] == ["--hybrid"]:
        phase_hybrid_training()
        return
    if sys.argv[1:] == ["--delta"]:
        phase_delta()
        return
    if sys.argv[1:] == ["--ingest"]:
        phase_ingest()
        return
    if sys.argv[1:] == ["--serving"]:
        phase_serving_batched()
        return
    if sys.argv[1:] == ["--offload"]:
        phase_offload()
        return
    if sys.argv[1:] == ["--drivers"]:
        phase_drivers()
        return
    if sys.argv[1:] == ["--sharded"]:
        phase_sharded()
        return
    if sys.argv[1:] == ["--planes"]:
        phase_planes()
        return
    if sys.argv[1:] == ["--multiprocess"]:
        phase_multiprocess()
        return
    if sys.argv[1:] == ["--sharded-delta"]:
        phase_sharded_delta()
        return
    if sys.argv[1:] == ["--sharded", "--planes"]:
        sharded = phase_sharded()
        phase_planes(sharded["a2a_run"], sharded["parity_runs"])
        return
    coll, states, mapper, host, main_ids = _timed("3 setup", setup_array)
    cases = _timed("3 kernels", phase_kernels, states["fields"].weights,
                   states["fields:linear"].weights, main_ids)
    launches = _timed("4 serving", phase_serving, coll, states, mapper,
                      host)
    del coll, states, host

    hcoll, hstates, batches, keys64, hhost = _timed("5 setup", setup_hash)
    pcases = _timed("5 probe kernels", phase_probe_kernels, hstates,
                    batches, keys64)
    plaunches = _timed("6 hash serving", phase_hash_serving, hcoll,
                       hstates, batches, hhost)
    del hcoll, hstates, hhost
    torch.cuda.empty_cache()
    k3case = _timed("6 find kernels", phase_find_check)
    torch.cuda.empty_cache()

    k1_training, flat_training, fcases = _timed("7 training",
                                                phase_training)
    launches += k1_training
    torch.cuda.empty_cache()
    kcases, hash_launches = _timed("8 hash training",
                                   phase_hash_training)
    torch.cuda.empty_cache()
    k1_xdeep, flat_xdeep = _timed("10 xdeepfm", phase_xdeepfm_training)
    launches += k1_xdeep
    flat_training += flat_xdeep
    torch.cuda.empty_cache()
    hybrid = _timed("11 hybrid", phase_hybrid_training)
    launches += hybrid["gather_rows"]
    flat_training += hybrid["init_flat"]
    torch.cuda.empty_cache()
    delta = _timed("12 delta", phase_delta)
    launches += delta["gather_rows"]
    flat_training += delta["init_flat"]
    torch.cuda.empty_cache()
    ingest = _timed("13 ingest", phase_ingest)
    launches += ingest["gather_rows"]
    flat_training += ingest["init_flat"]
    torch.cuda.empty_cache()
    served = _timed("14 serving batched", phase_serving_batched)
    launches += served["gather_rows"]
    torch.cuda.empty_cache()
    offload, okcases = _timed("15 offload", phase_offload)
    launches += offload["gather_rows"]
    torch.cuda.empty_cache()
    drivers = _timed("16 drivers", phase_drivers)
    launches += drivers["gather_rows"]
    flat_training += offload["init_flat"] + drivers["init_flat"]
    torch.cuda.empty_cache()
    sharded = _timed("17 sharded", phase_sharded)
    launches += sharded["gather_rows"]
    flat_training += sharded["init_flat"]
    pcases.append(sharded["pcase"])
    kcases.append(sharded["kcase"])
    torch.cuda.empty_cache()
    planes = _timed("18 planes", phase_planes, sharded["a2a_run"],
                    sharded["parity_runs"])
    launches += planes["gather_rows"]
    flat_training += planes["init_flat"]
    torch.cuda.empty_cache()
    multi = _timed("19 multiprocess", phase_multiprocess)
    launches += multi["gather_rows"]
    flat_training += multi["init_flat"]
    torch.cuda.empty_cache()
    sdelta = _timed("20 sharded delta", phase_sharded_delta)
    launches += sdelta["gather_rows"]
    flat_training += sdelta["init_flat"]

    main_case, pmain, kmain, fmain = cases[0], pcases[0], kcases[0], \
        fcases[0]
    k3main = k3case["push_found"]
    k3_by_phase = {**K3_LAUNCHES,
                   "14 serving batched replicas":
                   served["find_or_insert_replicas"],
                   "19 multiprocess workers and replicas":
                   multi["find_or_insert"]}
    for phase in ("5 setup", "8 hash training"):
        if not K3_LAUNCHES.get(phase):
            raise AssertionError(f"K3 never launched in phase {phase}")
    PHASE_SECONDS["whole"] = time.perf_counter() - t_main
    log(json.dumps({"phase_seconds": PHASE_SECONDS}))
    log(card)       # again beside the results: the first line may scroll
    log(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/gather_rows.cu",
        "replaces": "openembedding_tpu/ops/pallas_gather.py:37",
        "launches": launches,
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "call_ms": main_case["kernel_call_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": main_case["library_ms"]}, {
        "name": "probe_gather", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/probe_gather.cu",
        "replaces": "openembedding_tpu/ops/pallas_hash.py:40",
        "launches": plaunches + hash_launches["probe_gather"]
        + hybrid["probe_gather"] + delta["probe_gather"]
        + ingest["probe_gather"] + served["probe_gather"]
        + offload["probe_gather"] + drivers["probe_gather"]
        + sharded["probe_gather"] + planes["probe_gather"]
        + multi["probe_gather"] + sdelta["probe_gather"],
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in pcases),
        "ms": pmain["kernel_ms"], "call_ms": pmain["kernel_call_ms"],
        "plain_ms": pmain["plain_ms"],
        "bound_ms": pmain["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "gather_part_ms": pmain["gather_ms"],
        "int64_ms": sharded["pcase"]["kernel_ms"],
        "int64_plain_ms": sharded["pcase"]["plain_ms"],
        "int64_bound_ms": sharded["pcase"]["bound_ms"]}, {
        "name": "init_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/init_rows.cu",
        "replaces": "openembedding_tpu/hash_table.py:300 (init_rows) and "
                    "openembedding_tpu/optim/initializers.py:54-74 "
                    "(Uniform/Normal.init): XLA code, not Pallas kernels",
        "launches": hash_launches["init_rows"] + hybrid["init_rows"]
        + delta["init_rows"] + ingest["init_rows"] + offload["init_rows"]
        + drivers["init_rows"] + sharded["init_rows"] + planes["init_rows"]
        + multi["init_rows"] + sdelta["init_rows"] + flat_training
        + hash_launches["init_flat"],
        "launches_per_key": hash_launches["init_rows"] + hybrid["init_rows"]
        + delta["init_rows"] + ingest["init_rows"] + offload["init_rows"]
        + drivers["init_rows"] + sharded["init_rows"] + planes["init_rows"]
        + multi["init_rows"] + sdelta["init_rows"],
        "launches_array": flat_training + hash_launches["init_flat"],
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"]
                           for c in kcases + fcases + okcases),
        "ms": kmain["kernel_ms"], "call_ms": kmain["kernel_call_ms"],
        "plain_ms": kmain["plain_ms"],
        "bound_ms": kmain["bound_ms"], "bound_by": kmain["bound_by"],
        "array_ms": fmain["kernel_ms"],
        "array_call_ms": fmain["kernel_call_ms"],
        "array_plain_ms": fmain["plain_ms"],
        "array_bound_ms": fmain["bound_ms"],
        "array_bound_by": fmain["bound_by"],
        "int64_ms": sharded["kcase"]["kernel_ms"],
        "int64_plain_ms": sharded["kcase"]["plain_ms"],
        "int64_bound_ms": sharded["kcase"]["bound_ms"],
        "library_ms": None}, {
        "name": "find_or_insert", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/find_or_insert.cu",
        "replaces": "openembedding_tpu/hash_table.py:374 (find_or_insert): "
                    "XLA code, not a Pallas kernel",
        "launches": sum(k3_by_phase.values()),
        "launches_by_phase": k3_by_phase,
        "launches_a_call": k3main["launches_a_call"],
        "checked_against_plain": True, "max_abs_err": 0,
        "ms": k3main["kernel_ms"], "call_ms": k3main["kernel_call_ms"],
        "plain_ms": k3main["plain_ms"],
        "bound_ms": k3main["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "fill_s": k3case["fill_kernel_s"],
        "fill_plain_s": k3case["fill_plain_s"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
