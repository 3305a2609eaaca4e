"""Smoke run of the torch port on one NVIDIA GPU: every kernel built from
``openembedding_tpu_torch/csrc``, held against its plain PyTorch version,
then the serving and training paths driven end to end at full width.

    python3 chip_smoke.py

(``python3 chip_smoke.py --ki`` runs KI's per-key cases alone, to compare
two versions of the kernel in turns within one call; see ``ki_only``.
``python3 chip_smoke.py --hybrid`` runs phase 11 alone, ``--delta``
phase 12, ``--ingest`` phase 13. None of them prints a result line.)

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
9. the card's name and power limit again, then the kernel list as one
   JSON line;
12. last line: ``{"ok": true, "device": {...}}``.

It imports torch, numpy and the port, never jax or openembedding_tpu.
"""

from __future__ import annotations

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
STAGE_REPS = 20
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
    valid = (query[:, 1] if wide else query) != EMPTY32
    start = probe_starts(query[valid], capacity, DEFAULT_MAX_PROBES)
    span = chain * bsz
    window = keys[start[:, None] + torch.arange(span, device=keys.device)]
    free = (window[..., 1] if wide else window) == EMPTY32
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
    kw = {"chain": chain, "bucket": bsz, "empty": EMPTY32}
    rows, hit = probe_gather(keys, weights, query, **kw)
    want_rows, want_hit = probe_gather_reference(keys, weights, query, **kw)
    torch.cuda.synchronize()
    if rows.shape != want_rows.shape or rows.dtype != want_rows.dtype \
            or not torch.equal(rows, want_rows) \
            or not torch.equal(hit, want_hit):
        raise AssertionError(f"probe_gather != reference on case {name}")
    n = query.shape[0]
    case = {"case": name, "keys": list(keys.shape),
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
    """``got`` (card) within atol 1e-5 + rtol 1e-4 of ``want`` (CPU);
    returns the largest difference."""
    got = got.cpu()
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


def _stage_ms(fn) -> float:
    """Wall time of one call of ``fn`` on the host's clock, each run
    ended by a synchronize, median of ``STAGE_REPS`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(STAGE_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage_breakdown(trainer, state, batch) -> dict:
    """Each stage of a step timed alone on the trained state, as
    ``bench.py`` isolates its stages: the pull of both tables, the dense
    half (forward, backward, dense update) and the push of both tables.
    The stages mutate the state like steps do."""
    coll = trainer.collection
    placed = trainer.place_batch(batch)
    rows = coll.pull(state.emb, placed["sparse"])
    _, grads = trainer.dense_step(state, placed, rows)
    ids = batch["sparse"]["fields"]
    if ids.ndim == 3:                   # wide hash keys: (lo, hi) pairs
        from openembedding_tpu_torch.hash_table import join64
        ids = join64(ids)
    return {
        "pull_ms": _stage_ms(lambda: coll.pull(state.emb, placed["sparse"])),
        "dense_ms": _stage_ms(lambda: trainer.dense_step(state, placed,
                                                         rows)),
        "push_ms": _stage_ms(lambda: coll.apply_gradients(
            state.emb, placed["sparse"], grads)),
        "place_batch_ms": _stage_ms(lambda: trainer.place_batch(batch)),
        "unique_fraction": float(np.unique(ids).size / ids.size)}


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


def training_trace(trainer, state, batches, trace_path, lead) -> dict:
    """A ``torch.profiler`` trace of ``TRACE_STEPS`` steps (``train_step``:
    replays of the captured step) inside an annotated window, after one
    lead-in step on ``lead`` (the profiler may miss the first kernels of
    its trace): the device's busy share of the window's wall time
    (kernels, copies and fills, their union), device operations and graph
    launches a step, the top 5 device operations by time, the longest
    idle gaps between device work and the idle time by what the host was
    doing, and each kernel wrapper's launches a step, from its counter
    and from the kernels of each replay in the trace (they must
    agree)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    wrappers = {"gather_rows": gather_rows, "probe_gather": probe_gather,
                "init_rows": init_rows}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.train_step(state, lead)
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        with record_function(TRACE_WINDOW):
            t0 = time.perf_counter()
            for i in range(TRACE_STEPS):
                state, _ = trainer.train_step(state,
                                              batches[i % len(batches)])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    counted = {k: (w.launches - before[k]) / TRACE_STEPS
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
    # each replay whose kernels the profiler recorded holds each kernel
    # as many times as the counters say a step launches it
    traced = [v for c, v in replays.items() if recorded[c]] or [
        {k: n / TRACE_STEPS for k, n in window.items()}]
    if any({k: float(n) for k, n in v.items()} != counted for v in traced):
        raise AssertionError(
            f"trace: kernel launches per replay {traced} in the trace "
            f"({len(replays)} graph launches), {counted} a step by the "
            "counters")
    kernels = sum(1 for e in events if e["cat"] == "kernel")
    return {"steps": TRACE_STEPS, "wall_us": wall_us,
            "device_busy_us": busy,
            "device_busy_share": busy / wall_us if spans else None,
            "kernels_per_step": kernels / TRACE_STEPS,
            "device_ops_per_step": len(events) / TRACE_STEPS,
            "graph_launches_per_step": len(replays) / TRACE_STEPS,
            "replays_with_kernels_recorded": len(traced),
            "kernels_per_replay": statistics.mean(recorded.values())
            if recorded else None,
            "traced_launches_per_step": {k: n / TRACE_STEPS
                                         for k, n in window.items()},
            "launches_per_step": counted,
            "top5_us": dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:5]),
            "longest_idle_gaps_us": sorted((b - a for a, b in gaps),
                                           reverse=True)[:5],
            "idle_gaps_per_step": len(gaps) / TRACE_STEPS,
            "idle_us_by_host": _idle_by_host(gaps, host)}


def state_tensors(state) -> list:
    """Every tensor of a train state: step, dense state, each table's
    weights and slots (a hash table's keys and failure count too)."""
    from openembedding_tpu_torch.hash_table import HashTableState
    out = [state.step] + list(state.params.values()) \
        + list(state.opt_state.values())
    for st in state.emb.values():
        out += [st.weights] + list(st.slots.values())
        if isinstance(st, HashTableState):
            out += [st.keys, st.insert_failures]
    return out


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


def captured_against_eager(what, trainer, state, batches) -> dict:
    """The captured step's oracle: ``ORACLE_STEPS`` captured steps
    (``train_step`` on a copy of ``state``, which builds its own program)
    against as many eager ones (``train_step_eager`` on another copy),
    bit for bit: losses, dense parameters and accumulators, table rows
    and slots, and a hash table's keys and failure count. The push sums
    float gradients with ``index_add_``, atomics on the card, so two eager
    runs go first: if they differ, both sides run under
    ``torch.use_deterministic_algorithms(True)``; if an op of the step
    refuses that mode, the two are held at the eager runs' spread and the
    op is named. The kernel launches of these runs are not counted as the
    main path's: the counters are put back."""
    from openembedding_tpu_torch.ops.gather import gather_rows
    from openembedding_tpu_torch.ops.init_rows import init_rows
    from openembedding_tpu_torch.ops.probe_gather import probe_gather
    from openembedding_tpu_torch.training import copy_state
    wrappers = (gather_rows, probe_gather, init_rows)
    counted = [w.launches for w in wrappers]

    def run(step):
        s = copy_state(state, trainer.device)
        losses = []
        for b in batches[:ORACLE_STEPS]:
            s, m = step(s, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return [torch.stack(losses)] + state_tensors(s)
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
            if not deterministic or "deterministic" not in str(e):
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
    reading = {"steps": ORACLE_STEPS, "eager_vs_eager": spread,
               "deterministic_mode": deterministic, "refused_by": refused,
               "captured_vs_eager": diff,
               "bit_identical": diff["tensors"] == 0}
    if not ok:
        raise AssertionError(f"{what}: captured steps differ from eager "
                             f"steps: {json.dumps(reading)}")
    return reading


def _block(trainer, state, step, batches, batch_size, table):
    """One timed block: ``step`` over ``batches``, ended by a
    synchronize; returns the state, the last metrics, examples/s and the
    keys ``table`` (a hash table's name, or None) gained a step."""
    used = state.emb[table].num_used() if table else 0
    t0 = time.perf_counter()
    for b in batches:
        state, m = step(state, b)
    torch.cuda.synchronize()
    eps = len(batches) * batch_size / (time.perf_counter() - t0)
    gained = (state.emb[table].num_used() - used) / len(batches) \
        if table else None
    return state, m, eps, gained


def compare_steps(trainer, state, batch_of, batch_size, table=None):
    """Throughput of the captured step (``train_step``, replays) and of the
    eager one (``train_step_eager``) on one state: ``WARMUP_STEPS`` of
    each, then ``BLOCKS`` timed blocks of ``BLOCK_STEPS`` steps of each,
    in turns (the order flips every block). ``batch_of(kind, k, i)`` is
    step ``i`` of block ``k``. Returns the state, the last metrics and per
    kind the median block's examples/s (min, max), its step time and,
    for a hash table, the keys inserted a step and their share of a
    step's keys."""
    steps = {"captured": trainer.train_step,
             "eager": trainer.train_step_eager}
    for kind, step in steps.items():
        for i in range(WARMUP_STEPS):
            state, m = step(state, batch_of(kind, 0, i))
    torch.cuda.synchronize()
    blocks = {kind: [] for kind in steps}
    gained = {kind: [] for kind in steps}
    for k in range(BLOCKS):
        for kind in (list(steps) if k % 2 == 0 else list(steps)[::-1]):
            state, m, eps, g = _block(
                trainer, state, steps[kind],
                [batch_of(kind, k, i) for i in range(BLOCK_STEPS)],
                batch_size, table)
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
    return state, m, out


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
    stages = stage_breakdown(trainer, state, batches[0])
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
        "serve": served,
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


def check_ki_case(name, keys, skip, dim, dtype, cfg, flush):
    """KI against its plain version on the card on one case (exact for
    uniform and constant draws, normal ones within
    ``2^-21 * (|want| + stddev)``, bfloat16 one unit more), timed beside
    the plain version and the bound."""
    from openembedding_tpu_torch.ops.init_rows import (init_rows,
                                                       init_rows_reference)
    from openembedding_tpu_torch.optim import initializers as ti
    init = ti.make_initializer(cfg)
    kind, params = ti.keyed_params(init)
    base = (0x12345678, 0x9ABCDEF0)
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
            "keys": "pairs" if keys.dim() == 2 else "int32",
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
    """Phase 8; returns the KI cases and K2's and KI's launches on the hash
    training path (KI's array launches: the trainer's init)."""
    from openembedding_tpu_torch.data.criteo import synthetic_criteo
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
    launches["init_flat"] = flat_launches
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"hash training: loss {loss}")
    # a batch not yet seen: its pulls fill the missing rows every time;
    # its push inserts in the warm-up call only, so it is ``push_seen_ms``
    stages = stage_breakdown(trainer, state, stage_batches[0])
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
    stages = stage_breakdown(trainer, state, batches[0])
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


def hybrid_stages(trainer, state, batch) -> dict:
    """Each stage of a hybrid step timed alone: the collection's pull (24
    tables and the pooled history), the dense half (the dense-kept
    lookups, forward, backward, Adam) and the collection's push."""
    coll = trainer.collection
    placed = trainer.place_batch(batch)
    pull_inputs, _ = trainer._split_sparse(placed["sparse"])
    rows = coll.pull(state.emb, pull_inputs)
    _, grads = trainer.dense_step(state, placed, rows)
    return {
        "pull_ms": _stage_ms(lambda: coll.pull(state.emb, pull_inputs)),
        "dense_ms": _stage_ms(lambda: trainer.dense_step(state, placed,
                                                         rows)),
        "push_ms": _stage_ms(lambda: coll.apply_gradients(
            state.emb, pull_inputs, grads)),
        "place_batch_ms": _stage_ms(lambda: trainer.place_batch(batch))}


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
    stages = hybrid_stages(trainer, state, batches[0])
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


def ckpt_delta_ab(tmp: str) -> dict:
    """``ckpt_delta_ab`` on the card: a ``[2^22, 9]`` Adagrad table saved
    full (parallel writers), then 5 % of its rows pushed and 3 delta saves
    of those rows' chunks (1024 chunks; each repeat re-marks the same
    rows, as bench.py does), then the base and chain loaded (replayed) and
    held against the live table exactly, weights and slots."""
    from openembedding_tpu_torch import checkpoint as ck
    from openembedding_tpu_torch import checkpoint_delta as cd
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                    EmbeddingSpec)
    coll = EmbeddingCollection((EmbeddingSpec(
        name="big", input_dim=AB_VOCAB, output_dim=AB_DIM,
        optimizer={"category": "adagrad", "learning_rate": 0.01}),),
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

        def hooked():
            for i, b in enumerate(batches):
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
                yield b
        scope.reset()
        builds0 = trainer.builds
        cd.save_delta = publishing_save_delta
        try:
            state, m = trainer.fit(state, hooked(),
                                   autosave_every=AUTOSAVE_EVERY,
                                   autosave_dir=auto, retrace_budget=0)
        finally:
            cd.save_delta = orig_save_delta
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
        s2, m2 = t2.fit(s2, batches, resume_from=killed,
                        autosave_every=AUTOSAVE_EVERY, autosave_dir=killed,
                        retrace_budget=0)
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
TFR_SHARDS, TFR_ROWS = 2, 1 << 15   # the hash twin's TFRecord shards
HASH_INGEST_STEPS = 16
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
    return reading, trainer, state, rec_s["seen"][-1]


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


def main() -> None:
    card = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    if sys.argv[1:] == ["--ki"]:
        ki_only()
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
    coll, states, mapper, host, main_ids = setup_array()
    cases = phase_kernels(states["fields"].weights,
                          states["fields:linear"].weights, main_ids)
    launches = phase_serving(coll, states, mapper, host)
    del coll, states, host

    hcoll, hstates, batches, keys64, hhost = setup_hash()
    pcases = phase_probe_kernels(hstates, batches, keys64)
    plaunches = phase_hash_serving(hcoll, hstates, batches, hhost)
    del hcoll, hstates, hhost
    torch.cuda.empty_cache()

    k1_training, flat_training, fcases = phase_training()
    launches += k1_training
    torch.cuda.empty_cache()
    kcases, hash_launches = phase_hash_training()
    torch.cuda.empty_cache()
    k1_xdeep, flat_xdeep = phase_xdeepfm_training()
    launches += k1_xdeep
    flat_training += flat_xdeep
    torch.cuda.empty_cache()
    hybrid = phase_hybrid_training()
    launches += hybrid["gather_rows"]
    flat_training += hybrid["init_flat"]
    torch.cuda.empty_cache()
    delta = phase_delta()
    launches += delta["gather_rows"]
    flat_training += delta["init_flat"]
    torch.cuda.empty_cache()
    ingest = phase_ingest()
    launches += ingest["gather_rows"]
    flat_training += ingest["init_flat"]

    main_case, pmain, kmain, fmain = cases[0], pcases[0], kcases[0], \
        fcases[0]
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
        + ingest["probe_gather"],
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in pcases),
        "ms": pmain["kernel_ms"], "call_ms": pmain["kernel_call_ms"],
        "plain_ms": pmain["plain_ms"],
        "bound_ms": pmain["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "gather_part_ms": pmain["gather_ms"]}, {
        "name": "init_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/init_rows.cu",
        "replaces": "openembedding_tpu/hash_table.py:300 (init_rows) and "
                    "openembedding_tpu/optim/initializers.py:54-74 "
                    "(Uniform/Normal.init): XLA code, not Pallas kernels",
        "launches": hash_launches["init_rows"] + hybrid["init_rows"]
        + delta["init_rows"] + ingest["init_rows"] + flat_training
        + hash_launches["init_flat"],
        "launches_per_key": hash_launches["init_rows"] + hybrid["init_rows"]
        + delta["init_rows"] + ingest["init_rows"],
        "launches_array": flat_training + hash_launches["init_flat"],
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in kcases + fcases),
        "ms": kmain["kernel_ms"], "call_ms": kmain["kernel_call_ms"],
        "plain_ms": kmain["plain_ms"],
        "bound_ms": kmain["bound_ms"], "bound_by": kmain["bound_by"],
        "array_ms": fmain["kernel_ms"],
        "array_call_ms": fmain["kernel_call_ms"],
        "array_plain_ms": fmain["plain_ms"],
        "array_bound_ms": fmain["bound_ms"],
        "array_bound_by": fmain["bound_by"],
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
