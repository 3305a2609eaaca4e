"""Smoke run of the torch port on one NVIDIA GPU: every kernel built from
``openembedding_tpu_torch/csrc``, held against its plain PyTorch version,
then the serving path driven end to end at full width.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits nonzero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile every ``csrc/*.cu`` (one nvcc each, in parallel);
3. kernel against plain: ``gather_rows`` vs ``gather_rows_reference`` on
   the card, exact equality (it is a copy), with CUDA-event medians of the
   kernel, the plain version and ``torch.index_select`` (the yardstick,
   never used by the port) beside the least time the card could take
   (bytes over 3.35 TB/s, table rows counted in 32-byte sectors);
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
   the main-path shape and on the cases ``phase_probe_kernels`` lists,
   timed beside the plain version, ``torch.index_select`` over the
   already-resolved slots ("gather part only": not the same function)
   and the bound (bytes over 3.35 TB/s);
6. hash serving path: the tables are saved, loaded through ``POST
   /models`` and queried with ``[4096, 26, 2]`` pair ``lookup_bin``
   requests, narrow int64 ids, misses and EMPTY pairs, and one JSON
   ``lookup``; every response must equal the host's key -> row
   dictionary exactly, and the probe kernel's launch count must cover
   every lookup;
7. the kernel list as one JSON line;
8. last line: ``{"ok": true, "device": {...}}``.

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

def _median_ms(fn, flush: torch.Tensor, queued: bool) -> float:
    """CUDA-event median of ``fn`` with the L2 flushed before each run.

    ``queued``: a ~1 ms spin kernel runs first, so ``fn``'s kernels are
    all enqueued before the start event fires and the events bracket
    device time alone; without it they also bracket the host's dispatch
    of ``fn`` (the time a caller pays per call).
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def check_case(name, table, ids_np, flush, gather_rows, reference):
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
            case[f"{k}_ms"] = _median_ms(fn, flush, queued=True)
        for k in ("kernel", "library"):
            case[f"{k}_call_ms"] = _median_ms(fns[k], flush, queued=False)
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


def fill_hash(state, keys: torch.Tensor, gen: torch.Generator):
    """Insert ``keys`` with seeded random rows and adagrad accumulators,
    ``LOAD_CHUNK`` at a time; returns the rows as inserted (on the
    device). Fails unless every key found a slot."""
    from openembedding_tpu_torch.hash_table import insert_rows
    n, dev = keys.shape[0], keys.device
    rows = torch.randn((n, state.dim), generator=gen, device=dev).to(
        state.weights.dtype)
    slots = {k: torch.rand((n,) + tuple(v.shape[1:]), generator=gen,
                           device=dev) + 0.1 for k, v in state.slots.items()}
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
            case[f"{k}_ms"] = _median_ms(fn, flush, queued=True)
        for k in ("kernel", "gather"):
            case[f"{k}_call_ms"] = _median_ms(fns[k], flush, queued=False)
        needed, windows = probe_bound_bytes(keys, weights, query, slots)
        case["bound_ms"] = needed / HBM_BYTES_PER_S * 1e3
        case["bound_windows_ms"] = windows / HBM_BYTES_PER_S * 1e3
    return case


def _narrow_table(dev, capacity, dim, keys: np.ndarray, gen):
    """An int32-key hash table filled with ``keys`` and random rows."""
    from openembedding_tpu_torch.hash_table import create_hash_table
    from openembedding_tpu_torch.meta import (UNBOUNDED_VOCAB,
                                              EmbeddingVariableMeta)
    st = create_hash_table(
        EmbeddingVariableMeta("float32", dim, UNBOUNDED_VOCAB), "default",
        capacity=capacity, key_dtype="int32", device=dev)
    fill_hash(st, torch.from_numpy(keys).to(dev), gen)
    return st


def phase_probe_kernels(states, batches, keys64):
    """K2 against its plain version on the card: the main-path shape (one
    ``[4096, 26, 2]`` batch on the filled ``fields`` table), the ``:linear``
    table, an int32-key table of the same capacity, the JAX kernel's own
    benchmark shape ``hash_probe_dim128`` (``[2^22, 128]``, 32,768
    queries), bf16 weights, a mix of hits, misses, EMPTY and hi != 0
    keys, n = 1 and n = 0."""
    from openembedding_tpu_torch.hash_table import join64
    fields, linear = states["fields"], states["fields:linear"]
    dev = fields.keys.device
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED + 1)
    main = torch.from_numpy(batches[0].reshape(-1, 2)).to(dev)
    fits = keys64[(keys64 > EMPTY32) & (keys64 < 2**31)].astype(np.int32)
    narrow = _narrow_table(dev, HASH_CAPACITY, 9, fits, gen)
    narrow_q = torch.from_numpy(join64(batches[0]).reshape(-1).astype(
        np.int32)).to(dev)
    probe_keys = (rng.permutation(1 << 23)[:1 << 21] + 1).astype(np.int32)
    t128 = _narrow_table(dev, 1 << 22, 128, probe_keys, gen)
    q128 = torch.from_numpy(probe_keys[rng.randint(0, probe_keys.size,
                                                   32768)]).to(dev)
    mixed = batches[-1].reshape(-1, 2).copy()
    mixed[::7, 1] = EMPTY32                                 # EMPTY
    mixed[3::11] = rng.randint(1 << 20, 1 << 30, (mixed[3::11].shape))
    mixed = torch.from_numpy(mixed).to(dev)
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


def main() -> None:
    phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
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

    cases = phase_kernels(states["fields"].weights,
                          states["fields:linear"].weights, main_ids)
    launches = phase_serving(coll, states, mapper, host)
    del coll, states, host

    from openembedding_tpu_torch.hash_table import split64
    hspecs, hmapper = make_fused_specs(
        SPARSE_NAMES, -1, 9, hash_capacity=HASH_CAPACITY,
        optimizer={"category": "adagrad", "learning_rate": 0.01})
    hcoll = EmbeddingCollection(hspecs, seed=SEED)
    hstates = hcoll.init()
    batches, keys64 = hash_keys(hmapper)
    t0 = time.perf_counter()
    pairs = torch.from_numpy(split64(keys64)).to(hcoll.device)
    gen = torch.Generator(device=hcoll.device).manual_seed(SEED)
    hhost = {name: HostRows(keys64, fill_hash(st, pairs, gen).cpu().numpy())
             for name, st in hstates.items()}
    log(f"hash fill: {keys64.size} keys into each of {len(hstates)} "
        f"tables of {HASH_CAPACITY} slots in "
        f"{time.perf_counter() - t0:.3f} s, 0 insert failures")
    pcases = phase_probe_kernels(hstates, batches, keys64)
    plaunches = phase_hash_serving(hcoll, hstates, batches, hhost)

    main_case, pmain = cases[0], pcases[0]
    log(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/gather_rows.cu",
        "replaces": "openembedding_tpu/ops/pallas_gather.py:37",
        "launches": launches,
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": main_case["library_ms"]}, {
        "name": "probe_gather", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/probe_gather.cu",
        "replaces": "openembedding_tpu/ops/pallas_hash.py:40",
        "launches": plaunches,
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in pcases),
        "ms": pmain["kernel_ms"], "plain_ms": pmain["plain_ms"],
        "bound_ms": pmain["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "gather_part_ms": pmain["gather_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
