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
5. the kernel list as one JSON line;
6. last line: ``{"ok": true, "device": {...}}``.

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


def gather_bound_bytes(table: torch.Tensor, ids: np.ndarray) -> int:
    """Bytes a row gather must move: the 32-byte sectors holding the
    distinct valid rows, read once, plus the ids read and the rows
    written."""
    vocab, dim = table.shape
    row_bytes = dim * table.element_size()
    uniq = np.unique(ids[(ids >= 0) & (ids < vocab)]).astype(np.int64)
    first = uniq * row_bytes // SECTOR
    last = (uniq * row_bytes + row_bytes - 1) // SECTOR
    spans = [first + k for k in range(int((last - first).max(initial=0)) + 1)]
    sectors = np.unique(np.concatenate(
        [s[s <= last] for s in spans])) if uniq.size else np.empty(0)
    return int(sectors.size * SECTOR + ids.size * ids.itemsize
               + ids.size * row_bytes)


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

    main_case = cases[0]
    log(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda",
        "source": "openembedding_tpu_torch/csrc/gather_rows.cu",
        "replaces": "openembedding_tpu/ops/pallas_gather.py:_gather_kernel",
        "launches": launches,
        "checked_against_plain": True,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["kernel_ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": main_case["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
