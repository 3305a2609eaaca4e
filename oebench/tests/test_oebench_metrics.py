"""The arithmetic of the metrics, on hand-made traces and shapes."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

from conftest import REPO

from oebench import peaks
from oebench.layout import Bench
from oebench.timing import StepTimer, percentile
from oebench.trace import breakdown, reduce_trace

BENCH = Bench(REPO)


def _event(name, cat, ts, dur, corr=None):
    e = {"name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """A window of 100 us over 2 steps: two graph launches whose kernels
    cover 10-30, 25-40 and 60-80 (one kernel a little before the window,
    found by its launch's correlation), a copy 85-90; idle 0-10, 40-60,
    80-85 and 90-100 by the host's clock."""
    return [
        _event("oebench.traced_steps", "user_annotation", 1000, 100),
        _event("cudaGraphLaunch", "cuda_runtime", 1001, 5, corr=7),
        _event("cudaGraphLaunch", "cuda_runtime", 1043, 5, corr=8),
        _event("cudaMemcpyAsync", "cuda_runtime", 1041, 19),
        _event("void ns::gather_fixed<9>(float*)", "kernel", 1010, 20,
               corr=7),
        _event("void ns::other_kernel(int)", "kernel", 1025, 15, corr=7),
        _event("void ns::probe_gather_kernel(int)", "kernel", 995, 5,
               corr=8),
        _event("void ns::gather_fixed<1>(float*)", "kernel", 1060, 20,
               corr=8),
        _event("Memcpy HtoD", "gpu_memcpy", 1085, 5),
        _event("before the window", "kernel", 900, 10),
    ]


def test_reduce_trace_busy_gaps_and_kernels():
    t = reduce_trace(hand_trace(), [3, 4])
    assert t.window_us == 100
    # union within the window: 10-40, 60-80, 85-90 (the early kernel
    # clipped away)
    assert t.busy_us == pytest.approx(30 + 20 + 5)
    assert t.gaps == [(1040.0, 1060.0), (1080.0, 1085.0)]
    assert sorted(t.kernels(("gather_fixed",))) == [20.0, 20.0]
    assert len(t.device) == 5          # 4 kernels (one by correlation), 1 copy
    assert t.idle_by_host == {"cudaMemcpyAsync": 20.0,
                              "(no host event)": 5.0}
    b = breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    assert b["idle_gaps"][0] == ["cudaMemcpyAsync", 20e-6]


def test_window_between_synchronizations_without_the_annotation():
    """A trace of the device's activity alone holds no annotation: the
    window runs from the end of the synchronization before its first step
    to the end of the one after its last."""
    events = [e for e in hand_trace() if e["cat"] != "user_annotation"]
    events += [_event("cudaDeviceSynchronize", "cuda_runtime", 990, 10),
               _event("cudaDeviceSynchronize", "cuda_runtime", 1091, 9)]
    t = reduce_trace(events, [3, 4])
    assert t.window_us == 100
    assert t.busy_us == pytest.approx(55)
    with pytest.raises(ValueError):
        reduce_trace(events[:-2], [3, 4])


def test_zipf_ids_stay_within_each_vocabulary_and_skew():
    from oebench.traffic import load_distribution
    zipf = load_distribution("zipf")
    g = torch.Generator().manual_seed(3)
    sizes = torch.tensor([3, 1, 1000])
    ids = zipf.draw({"a": 1.2}, (4000, 3), g, "cpu", sizes)
    assert ids.dtype == torch.int64
    assert bool(((ids >= 0) & (ids < sizes)).all())
    assert set(ids[:, 0].tolist()) == {0, 1, 2}
    assert set(ids[:, 1].tolist()) == {0}
    counts = torch.bincount(ids[:, 2], minlength=1000).sort(
        descending=True).values
    # zipf: the most popular id far above the median one
    assert counts[0] > 20 * max(1, int(counts[500]))


def _ctx(**kw):
    base = dict(config=BENCH.config("deepfm_dim9"), steps=0, window_s=0.0,
                trace=None, pool=None, batches=None, state=None)
    return types.SimpleNamespace(**{**base, **kw})


def test_idle_share_and_ops_per_step():
    t = reduce_trace(hand_trace(), [3, 4])
    # 55 us busy over the 2 traced steps; the untraced window took 50 us a
    # step (the profiler stretched the traced one to 100 us in all)
    ctx = _ctx(trace=t, steps=10, window_s=500e-6)
    assert BENCH.reader("device_idle_share").read(ctx) == pytest.approx(45.0)
    ctx = _ctx(trace=t, steps=10, window_s=1000e-6)
    assert BENCH.reader("device_idle_share").read(ctx) == pytest.approx(72.5)
    assert BENCH.reader("device_ops_per_step").read(ctx) == 2.5
    assert BENCH.reader("device_idle_share").read(_ctx()) is None


def test_train_mfu_counts_the_shapes():
    mfu = BENCH.reader("train_mfu")
    config = BENCH.config("deepfm_dim9")
    # the tower: (26 * 9 + 13) x 256 + 256 x 128 + 128 x 1 multiply-adds
    macs = 247 * 256 + 256 * 128 + 128
    want = 3 * (2 * 4096 * macs + 4096 * (3 * 26 * 9 + 2 * 9) + 4096 * 26)
    assert mfu.step_flops(config) == want
    tiny = {**config, "batch_size": 2, "num_features": 2,
            "vocab_sizes": [10, 10]}
    ids = np.array([[1, 3], [1, 4]])      # rows 1, 13, 1, 14: 3 distinct
    params = sum(int(np.prod(s)) for s in [(256, 2 * 9 + 13), (256,),
                                           (128, 256), (128,), (1, 128),
                                           (1,), (1,)])
    want_bytes = 3 * 9 * 4 * 4 + 4 * 4 + 3 * 1 * 4 * 4 + 4 * 4 \
        + params * 16
    assert mfu.step_bytes(tiny, ids) == want_bytes
    ctx = _ctx(config=tiny, steps=1000, window_s=1.0,
               pool=_Pool(np.stack([ids, ids])))
    least = max(mfu.step_flops(tiny) / peaks.FP32_FLOPS,
                want_bytes / peaks.HBM_BYTES)
    assert mfu.read(ctx) == pytest.approx(100 * least / 1e-3)


class _Pool:
    def __init__(self, ids):
        self.ids = ids

    def __len__(self):
        return self.ids.shape[0]


def test_k1_bound_counts_sectors_once():
    k1 = BENCH.reader("k1_roofline_share")
    # 36-byte rows 0 and 1 share a sector: rows 0, 1 -> sectors 0, 1, 2
    assert k1.row_sector_bytes(36, np.array([0, 1, 1])) == 3 * 32
    ids = np.array([0, 1, 1, 50, -1], dtype=np.int32)
    want = k1.row_sector_bytes(36, np.array([0, 1, 1, 50])) + 5 * 4 + 5 * 36
    assert k1.gather_bound_bytes(100, 36, ids) == want


def test_k1_share_from_the_trace():
    k1 = BENCH.reader("k1_roofline_share")
    config = {**BENCH.config("deepfm_dim9"), "num_features": 2,
              "vocab_sizes": [10, 10]}
    t = reduce_trace(hand_trace(), [0, 0])
    ids = np.array([[1, 3], [2, 4]], dtype=np.int32)
    ctx = _ctx(config=config, trace=t,
               batches=[{"sparse": {"fields": ids}}])
    per_launch = np.mean([k1.gather_bound_bytes(20, 36, ids),
                          k1.gather_bound_bytes(20, 4, ids)]) \
        / peaks.HBM_BYTES
    assert k1.read(ctx) == pytest.approx(100 * per_launch * 2 / 40e-6)


def test_k2_bound_stops_at_the_match_or_the_first_empty_slot():
    k2 = BENCH.reader("k2_roofline_share")
    capacity = 512
    keys = torch.full((capacity, 2), k2.EMPTY, dtype=torch.int32)
    query = torch.tensor([[5, 0], [9, 0]], dtype=torch.int32)
    bsz, nb, chain = k2.layout(capacity)
    start = (k2.mix_pair(query[:, 0], query[:, 1]) % (nb - chain + 1)) * bsz
    keys[start[0] + 3] = query[0]        # found at offset 3
    got = k2.probe_bound_bytes(keys, 36, query)
    s = start.numpy()
    lo = s * 8 // 32
    hi = np.array([((s[0] + 4) * 8 - 1) // 32, ((s[1] + 1) * 8 - 1) // 32])
    want = (k2.union_length(lo, hi) * 32
            + k2.row_sector_bytes(36, np.array([s[0] + 3]))
            + 2 * 8 + 2 * 36 + 2)
    assert got == want


def test_step_p95_is_taken_over_every_step():
    timer = StepTimer("cpu")
    timer.start()
    for i in range(100):
        time.sleep(0.02 if i in (10, 50, 90) else 0.0005)
        timer.mark()
    timer.stop()
    ms = timer.step_ms()
    assert len(ms) == 100 == timer.steps
    # 3 stalls of 100 steps lie beyond the 95th percentile's rank...
    assert percentile(ms, 95) < 15
    # ...and 6 would not: a percentile of every step, not of blocks
    assert percentile(sorted(ms)[:94] + [20.0] * 6, 95) == 20.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0
