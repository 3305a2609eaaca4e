"""Torch port, micro-batched serving (``serving/batcher.py`` and the
registry's batched path) held against the JAX package.

The cases of ``tests/test_serving_batcher.py`` on the port, its
PointGate/SerialSchedule replays of the ``serving_batcher`` protocol
schedules among them: batched rows equal unbatched ones and the JAX
registry's bit for bit, a hot-swap mid-batch serves exactly one version,
shutdown answers every accepted request, a full queue refuses with
``BusyError`` and never fails an accepted request. Beside them: the
port's ``dedup_keys`` equals JAX's on seeded inputs, the adaptive tuner
takes JAX's knob steps from the same samples, ``warm_batch_programs``
returns JAX's count, and the port's load generator draws graftload's
arrivals.
"""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving import batcher as jbatcher
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu.utils import envconfig as jenv
from openembedding_tpu_torch import checkpoint as ck
from openembedding_tpu_torch import checkpoint_delta as cd
from openembedding_tpu_torch.analysis import scope
from openembedding_tpu_torch.analysis.concurrency import (PointGate,
                                                          SerialSchedule,
                                                          clear_schedule,
                                                          install_schedule)
from openembedding_tpu_torch.serving import load
from openembedding_tpu_torch.serving.batcher import (AdaptiveBatchTuner,
                                                     BusyError,
                                                     LookupBatcher,
                                                     dedup_keys)
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.utils import envconfig
from openembedding_tpu_torch.utils import observability as obs

from test_torch_delta import VOCAB, make_coll, snapshot, train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leftover_schedule():
    yield
    clear_schedule()


@pytest.fixture()
def served(tmp_path):
    """A trained delta-armed model (array + int32-key hash variable) at
    version 1 in a BATCHED port registry on the CPU, the trainer's
    collection and states for ground truth, and the same dump in a JAX
    registry."""
    coll = make_coll()
    states = coll.init()
    path = str(tmp_path / "m")
    ck.save_checkpoint(path, coll, states, mode="delta", step=0,
                       model_sign="batch-1")
    train(coll, states, 0)
    info = cd.save_delta(path, coll, states, step=1, return_payload=True,
                         compact_bytes_ratio=1e18, background_compact=False)
    assert info["seq"] == 1
    reg = ModelRegistry(device="cpu", default_hash_capacity=2048)
    reg.enable_batching(max_batch_rows=64, max_wait_us=3000)
    sign = reg.create_model(path, block=True)
    yield reg, sign, coll, states, path
    reg.close()


def _host(rows) -> np.ndarray:
    if isinstance(rows, torch.Tensor):
        return rows.numpy()
    return np.asarray(rows, np.float32)


# --- bit-identical parity ----------------------------------------------------

def test_batched_parity_bit_identical(served):
    """Concurrent flat lookups (duplicate keys, both dtypes) coalesce;
    every response equals the unbatched rows and the JAX registry's on
    the same dump exactly."""
    reg, sign, _coll, _states, path = served
    model = reg.find_model(sign)
    jreg = JaxRegistry(create_mesh(1, 1, jax.devices()[:1]),
                       default_hash_capacity=2048)
    jreg.create_model(path, model_sign=sign, block=True)
    rng = np.random.RandomState(7)
    queries = [("arr", rng.randint(0, VOCAB, 16).astype(np.int32)),
               ("arr", rng.randint(0, VOCAB, 5).astype(np.int64)),
               ("hsh", rng.randint(0, 2**20, 16).astype(np.int32)),
               ("arr", np.array([3, 3, 3, 9], np.int32)),
               ("hsh", np.array([12345, 12345], np.int32))]
    want = [_host(model.lookup(v, q)) for v, q in queries]
    got = [None] * len(queries)
    flushes0 = obs.GLOBAL.snapshot().get("batch_flushes", {}).get("count", 0)

    def go(i, v, q):
        got[i] = _host(reg.lookup(sign, v, q))

    threads = [threading.Thread(target=go, args=(i, v, q))
               for i, (v, q) in enumerate(queries)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    for i, (v, q) in enumerate(queries):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"query {i}")
        np.testing.assert_array_equal(
            got[i], np.asarray(jreg.lookup(sign, v, q), np.float32),
            err_msg=f"query {i} against JAX")
    assert obs.GLOBAL.snapshot()["batch_flushes"]["count"] > flushes0
    jreg.close()


def test_sequence_queries_fall_through_unbatched(served):
    reg, sign, _coll, _states, _path = served
    model = reg.find_model(sign)
    assert model.batchable("arr", np.arange(4, dtype=np.int32)) == "arr"
    seq = np.arange(8, dtype=np.int32).reshape(2, 4)
    assert model.batchable("arr", seq) is None
    assert model.batchable("arr", np.arange(4.0)) is None
    assert model.batchable("nope", np.arange(4)) is None
    np.testing.assert_array_equal(_host(reg.lookup(sign, "arr", seq)),
                                  _host(model.lookup("arr", seq)))


def test_dedup_keys_unit():
    uniq, inv = dedup_keys(np.array([5, 1, 5, 9, 1], np.int64))
    np.testing.assert_array_equal(uniq, [1, 5, 9])
    np.testing.assert_array_equal(uniq[inv], [5, 1, 5, 9, 1])
    pairs = np.array([[1, 0], [2, 0], [1, 0]], np.int32)
    up, inv = dedup_keys(pairs)
    assert up.shape == (2, 2)
    np.testing.assert_array_equal(up[inv], pairs)


@pytest.mark.parametrize("kind", ["int32", "int64", "pairs"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_keys_match_jax(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "pairs":
        cat = rng.randint(-3, 3, (200, 2)).astype(np.int32)
    else:
        cat = rng.randint(-50, 50, 300).astype(np.dtype(kind))
    got = dedup_keys(cat)
    want = jbatcher.dedup_keys(cat)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --- swap-landing-mid-batch (PointGate schedule) -----------------------------

def test_swap_mid_batch_serves_exactly_one_version(served):
    """A hot-swap lands while a batch is parked between its snapshot and
    its pull: the batch answers from its one (pre-swap) snapshot, the
    next lookup sees the new version whole."""
    reg, sign, coll, states, path = served
    model = reg.find_model(sign)
    probe = np.arange(0, 32, dtype=np.int32)
    want_old = _host(model.lookup("arr", probe))
    states2 = snapshot(states)
    train(coll, states2, 5, arr_ids=np.arange(0, 16, dtype=np.int32))
    delta = cd.save_delta(path, coll, states2, step=2, return_payload=True,
                          compact_bytes_ratio=1e18,
                          background_compact=False)["delta"]
    want_new = coll.pull(states2, {"arr": probe}, read_only=True)[
        "arr"].numpy()
    assert not np.array_equal(want_old, want_new)

    gate = PointGate(["serving.batch.pull"], timeout=30)
    install_schedule(gate)
    out = {}

    def storm():
        out["rows"] = _host(reg.lookup(sign, "arr", probe))

    t = threading.Thread(target=storm, name="storm")
    t.start()
    assert gate.wait_arrival("serving.batch.pull")
    res = reg.apply_delta(sign, delta)
    assert res["applied"] and res["version"] == 2
    gate.open("serving.batch.pull")
    t.join(30)
    clear_schedule()
    assert not t.is_alive()
    np.testing.assert_array_equal(out["rows"], want_old)
    np.testing.assert_array_equal(_host(reg.lookup(sign, "arr", probe)),
                                  want_new)


def test_resnapshot_mutation_replay_mixes_versions(served):
    """The ``resnapshot_per_pull`` counterexample executed on the port:
    with the mutation (each group's pull reads the LIVE states) the
    exported schedule hands one batch rows of two versions; the real
    batcher under the same schedule serves both from its snapshot."""
    reg, sign, coll, states, path = served
    model = reg.find_model(sign)
    probe32 = np.arange(0, 16, dtype=np.int32)    # group A (int32)
    probe64 = np.arange(0, 16, dtype=np.int64)    # group B (int64)
    want_old = _host(model.lookup("arr", probe32))
    path_v1 = path + "_v1"
    shutil.copytree(path, path_v1)
    states2 = snapshot(states)
    train(coll, states2, 6, arr_ids=np.arange(0, 16, dtype=np.int32))
    delta = cd.save_delta(path, coll, states2, step=2, return_payload=True,
                          compact_bytes_ratio=1e18,
                          background_compact=False)["delta"]
    want_new = coll.pull(states2, {"arr": probe32}, read_only=True)[
        "arr"].numpy()

    def run(mutate, sign, model):
        b = reg._batcher_for(sign, model)
        if mutate:
            b._pull_unique = lambda _snap, name, uniq: model.pull_bucket(
                name, uniq, model.states)
        sched = SerialSchedule(
            ["serving.batch.pull", "registry.find",
             "registry.swap.build", "registry.swap.commit",
             "serving.batch.pull"], timeout=30)
        install_schedule(sched)
        r1 = b.offer("arr", probe32)
        r2 = b.offer("arr", probe64)
        res = reg.apply_delta(sign, delta)
        assert res["applied"]
        rows1 = r1.wait(30)
        rows2 = r2.wait(30)
        clear_schedule()
        assert sched.done()
        return rows1, rows2

    rows1, rows2 = run(True, sign, model)
    np.testing.assert_array_equal(rows1, want_old)
    np.testing.assert_array_equal(rows2, want_new)     # the MIXED batch
    reg.delete_model(sign)
    sign = reg.create_model(path_v1, model_sign="batch-ctl", block=True)
    model = reg.find_model(sign)
    assert model.version == 1
    rows1, rows2 = run(False, sign, model)
    np.testing.assert_array_equal(rows1, want_old)
    np.testing.assert_array_equal(rows2, want_old)     # one version
    reg.delete_model(sign)


# --- shutdown-with-queued-requests -------------------------------------------

def test_shutdown_drains_every_queued_request(served):
    reg, sign, _coll, _states, _path = served
    model = reg.find_model(sign)
    b = reg._batcher_for(sign, model)
    probe = np.arange(8, dtype=np.int32)
    want = _host(model.lookup("arr", probe))
    gate = PointGate(["serving.batch.pull"], timeout=30)
    install_schedule(gate)
    first = b.offer("arr", probe)
    assert gate.wait_arrival("serving.batch.pull")
    queued = [b.offer("arr", probe) for _ in range(3)]
    closer = threading.Thread(target=b.close, name="closer")
    closer.start()
    gate.open("serving.batch.pull")
    closer.join(30)
    clear_schedule()
    assert not closer.is_alive()
    for req in [first] + queued:
        np.testing.assert_array_equal(req.wait(1.0), want)
    with pytest.raises(BusyError):
        b.offer("arr", probe)


# --- backpressure ------------------------------------------------------------

def test_bounded_queue_rejects_never_collapses():
    calls = []

    def slow_pull(_snap, _name, uniq):
        time.sleep(0.02)
        calls.append(uniq.size)
        return uniq[:, None].astype(np.float32) * np.ones(4, np.float32)

    rejected_before = obs.GLOBAL.snapshot().get(
        "serving_rejected", {}).get("count", 0)
    b = LookupBatcher("bp", lambda: None, slow_pull,
                      max_batch_rows=8, max_wait_us=0, max_queue_rows=16)
    try:
        accepted, rejected = [], 0
        for _ in range(200):
            try:
                accepted.append(b.offer("v", np.arange(4, dtype=np.int64)))
            except BusyError:
                rejected += 1
        assert rejected > 0, "storm never hit the bound"
        assert accepted, "everything rejected"
        for req in accepted:
            np.testing.assert_array_equal(
                req.wait(30), np.arange(4)[:, None] * np.ones(4, np.float32))
    finally:
        b.close()
    after = obs.GLOBAL.snapshot()["serving_rejected"]["count"]
    assert after - rejected_before == rejected
    assert "oe_serving_rejected_total" in obs.prometheus_text()


def test_oversized_single_request_admitted_when_idle():
    release = threading.Event()

    def gated_pull(_snap, _name, uniq):
        release.wait(10)
        return uniq[:, None].astype(np.float32) * np.ones(2, np.float32)

    b = LookupBatcher("big", lambda: None, gated_pull,
                      max_batch_rows=8, max_wait_us=0, max_queue_rows=8)
    try:
        big = b.offer("v", np.arange(20, dtype=np.int64))
        deadline = time.perf_counter() + 10
        while b.stats()["queue_rows"] and time.perf_counter() < deadline:
            time.sleep(0.001)
        small = b.offer("v", np.arange(4, dtype=np.int64))
        with pytest.raises(BusyError):
            b.offer("v", np.arange(20, dtype=np.int64))
        release.set()
        np.testing.assert_array_equal(
            big.wait(10), np.arange(20)[:, None] * np.ones(2, np.float32))
        np.testing.assert_array_equal(
            small.wait(10), np.arange(4)[:, None] * np.ones(2, np.float32))
    finally:
        release.set()
        b.close()


def test_batcher_pull_error_reaches_every_group_member():
    def boom(_snap, _name, _uniq):
        raise RuntimeError("pull exploded")

    b = LookupBatcher("err", lambda: None, boom, max_wait_us=5000)
    try:
        r1 = b.offer("v", np.arange(3, dtype=np.int64))
        r2 = b.offer("v", np.arange(3, dtype=np.int64))
        for r in (r1, r2):
            with pytest.raises(RuntimeError, match="pull exploded"):
                r.wait(30)
    finally:
        b.close()


def test_flusher_survives_snapshot_error():
    boom = [True]

    def snap():
        if boom[0]:
            raise RuntimeError("snapshot exploded")
        return None

    def pull(_snap, _name, uniq):
        return uniq[:, None].astype(np.float32) * np.ones(4, np.float32)

    b = LookupBatcher("snap-err", snap, pull, max_wait_us=0)
    try:
        with pytest.raises(RuntimeError, match="snapshot exploded"):
            b.lookup("v", np.arange(3, dtype=np.int64))
        boom[0] = False
        rows = b.lookup("v", np.arange(3, dtype=np.int64), timeout=10)
        np.testing.assert_array_equal(
            rows, np.arange(3)[:, None] * np.ones(4, np.float32))
        assert b._thread.is_alive()
    finally:
        b.close()


def test_same_sign_reload_rebinds_batcher(served):
    reg, sign, coll, states, path = served
    model = reg.find_model(sign)
    b_old = reg._batcher_for(sign, model)
    probe = np.arange(8, dtype=np.int32)
    np.testing.assert_array_equal(_host(reg.lookup(sign, "arr", probe)),
                                  _host(model.lookup("arr", probe)))
    train(coll, states, 9, arr_ids=np.arange(0, 16, dtype=np.int32))
    cd.save_delta(path, coll, states, step=2, compact_bytes_ratio=1e18,
                  background_compact=False)
    reg.create_model(path, model_sign=sign, block=True)
    model2 = reg.find_model(sign)
    assert model2 is not model and model2.version == 2
    want2 = _host(model2.lookup("arr", probe))
    np.testing.assert_array_equal(_host(reg.lookup(sign, "arr", probe)),
                                  want2)
    b_new = reg._batcher_for(sign, model2)
    assert b_new is not b_old
    with pytest.raises(BusyError):
        b_old.offer("arr", probe)


def test_rotate_surfaces_all_busy_as_429():
    import io
    import urllib.error
    from openembedding_tpu_torch.serving import ha

    router = ha.RoutingClient(["h1:1", "h2:1"])

    def busy(ep):
        raise urllib.error.HTTPError(f"http://{ep}/x", 429,
                                     "busy", {}, io.BytesIO(b""))

    with pytest.raises(urllib.error.HTTPError) as ei:
        router._rotate(busy)
    assert ei.value.code == 429

    def half_dead(ep):
        if ep == "h1:1":
            raise ConnectionError("down")
        raise urllib.error.HTTPError(f"http://{ep}/x", 503,
                                     "creating", {}, io.BytesIO(b""))

    router.policy = ha.RetryPolicy(deadline_s=0.5, base_backoff_s=0.01,
                                   max_backoff_s=0.05)
    with pytest.raises(ConnectionError):
        router._rotate(half_dead)

    def dead_plus_busy(ep):
        if ep == "h1:1":
            raise ConnectionError("down")
        raise urllib.error.HTTPError(f"http://{ep}/x", 429,
                                     "busy", {}, io.BytesIO(b""))

    for _ in range(8):
        with pytest.raises(urllib.error.HTTPError) as ei:
            router._rotate(dead_plus_busy)
        assert ei.value.code == 429


def test_storm_counts_rejections_apart_from_errors():
    """``load.run_storm`` tallies ``RejectedError`` apart: rejections are
    neither completions nor errors."""
    def send(i):
        if i % 3 == 0:
            raise load.RejectedError("busy")

    arrivals = np.linspace(0.0, 0.2, 30)
    res = load.run_storm(send, arrivals, route="rest", offered_qps=150.0,
                         duration=0.2, workers=4)
    assert res.rejected == 10 and res.errors == 0
    assert res.calls == 30
    s = res.summary()
    assert s["rejected"] == 10
    # every send's lateness against its intended time is kept
    assert res.lateness_ms.size == 30 and s["late_max_ms"] >= 0


@pytest.mark.parametrize("rate,duration,seed",
                         [(200.0, 10.0, 0), (300.0, 10.0, 1),
                          (1.5, 4.0, 7), (0.0, 1.0, 0)])
def test_poisson_arrivals_match_graftload(rate, duration, seed):
    sys.path.insert(0, REPO)
    from tools import graftload as gl
    np.testing.assert_array_equal(
        load.poisson_arrivals(rate, duration, seed),
        gl.poisson_arrivals(rate, duration, seed))


# --- observability -----------------------------------------------------------

def test_batch_metrics_and_member_traces(served):
    reg, sign, _coll, _states, _path = served
    scope.set_tracing(True)
    scope.reset()
    try:
        rows_before = scope.HISTOGRAMS.count("serving_batch_rows")
        with scope.trace_context() as tid:
            reg.lookup(sign, "arr", np.arange(6, dtype=np.int32))
        assert scope.HISTOGRAMS.count("serving_batch_rows") \
            == rows_before + 1
        assert scope.HISTOGRAMS.count("serving_batch_wait_us") >= 1
        text = obs.prometheus_text()
        assert "oe_batch_rows_total" in text
        assert "oe_batch_flushes_total" in text
        assert "oe_serving_lookup_rows_bucket" in text
        trace = scope.export_chrome_trace()
        members = [e for e in trace["traceEvents"]
                   if e.get("name") == "serving.batch.member"
                   and e.get("args", {}).get("trace") == tid]
        assert members, "no member span with the request trace id"
    finally:
        scope.set_tracing(None)


# --- live knob retune and the online tuner -----------------------------------

def test_mid_storm_knob_flip_moves_next_flush():
    entered = threading.Event()
    release = threading.Event()
    flush_sizes = []

    def gated_pull(_snap, _name, uniq):
        flush_sizes.append(uniq.size)
        entered.set()
        release.wait(10)
        return uniq[:, None].astype(np.float32) * np.ones(2, np.float32)

    b = LookupBatcher("flip", lambda: None, gated_pull,
                      max_batch_rows=8, max_wait_us=500_000,
                      max_queue_rows=1024)
    try:
        first = b.offer("v", np.arange(8, dtype=np.int64))
        assert entered.wait(10)
        backlog = [b.offer("v", np.arange(8 * (i + 1), 8 * (i + 2),
                                          dtype=np.int64))
                   for i in range(4)]
        assert b.set_knobs(max_batch_rows=32, max_wait_us=0) \
            == {"max_batch_rows": 32, "max_wait_us": 0,
                "max_queue_rows": 1024}
        assert b.knobs()["max_batch_rows"] == 32
        release.set()
        np.testing.assert_array_equal(
            first.wait(10), np.arange(8)[:, None] * np.ones(2, np.float32))
        for i, req in enumerate(backlog):
            want = np.arange(8 * (i + 1), 8 * (i + 2))[:, None] \
                * np.ones(2, np.float32)
            np.testing.assert_array_equal(req.wait(10), want)
        assert flush_sizes == [8, 32]
        assert b.stats()["flushes"] == 2
    finally:
        release.set()
        b.close()


class _FakeBatcher:
    """A batcher stand-in replaying recorded stats samples."""

    def __init__(self, samples, knobs):
        self.name = "fake"
        self._samples = list(samples)
        self._i = 0
        self._knobs = dict(knobs)
        self.steps = []

    def stats(self):
        s = self._samples[min(self._i, len(self._samples) - 1)]
        self._i += 1
        return dict(s)

    def knobs(self):
        return dict(self._knobs)

    def set_knobs(self, **kw):
        self.steps.append(dict(kw))
        self._knobs.update(kw)
        return dict(self._knobs)


def _samples(seed):
    """Cumulative batcher stats: bursts of backlog, idle spells and
    rejections, seeded."""
    rng = np.random.RandomState(seed)
    s = {"queue_rows": 0.0, "queued_requests": 0.0, "flushes": 0.0,
         "flush_rows": 0.0, "rejects": 0.0}
    out = [dict(s)]
    for _ in range(60):
        mode = rng.randint(4)
        flushes = float(rng.randint(0, 20))
        s["flushes"] += flushes
        s["flush_rows"] += flushes * (1024.0 if mode == 0 else
                                      rng.randint(1, 200))
        s["rejects"] += float(rng.randint(0, 3) if mode == 1 else 0)
        s["queue_rows"] = float(rng.randint(2000, 5000) if mode == 2 else 0)
        out.append(dict(s))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tuner_takes_jax_steps_from_the_same_samples(seed):
    """From the same stats samples both tuners take the same knob steps
    and count the same ``plan_adjust`` decisions."""
    kw = dict(online=True, adjust_interval_ms=3_600_000, hysteresis=2)
    samples = _samples(seed)
    knobs = {"max_batch_rows": 1024, "max_wait_us": 200,
             "max_queue_rows": 32768}
    fakes, tuners = [], []
    for tuner_cls, plan in ((AdaptiveBatchTuner, envconfig.PlanConfig(**kw)),
                            (jbatcher.AdaptiveBatchTuner,
                             jenv.PlanConfig(**kw))):
        fake = _FakeBatcher(samples, knobs)
        tuners.append(tuner_cls(fake, plan))
        fakes.append(fake)
    try:
        got = [[t.sample() for _ in range(len(samples) - 1)]
               for t in tuners]
    finally:
        for t in tuners:
            t.stop(restore=False)
    assert got[0] == got[1]
    assert fakes[0].steps == fakes[1].steps
    assert sum(got[0]) == len(fakes[0].steps) > 0


@pytest.mark.parametrize("online", [False, True])
def test_warm_batch_programs_count_matches_jax(served, tmp_path, online):
    """The warm ladder's count equals JAX's for the same dumps: an array
    and an int32-key hash variable, and a wide-key hash model."""
    from openembedding_tpu_torch.embedding import (EmbeddingCollection,
                                                   EmbeddingSpec)
    _reg, _sign, _coll, _states, path = served
    wcoll = EmbeddingCollection(
        [EmbeddingSpec(name="w", input_dim=-1, output_dim=4,
                       hash_capacity=256, key_dtype="wide")], device="cpu")
    wpath = str(tmp_path / "wide")
    ck.save_checkpoint(wpath, wcoll, wcoll.init(), model_sign="wide-1")
    plan = dict(online=True, rows_floor=64, rows_ceiling=256)
    counts = []
    for reg in (ModelRegistry(device="cpu", default_hash_capacity=2048),
                JaxRegistry(create_mesh(1, 1, jax.devices()[:1]),
                            default_hash_capacity=2048)):
        assert reg.warm_batch_programs() == 0       # batching off
        pc = (envconfig.PlanConfig(**plan) if isinstance(reg, ModelRegistry)
              else jenv.PlanConfig(**plan)) if online else None
        reg.enable_batching(max_batch_rows=128, plan=pc)
        reg.create_model(path, model_sign="m", block=True)
        reg.create_model(wpath, model_sign="w", block=True)
        counts.append(reg.warm_batch_programs())
        reg.close()
    assert counts[0] == counts[1] > 0


def test_rest_full_queue_answers_429_and_accepted_complete(served):
    """Over REST: with the flusher parked on one request and a second
    filling the bounded queue, a third gets HTTP 429 (counted as a
    rejection) while both accepted requests complete 200 with their
    rows once the flusher moves on."""
    import http.client
    import json
    from openembedding_tpu_torch.serving.rest import ControllerServer
    reg, sign, _coll, _states, _path = served
    reg.enable_batching(max_batch_rows=8, max_wait_us=0, max_queue_rows=8)
    model = reg.find_model(sign)
    srv = ControllerServer(reg, port=0).start()
    probe = np.arange(8, dtype=np.int32)
    body = json.dumps({"variable": "arr", "dtype": "int32",
                       "shape": [8]}).encode() + b"\n" + probe.tobytes()

    def post():
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        try:
            conn.request("POST", f"/models/{sign}/lookup_bin", body)
            r = conn.getresponse()
            return r.status, r.read()
        finally:
            conn.close()

    out = {}
    gate = PointGate(["serving.batch.pull"], timeout=30)
    install_schedule(gate)
    try:
        a = threading.Thread(target=lambda: out.setdefault("a", post()))
        a.start()
        assert gate.wait_arrival("serving.batch.pull")
        b = threading.Thread(target=lambda: out.setdefault("b", post()))
        b.start()
        batcher = reg._batcher_for(sign, model)
        deadline = time.time() + 30
        while batcher.stats()["queue_rows"] < 8 and time.time() < deadline:
            time.sleep(0.005)
        rejected0 = scope.HISTOGRAMS.counter("serving_rejected_requests")
        status, _ = post()
        assert status == 429
        assert scope.HISTOGRAMS.counter("serving_rejected_requests") \
            == rejected0 + 1
        gate.open("serving.batch.pull")
        a.join(30)
        b.join(30)
    finally:
        clear_schedule()
        srv.stop()
    want = _host(model.lookup("arr", probe))
    for key in ("a", "b"):
        status, raw = out[key]
        assert status == 200
        nl = raw.index(b"\n")
        np.testing.assert_array_equal(
            np.frombuffer(raw[nl + 1:], np.float32).reshape(8, -1), want)
