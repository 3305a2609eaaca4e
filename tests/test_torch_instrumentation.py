"""Torch port, the host instrumentation runtime against the JAX package:
``analysis/concurrency.py`` (traced locks, schedules), ``analysis/
scope.py`` (histograms, spans, the Chrome-trace export),
``analysis/chaos.py`` (fault plans, sync-point discovery) and
``utils/observability.py`` (the Prometheus page, ``StreamingAUC``).

The same series are recorded into both packages' registries, each
swapped for a fresh one, so the comparison sees nothing else this process
recorded. Prometheus text is compared byte for byte, AUCs exactly, traces
apart from pid and tid, lock counters by count (their times differ).
"""

import os
import shutil
import threading

import numpy as np
import pytest

from openembedding_tpu.analysis import chaos as jchaos
from openembedding_tpu.analysis import concurrency as jconc
from openembedding_tpu.analysis import scope as jscope
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch.analysis import chaos as tchaos
from openembedding_tpu_torch.analysis import concurrency as tconc
from openembedding_tpu_torch.analysis import scope as tscope
from openembedding_tpu_torch.utils import observability as tobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [(jscope, jobs, jconc, jchaos), (tscope, tobs, tconc, tchaos)]


@pytest.fixture()
def fresh(monkeypatch):
    """Fresh histogram registries, gauges and lock counters in both
    packages."""
    for scope, obs, conc, _ in PAIRS:
        monkeypatch.setattr(scope, "HISTOGRAMS", scope.HistogramRegistry())
        monkeypatch.setattr(obs, "_GAUGES", {})
        monkeypatch.setattr(obs, "_LABELED_GAUGES", {})
        conc.reset_runtime()
    yield
    for _, _, conc, _ in PAIRS:
        conc.reset_runtime()


def _record(scope, obs, acc):
    """One fixed set of series: counters, timers, gauges, labeled
    gauges, histograms with labels, spans (with an error), the
    checkpoint and swap ledgers."""
    acc.add("pull_indices", 4096)
    acc.add("pull_unique", 1234.5)
    acc.add_time("step", 0.00125)
    acc.add_time("step", 0.5)
    obs.set_gauge("ckpt_chain_len", 3)
    obs.set_labeled_gauge("pull_key_skew_last", 0.125, table="fields")
    obs.set_labeled_gauge("pull_key_skew_last", 0.5, table='we"ird\\')
    obs.record_ckpt_save("full", 2_180_000_000, 2.5, chain_len=0,
                         accumulator=acc)
    obs.record_ckpt_save("delta", 15_000_000, 0.04, chain_len=1,
                         accumulator=acc)
    obs.record_swap(3004, 1, accumulator=acc)
    obs.record_ingest_stall(0.0, accumulator=acc, source="fit")
    scope.HISTOGRAMS.inc("plan_adjust", 2.0, knob="rows", direction="up")
    for v in (1e-6, 3.3e-4, 3.3e-4, 0.02, 7.0, 1e13):
        scope.HISTOGRAMS.observe("serving_lookup_rows", v, table="fields")
    scope.record_span("checkpoint.save", 10.0, 0.25, {"mode": "delta"})
    scope.record_span("http", 11.0, 0.001, {"route": "/models"},
                      error="KeyError")


def test_prometheus_text_byte_equal(fresh):
    texts = []
    for scope, obs, _, _ in PAIRS:
        acc = obs.Accumulator()
        _record(scope, obs, acc)
        texts.append(obs.prometheus_text(acc, include_mem=False))
    assert texts[0] == texts[1]
    assert "oe_ckpt_write_gbps" in texts[1]
    assert "# TYPE oe_span_checkpoint_save_seconds histogram" in texts[1]
    # quantiles and counter reads agree too
    for name, q in (("serving_lookup_rows", 0.5),
                    ("serving_lookup_rows", 0.99)):
        assert jscope.HISTOGRAMS.quantile(name, q, table="fields") == \
            tscope.HISTOGRAMS.quantile(name, q, table="fields")
    assert tscope.HISTOGRAMS.counter("plan_adjust") == 2.0


def test_vtimer_and_memory_ledger(fresh):
    for scope, obs, _, _ in PAIRS:
        acc = obs.Accumulator()
        with obs.vtimer("save", acc):
            pass
        snap = acc.snapshot()
        assert snap["save"]["calls"] == 1 and snap["save"]["seconds"] >= 0
        assert set(obs.memory_stats()["scope/rings"]) == {
            "events", "dropped", "approx_bytes"}


def test_streaming_auc_equal():
    rng = np.random.RandomState(0)
    labels = (rng.rand(5000) < 0.3).astype(np.float32)
    scores = np.clip(labels * 0.3 + rng.rand(5000) * 0.7, 0, 1)
    results = []
    for bins in (64, 8192):
        j, t = jobs.StreamingAUC(bins), tobs.StreamingAUC(bins)
        for lo in range(0, 5000, 1000):
            j.update(labels[lo:lo + 1000], scores[lo:lo + 1000])
            t.update(labels[lo:lo + 1000], scores[lo:lo + 1000])
        assert j.result() == t.result()
        results.append(t.result())
    assert 0.5 < results[1] <= 1.0
    assert tobs.StreamingAUC().result() == jobs.StreamingAUC().result()


def test_reporter_ticks_and_prints():
    lines = []
    acc = tobs.Accumulator()
    acc.add("rows", 3)
    rep = tobs.Reporter(0.01, acc, sink=lines.append).start()
    try:
        gate = tconc.PointGate(["reporter.tick"])
        tconc.install_schedule(gate)
        assert gate.wait_arrival("reporter.tick", 10)
        gate.open("reporter.tick")
    finally:
        tconc.clear_schedule()
        rep.stop()
    assert rep.ticks >= 1 and lines[0] == "metrics: rows[count=3]"


def _export(scope, monkeypatch):
    monkeypatch.setattr(scope, "_EPOCH", 100.0)
    scope.set_tracing(True)
    scope.reset()
    try:
        with scope.trace_context("feedbeefcafe0001"):
            scope.record_span("registry.apply_delta", 101.0, 0.5,
                              {"table": "fields"},
                              detail={"sign": "m", "seq": 2})
        scope.record_span("step", 102.5, 0.001, None, detail={"step": 7})
        scope.record_span("http", 103.0, 0.25, {"route": "/x"},
                          error="ValueError", trace_time=True)
        return scope.export_chrome_trace(process_name="proc")
    finally:
        scope.set_tracing(None)
        scope.reset()


def test_chrome_trace_equal(monkeypatch):
    def strip(trace):
        evs = [{k: v for k, v in e.items() if k not in ("pid", "tid")}
               for e in trace["traceEvents"]
               if e["ph"] == "X" or e["name"] == "process_name"]
        return {**trace, "traceEvents": evs}
    jt = strip(_export(jscope, monkeypatch))
    tt = strip(_export(tscope, monkeypatch))
    assert jt == tt
    assert [e["name"] for e in tt["traceEvents"]][1:] == [
        "registry.apply_delta", "step", "http"]
    merged = tscope.merge_chrome_traces(tt, [{**tt, "oeEpoch": 101.0}])
    assert merged == jscope.merge_chrome_traces(jt, [{**jt,
                                                      "oeEpoch": 101.0}])


PLANS = [
    '{"seed": 3, "faults": [{"point": "ckpt.delta.commit", '
    '"action": "kill_thread", "hit": 2}, {"point": "registry.find", '
    '"action": "delay_ms", "ms": 5, "thread": "oe-*"}]}',
    '{"faults": [{"point": "x.y", "action": "explode"}]}',
    '{"faults": [{"point": "x.y", "action": "raise", "hit": 0}]}',
    '{"faults": [{"point": "x.y", "action": "raise", "bogus": 1}]}',
    '{"seed": 1, "extra": []}',
    '[1, 2]',
]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parsing_equal(text, tmp_path):
    outs = []
    for chaos in (jchaos, tchaos):
        try:
            outs.append(("ok", chaos.plan_from_text(text).to_json()))
        except ValueError as e:
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]
    if outs[1][0] == "ok":
        ref = tmp_path / "plan.json"
        ref.write_text(text)
        assert tchaos.plan_from_text(f"@{ref}").to_json() == outs[1][1]
        assert tchaos.install_from_env({"OE_CHAOS_PLAN": text}) is not None
        tchaos.clear_plan()
    assert tchaos.install_from_env({}) is None


def _serial_run(conc):
    """Two threads each passing points a, b; the schedule orders them
    t2/a, t1/a, t1/b, t2/b. Returns the order the work happened in."""
    order, lock = [], threading.Lock()

    def work(name):
        for p in ("a", "b"):
            conc.sync_point(f"sched.{p}")
            with lock:
                order.append(f"{name}/{p}")
    sched = conc.SerialSchedule(["t2/sched.a", "t1/sched.a", "t1/sched.b",
                                 "t2/sched.b"])
    conc.install_schedule(sched)
    try:
        ts = [threading.Thread(target=work, args=(n,), name=n)
              for n in ("t1", "t2")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(20)
    finally:
        conc.clear_schedule()
    return order, sched.done()


def test_serial_schedule_and_gate_equal():
    assert _serial_run(jconc) == _serial_run(tconc) == (
        ["t2/a", "t1/a", "t1/b", "t2/b"], True)
    for conc in (jconc, tconc):
        gate = conc.PointGate(["w/gate.p"])
        conc.install_schedule(gate)
        got = []
        try:
            t = threading.Thread(target=lambda: (conc.sync_point("gate.p"),
                                                 got.append(1)), name="w")
            t.start()
            assert gate.wait_arrival("w/gate.p")
            conc.sync_point("gate.p")      # another thread passes
            assert got == []
            gate.open("w/gate.p")
            t.join(20)
        finally:
            conc.clear_schedule()
        assert got == [1]


def _lock_run(conc):
    conc.set_trace_locks(True)
    try:
        a, b = conc.make_lock("t.a"), conc.make_lock("t.b")
        r = conc.make_rlock("t.r")
    finally:
        conc.set_trace_locks(None)
    with a:
        with b:
            pass
    t = threading.Thread(target=lambda: (b.acquire(), a.acquire(),
                                         a.release(), b.release()))
    t.start()
    t.join(20)
    with r:
        with r:
            assert r.locked()
    assert not r.locked()
    stats = {k: {f: v[f] for f in ("acquires", "contended")}
             for k, v in conc.lock_stats().items()}
    return conc.potential_deadlocks(), stats


def test_traced_locks_equal():
    for conc in (jconc, tconc):
        conc.reset_runtime()
    try:
        jout, tout = _lock_run(jconc), _lock_run(tconc)
    finally:
        # the lock counters are process-wide: leave none behind for the
        # next test file of this worker
        for conc in (jconc, tconc):
            conc.reset_runtime()
    assert jout == tout
    assert len(tout[0]) == 1 and "potential deadlock" in tout[0][0]
    assert tout[1]["t.r"]["acquires"] == 1
    assert isinstance(tconc.make_lock("plain"), type(threading.Lock()))


# the JAX modules whose port this slice is, and the names JAX has there
# that belong to a later slice
SLICE = ["analysis/concurrency.py", "analysis/scope.py", "analysis/chaos.py",
         "utils/observability.py", "utils/compress.py", "utils/fs.py",
         "dirty.py", "embedding.py", "checkpoint.py", "checkpoint_delta.py",
         "training.py", "serving/registry.py", "serving/rest.py",
         "serving/batcher.py", "serving/ha.py", "data/stream.py",
         "offload.py"]
LATER = set()


def test_sync_points_match_jax(tmp_path):
    roots = {}
    for pkg in ("openembedding_tpu", "openembedding_tpu_torch"):
        root = tmp_path / pkg
        for rel in SLICE:
            dst = root / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(os.path.join(REPO, pkg, rel), dst)
        roots[pkg] = str(root)
    jax_names = set(jchaos.discover_sync_points(roots["openembedding_tpu"]))
    port_names = set(tchaos.discover_sync_points(
        roots["openembedding_tpu_torch"]))
    assert port_names == jax_names - LATER
    assert "ckpt.delta.commit" in port_names
    # the whole port names no point the JAX package lacks
    whole = set(tchaos.discover_sync_points())
    assert whole <= set(jchaos.discover_sync_points())
    assert whole == port_names
    assert {tchaos.subsystem_of(p) for p in whole} == {
        "ckpt", "serving", "report", "ingest", "offload"}
