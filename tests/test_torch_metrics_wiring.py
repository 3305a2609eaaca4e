"""Torch port, the trainer's and the server's metrics held against the
JAX package's: the same fused DeepFM trains 2 steps and evaluates twice
(the evaluate-performance gate off, then on) in both packages, and both
registries serve the same dump, direct and batched, gate off then on.
The Prometheus pages then name the same metrics, apart from the port's
four ``oe_step_*`` families of its train step's own timings and its hash
find-or-insert kernels' ``oe_hash_find_keys_total``, and every
counter (and every histogram's sample count) of JAX's holds the same
value on the port's; the registries report the same ``serving`` memory
gauges.
"""

import re

import numpy as np
import pytest

import jax

from openembedding_tpu import checkpoint as jck
from openembedding_tpu.analysis import scope as jscope
from openembedding_tpu.parallel.mesh import create_mesh
from openembedding_tpu.serving.registry import ModelRegistry as JaxRegistry
from openembedding_tpu.utils import observability as jobs
from openembedding_tpu_torch.analysis import scope as tscope
from openembedding_tpu_torch.serving.registry import ModelRegistry
from openembedding_tpu_torch.utils import observability as tobs

from test_torch_training import _pair

PACKAGES = ((jscope, jobs), (tscope, tobs))


def _reset():
    for scope, obs in PACKAGES:
        obs.set_evaluate_performance(False)
        obs.GLOBAL.reset()
        scope.HISTOGRAMS.reset()
        scope.reset()
        obs._BATCH_GAUGE_LAST.clear()
        with obs._LABELED_GAUGE_LOCK:
            obs._LABELED_GAUGES.clear()
        with obs._GAUGE_LOCK:
            obs._GAUGES.clear()


@pytest.fixture()
def fresh():
    _reset()
    yield
    _reset()


# the exchange planes' gated timers (``observability.plane_timed``: the
# ``pull`` span and the ``pull/<plane>`` timer of JAX's sharded pull)
# come with the planes, a later slice (ROADMAP Queue 1 item 9)
PLANE_TIMERS = re.compile(r"^oe_(span_pull_seconds|pull_a2a\S*)")


# the port's train-step timings and hash find-or-insert key counters,
# which the JAX package has not
PORT_FAMILIES = ("oe_step_host_seconds_total", "oe_step_host_calls_total",
                 "oe_step_device_seconds_total",
                 "oe_step_device_replays_total",
                 "oe_hash_find_keys_total")


def _families(text):
    return {m.group(1) for m in re.finditer(r"^# TYPE (\S+) ", text, re.M)
            if not PLANE_TIMERS.match(m.group(1))}


def _values(text):
    """Every counter and gauge sample, and each histogram's ``_count``,
    by series; span timings (``_sum``, buckets) are wall times and
    differ."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{", 1)[0]
        if PLANE_TIMERS.match(name):
            continue
        if name.endswith(("_bucket", "_sum")) \
                or name.endswith("_seconds_total"):
            continue
        if name.startswith("oe_span_") and not name.endswith("_count"):
            continue
        out[series] = float(value)
    return out


def test_metrics_match_jax(devices8, tmp_path, fresh):
    jtrainer, jstate, trainer, state, batches = _pair(devices8, "deepfm",
                                                      True)
    path = str(tmp_path / "ck")
    jck.save_checkpoint(path, jtrainer.collection, jstate.emb,
                        model_sign="wire-1")
    mesh = create_mesh(1, 1, devices8[:1])
    jreg, treg = JaxRegistry(mesh), ModelRegistry(device="cpu")
    for reg in (jreg, treg):
        reg.create_model(path, block=True)
        reg.enable_batching(max_batch_rows=256, max_wait_us=0)
    ids = np.asarray(batches[0]["sparse"]["fields"])[:3].reshape(-1)
    _reset()
    for gate in (False, True):
        for _scope, obs in PACKAGES:
            obs.set_evaluate_performance(gate)
        b = batches[int(gate)]
        jstate, _ = jtrainer.train_step(jstate, b)
        state, _ = trainer.train_step(state, b)
        jax.block_until_ready(jtrainer.eval_step(jstate, b))
        trainer.eval_step(state, b)
        for reg, model in ((jreg, jreg.find_model("wire-1")),
                           (treg, treg.find_model("wire-1"))):
            model.lookup("fields", ids)                 # direct
            reg.lookup("wire-1", "fields:linear", ids)  # batched
    jtext = jobs.prometheus_text(include_mem=False)
    ttext = tobs.prometheus_text(include_mem=False)
    f1 = {"oe_pull_indices_total", "oe_pull_unique_total", "oe_pull_rows",
          "oe_pull_unique_ratio", "oe_pull_key_skew",
          "oe_pull_unique_ratio_last", "oe_pull_key_skew_last",
          "oe_span_eval_seconds", "oe_span_step_seconds",
          "oe_serving_lookup_ids_total", "oe_serving_lookup_requests_total",
          "oe_serving_lookup_rows", "oe_span_serving_lookup_seconds",
          "oe_batch_flushes_total", "oe_serving_batch_rows"}
    assert f1 <= _families(jtext)
    # the port's page holds JAX's families, with the same values, and the
    # train step's own timings (``observability.step_timings``) and the
    # hash kernels' key counters besides
    assert _families(ttext) - _families(jtext) == set(PORT_FAMILIES)
    assert _families(jtext) <= _families(ttext)
    tvalues = {k: v for k, v in _values(ttext).items()
               if not k.startswith(PORT_FAMILIES)}
    assert tvalues == _values(jtext)
    assert tscope.HISTOGRAMS.count("span_eval_seconds") == 1
    assert tobs.GLOBAL.snapshot()["serving_lookup_requests"]["count"] == 4
    # the registries as memory sources
    jmem = {k: v for k, v in jobs.memory_stats().items()
            if k.startswith("serving/")}
    tmem = {k: v for k, v in tobs.memory_stats().items()
            if k.startswith("serving/")}
    jown = [v for v in jmem.values() if v["loaded_models"] == 1.0]
    town = [v for v in tmem.values() if v["loaded_models"] == 1.0]
    assert town and town[-1] == jown[-1]
    for reg in (jreg, treg):
        reg.close()


def test_gate_off_step_records_gauges_only(devices8, fresh):
    """With the gate off a step feeds only the throttled ``_last`` gauges,
    one scan a table a second, as JAX's: a second step within the second
    records nothing, and no counter moves."""
    _j, _js, trainer, state, batches = _pair(devices8, "deepfm", True)
    _reset()
    state, _ = trainer.train_step(state, batches[0])
    gauges = tobs.labeled_gauges()
    assert set(gauges) == {"pull_unique_ratio_last", "pull_key_skew_last"}
    first = dict(gauges["pull_unique_ratio_last"])
    state, _ = trainer.train_step(state, batches[1])
    assert tobs.labeled_gauges()["pull_unique_ratio_last"] == first
    assert "pull_indices" not in tobs.GLOBAL.snapshot()
    fields = np.asarray(batches[0]["sparse"]["fields"]).ravel()
    assert first[(("table", "fields"),)] == \
        np.unique(fields).size / fields.size
