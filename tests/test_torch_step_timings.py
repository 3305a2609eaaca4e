"""Torch port, the train step's own timings (``utils/observability.py``
``stage``, ``StageRecorder``, ``StepClock``, ``step_timings``) on the CPU.

With the evaluate-performance gate on, a step program is armed: its stage
marks (``pull``, ``dense``, ``push``, and the tables' ``push.dedup``,
``push.find``, ``push.update``) read the host's clock, each stage's
segments sum to the bracket from the first mark to the last, and the
build's warm-up is not counted. The arming is part of the program's key:
turning the gate on builds one program, turning it off replays the first.
``train_step``'s host phases are counted on every step that neither built
a program nor ran under a profiler session; under one, the program stays
unarmed (a trace shows the program users run) and each phase is a
``step.<phase>`` annotation. The four ``oe_step_*``
families render on ``/metrics``; the batch-shape scan converts a column
only when its throttle lets it through.
"""

import re

import numpy as np
import pytest
import torch

from openembedding_tpu_torch import training as tr
from openembedding_tpu_torch.analysis import scope
from openembedding_tpu_torch.data import criteo
from openembedding_tpu_torch.embedding import EmbeddingCollection
from openembedding_tpu_torch.fused import make_fused_specs
from openembedding_tpu_torch.models import deepctr as tm
from openembedding_tpu_torch.optim import dense
from openembedding_tpu_torch.optim import initializers as ti
from openembedding_tpu_torch.utils import observability as obs

DIM, BATCH, VOCAB = 4, 32, 64
STEPS = 4
ARRAY_STAGES = {"pull", "dense", "push", "push.dedup", "push.update"}
FAMILIES = ("oe_step_host_seconds_total", "oe_step_host_calls_total",
            "oe_step_device_seconds_total", "oe_step_device_replays_total")


@pytest.fixture(autouse=True)
def fresh():
    obs.set_evaluate_performance(False)
    obs.reset_step_timings()
    yield
    obs.set_evaluate_performance(False)
    obs.reset_step_timings()


def _trainer(kind):
    extra = {"hash_capacity": 1024} if kind == "hash" else {}
    specs, mapper = make_fused_specs(
        criteo.SPARSE_NAMES, -1 if kind == "hash" else VOCAB, DIM,
        optimizer={"category": "adagrad", "learning_rate": 0.01}, **extra)
    module = tm.build_model("deepfm", criteo.SPARSE_NAMES, embedding_dim=DIM,
                            num_dense=criteo.NUM_DENSE, dnn_units=(16, 8))
    trainer = tr.Trainer(module, EmbeddingCollection(specs, device="cpu"),
                         dense.adagrad(0.01))
    batches = [mapper.fuse_batch(b) for b in criteo.synthetic_criteo(
        BATCH, num_buckets=VOCAB, seed=3, num_batches=STEPS)]
    return trainer, trainer.init(ti.prng_key(0), batches[0]), batches


def _steps(trainer, state, batches):
    for b in batches:
        state, _ = trainer.train_step(state, b)
    return state


@pytest.mark.parametrize("kind", ["array", "hash"])
def test_gate_on_records_every_stage(kind):
    trainer, state, batches = _trainer(kind)
    obs.set_evaluate_performance(True)
    _steps(trainer, state, batches)
    device = obs.step_timings()["device"]
    want = ARRAY_STAGES | ({"push.find"} if kind == "hash" else set())
    assert set(device) == want
    for name, entry in device.items():
        # the build's warm-up is not counted
        assert entry["replays"] == STEPS - 1, name
        assert entry["seconds"] >= 0.0, name
    parts = sum(device[k]["seconds"] for k in want if k.startswith("push."))
    assert parts <= device["push"]["seconds"] + 1e-12


@pytest.mark.parametrize("kind", ["array", "hash"])
def test_stages_sum_to_the_bracket(kind):
    trainer, state, batches = _trainer(kind)
    placed = trainer.place_batch(trainer.host_batch(batches[0]))
    rec = obs.StageRecorder(cuda=False)
    with rec.recording():
        trainer._step(state, placed)
    seconds = rec.seconds()
    names = [n for n, _ in rec.marks]
    assert names[0] == "pull" and names[-1] == "end"
    assert ("push.find" in names) == (kind == "hash")
    bracket = rec.marks[-1][1] - rec.marks[0][1]
    assert all(v >= 0.0 for v in seconds.values())
    total = seconds["pull"] + seconds["dense"] + seconds["push"]
    assert total == pytest.approx(bracket, rel=1e-9, abs=1e-12)
    # outside a recording a mark does nothing
    obs.stage("pull")
    assert len(rec.marks) == len(names)


def test_gate_off_counts_host_phases_only():
    trainer, state, batches = _trainer("array")
    _steps(trainer, state, batches)
    got = obs.step_timings()
    assert got["device"] == {}
    assert set(got["host"]) == set(obs.HOST_PHASES) | {"step"}
    # the first step built the program: not counted
    assert {v["calls"] for v in got["host"].values()} == {STEPS - 1}
    assert all(v["seconds"] > 0.0 for v in got["host"].values())
    phases = sum(got["host"][p]["seconds"] for p in obs.HOST_PHASES)
    assert phases == pytest.approx(got["host"]["step"]["seconds"], rel=1e-9)
    # every step, built or not, feeds the step span's histogram
    assert scope.HISTOGRAMS.count("span_step_seconds") >= STEPS


def test_arming_builds_one_program_and_disarming_replays_the_first():
    trainer, state, batches = _trainer("array")
    state = _steps(trainer, state, batches[:2])
    assert trainer.builds == 1
    plain = list(trainer.programs.values())
    obs.set_evaluate_performance(True)
    state = _steps(trainer, state, batches)
    assert trainer.builds == 2
    obs.set_evaluate_performance(False)
    state = _steps(trainer, state, batches)
    assert trainer.builds == 2
    assert [p for p in trainer.programs.values() if not p.armed] == plain
    # the disarmed steps added no replay
    assert obs.step_timings()["device"]["pull"]["replays"] == STEPS - 1


def test_profiler_session_leaves_the_program_unarmed_and_uncounted():
    trainer, state, batches = _trainer("array")
    state = _steps(trainer, state, batches[:2])
    before = obs.step_timings()["host"]["step"]["calls"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = _steps(trainer, state, batches)
    assert trainer.builds == 1
    assert [p.armed for p in trainer.programs.values()] == [False]
    assert obs.step_timings()["host"]["step"]["calls"] == before
    assert obs.step_timings()["device"] == {}
    names = {e.key for e in prof.key_averages()}
    assert {"step." + p for p in obs.HOST_PHASES} <= names
    assert any(re.fullmatch(r"step \d+", n) for n in names)


def test_step_error_is_recorded_and_not_counted():
    trainer, state, batches = _trainer("array")
    state = _steps(trainer, state, batches[:2])
    errors = scope.HISTOGRAMS.counter("span_errors", kind="step")
    calls = obs.step_timings()["host"]["step"]["calls"]
    bad = {**batches[0], "sparse": {"nope": batches[0]["sparse"]["fields"]}}
    with pytest.raises(KeyError):
        trainer.train_step(state, bad)
    assert scope.HISTOGRAMS.counter("span_errors", kind="step") == errors + 1
    assert obs.step_timings()["host"]["step"]["calls"] == calls


def test_metrics_page_has_the_four_families():
    trainer, state, batches = _trainer("hash")
    obs.set_evaluate_performance(True)
    _steps(trainer, state, batches)
    text = obs.prometheus_text(include_mem=False)
    for family in FAMILIES:
        assert f"# HELP {family} " in text
        assert f"# TYPE {family} counter" in text
    series = {}
    for line in text.splitlines():
        if line.startswith("oe_step_"):
            m = re.fullmatch(r'(oe_step_\w+)\{(phase|stage)="([\w.]+)"\} '
                             r'(\S+)', line)
            assert m, line
            series[(m.group(1), m.group(3))] = float(m.group(4))
    assert series[("oe_step_host_calls_total", "launch")] == STEPS - 1
    assert series[("oe_step_device_replays_total", "push.find")] == STEPS - 1
    assert series[("oe_step_device_seconds_total", "dense")] > 0.0
    # a caller's own accumulator is rendered without the process's steps
    assert "oe_step_" not in obs.prometheus_text(obs.Accumulator(),
                                                 include_mem=False)


def test_reporter_prints_the_step_timings():
    trainer, state, batches = _trainer("array")
    obs.set_evaluate_performance(True)
    _steps(trainer, state, batches)
    lines = []
    obs.Reporter(0, sink=lines.append).report()
    assert re.search(r"step_host\[stats_ms=\S+, .*, step_ms=\S+, calls=3\]",
                     lines[0])
    assert re.search(r"step_device\[dense_ms=\S+, pull_ms=\S+, push_ms=",
                     lines[0])


def test_batch_stats_convert_only_scanned_columns(monkeypatch):
    monkeypatch.setattr(obs, "_BATCH_GAUGE_LAST", {})
    seen = []

    def view(col):
        seen.append(col)
        return np.asarray(col)
    cols = {"a": np.arange(8), "b": np.zeros(8, np.int64)}
    obs.record_batch_stats(cols, view=view)
    assert len(seen) == 2
    # within the throttle's second: no scan, so no conversion
    obs.record_batch_stats(cols, view=view)
    assert len(seen) == 2
    obs.set_evaluate_performance(True)
    obs.record_batch_stats(cols, view=view)
    assert len(seen) == 4
