"""The readers of the program's own step timings (``oebench/steps.py``),
on planted ``step_timings()`` readings."""

from __future__ import annotations

import types

import pytest

from conftest import REPO

from oebench.layout import Bench

BENCH = Bench(REPO)

STEP_READERS = {"host_step_ms": "step", "host_copy_wait_ms": "copy",
                "host_launch_ms": "launch"}


def _ctx():
    return types.SimpleNamespace(
        config=BENCH.config("deepfm_dim9"), steps=0, window_s=0.0,
        trace=None, pool=None, batches=None, state=None)


def _planted(monkeypatch, timings):
    from openembedding_tpu_torch.utils import observability
    monkeypatch.setattr(observability, "step_timings", lambda: timings)


@pytest.mark.parametrize("metric", sorted(STEP_READERS))
def test_step_readers_read_the_program_timings(metric, monkeypatch):
    """Each host phase reader: nothing recorded, no counted step or a
    program without ``step_timings`` (the parent of the commit that adds
    it) reads None; else milliseconds a counted step."""
    phase = STEP_READERS[metric]
    reader = BENCH.reader(metric)
    ctx = _ctx()
    _planted(monkeypatch, {"host": {}, "device": {}})
    assert reader.read(ctx) is None
    _planted(monkeypatch, {"host": {phase: {"seconds": 0.0, "calls": 0}},
                           "device": {}})
    assert reader.read(ctx) is None
    _planted(monkeypatch, {"host": {phase: {"seconds": 0.03, "calls": 20}},
                           "device": {}})
    assert reader.read(ctx) == pytest.approx(1.5)
    from openembedding_tpu_torch.utils import observability
    monkeypatch.delattr(observability, "step_timings")
    assert reader.read(ctx) is None


def test_step_readers_are_listed_for_every_cell():
    cells = {w["name"] for w in BENCH.spec["workloads"]}
    for metric in STEP_READERS:
        assert all(metric in [m["name"] for m in BENCH.per_layer(w)]
                   for w in cells)
