"""The comparison that decides ``correct``: the reference agrees with the
port at a tiny size on the CPU, and the faults a training cell can have
come out as not correct."""

from __future__ import annotations

import ast
import glob
import math
import os
import time

import pytest
import torch

from conftest import CELLS, REPO

from oebench import check
from oebench.layout import Bench
from oebench.harness import run_cell


def _run(root, cell, plant=None, trace=False):
    return run_cell(Bench(root), cell, 2**31 + 77, 0.2, trace, device="cpu",
                    started=time.time(), clock=time.time, plant=plant)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_port(tiny_root, cell):
    result = _run(tiny_root, cell)
    assert result["correct"] is True
    limits = Bench(tiny_root).limits(cell)
    for name, c in result["checks"].items():
        assert c["limit"] == limits[name]
        assert c["value"] <= c["limit"]


def _unchanged(trainer):
    """The step computes its loss and leaves the state as it was."""
    def step(state, batch):
        rows = trainer.collection.pull(state.emb, batch["sparse"])
        with torch.no_grad():
            logits = trainer._logits(state.params, batch["dense"], rows)
            return trainer.loss_fn(logits, batch["label"])
    trainer._step = step


def _half_batch(trainer):
    """The step leaves out the second half of its batch, the mean taken
    over the rest."""
    whole = trainer._step

    def step(state, batch):
        n = batch["label"].shape[0] // 2
        return whole(state, {"label": batch["label"][:n],
                             "dense": batch["dense"][:n],
                             "sparse": {k: v[:n] for k, v in
                                        batch["sparse"].items()}})
    trainer._step = step


def _altered_row(trainer):
    """The push writes each touched row of the dim-k table off by a
    little more than the update."""
    push = trainer.collection.apply_gradients

    def apply(states, inputs, grads, **kw):
        out = push(states, inputs, grads, **kw)
        with torch.no_grad():
            st = states["fields"]
            st.weights.mul_(1.0 + 1e-3)
        return out
    trainer.collection.apply_gradients = apply


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_row])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_fault_is_not_correct(tiny_root, cell, fault):
    result = _run(tiny_root, cell, plant=fault)
    assert result["correct"] is False
    over = [k for k, c in result["checks"].items()
            if not c["value"] <= c["limit"]]
    assert over


def test_unchanged_state_reads_one():
    ref = {"loss": [0.5, 0.4, 0.3], "grad": {"a": 2.0, "b": 1.0},
           "change": {"a": 3.0, "b": 1.0}, "stray": {"a": 0.0, "b": 0.0}}
    prog = {**ref, "change": {"a": 0.0, "b": 0.0}}
    assert check.gaps(prog, ref)["change_gap"] == 1.0
    assert check.gaps(ref, ref) == {"loss_gap": 0.0, "grad_gap": 0.0,
                                    "change_gap": 0.0}


def test_quiet_leaves_leave_the_change():
    ref = {"loss": [1.0], "grad": {"a": 1.0, "b": 1.0, "c": 1e-9},
           "change": {"a": 1.0, "b": 1.0, "c": 1e-12},
           "stray": {"a": 0.0, "b": 0.0, "c": 0.0}}
    prog = {**ref, "change": {"a": 1.0, "b": 1.0, "c": 5e-12}}
    assert check.gaps(prog, ref)["change_gap"] == 0.0
    prog["stray"] = {"a": 0.5, "b": 0.0, "c": 0.0}
    assert check.gaps(prog, ref)["change_gap"] == 0.5


def test_a_number_that_is_not_finite_fails():
    ok, checks = check.judge({"loss_gap": math.nan, "grad_gap": 0.0,
                              "change_gap": 0.0},
                             {"loss_gap": 1, "grad_gap": 1, "change_gap": 1})
    assert not ok and math.isnan(checks["loss_gap"]["value"])
    ref = {"loss": [1.0, 1.0], "grad": {"a": 1.0}, "change": {"a": 1.0},
           "stray": {"a": 0.0}}
    prog = {**ref, "loss": [1.0, math.nan]}
    assert check.gaps(prog, ref)["loss_gap"] == math.inf


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(REPO, "oebench", "reference", "*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.lstrip(".").split(".")[0]
            assert top in {"", "__future__", "contextlib", "typing",
                           "numpy", "torch", "importlib", "deepfm", "mapping",
                           "model", "optim"}, \
                (path, name)
            assert not name.startswith(".."), (path, name)
