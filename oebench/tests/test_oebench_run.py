"""The command's last line and its refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import CELLS, REPO

from oebench import run
from oebench.harness import run_cell
from oebench.layout import Bench

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_last_line_has_the_contract_shape(tiny_root, cell, trace, capsys):
    bench = Bench(tiny_root)
    result = run_cell(bench, cell, 3 * 2**31 + 5, 0.2, bool(trace),
                      device="cpu", started=time.time(), clock=time.time)
    run.report(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = [m["name"] for m in (bench.per_layer(cell) if trace
                                 else bench.end_to_end(cell))]
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = err.strip().splitlines()
    assert tail[-1].startswith("correct ")
    assert [t.split()[1] for t in tail[-4:-1]] == list(line["checks"])


def test_the_same_seed_gives_the_same_inputs(tiny_root):
    from oebench.harness import draw_inputs
    bench = Bench(tiny_root)
    for cell in CELLS:
        w = bench.workload(cell)
        config, mix = bench.config(w["config"]), bench.traffic(w["traffic"])
        seed = 2**33 + 1
        a, ia = draw_inputs(config, mix, seed, "cpu")
        b, ib = draw_inputs(config, mix, seed, "cpu")
        c, _ = draw_inputs(config, mix, seed + 1, "cpu")
        assert (a.ids == b.ids).all() and (a.dense == b.dense).all()
        assert not (a.ids == c.ids).all()
        assert a.ids.shape == c.ids.shape
        assert all(torch.equal(ia.dense()[k], v)
                   for k, v in ib.dense().items())


def test_forbidden_modules_compare_whole_top_level_names():
    f = run.forbidden_modules
    assert f(["openembedding_tpu_torch", "openembedding_tpu_torch.ops",
              "jaxtyping", "numpy"]) == []
    assert f(["openembedding_tpu.table"]) == ["openembedding_tpu"]
    assert f(["jax._src.api", "jaxlib", "flax.linen",
              "optax"]) == ["flax", "jax", "jaxlib", "optax"]


def test_a_run_loads_no_jax(tiny_root):
    """A run of a tiny cell, in a process of its own, leaves no module of
    JAX or of the JAX package loaded."""
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from oebench.harness import run_cell\n"
            "from oebench.layout import Bench\n"
            "from oebench.run import forbidden_modules\n"
            "run_cell(Bench(%r), 'tiny.uniform', 1, 0.1, True, device='cpu',"
            " started=time.time(), clock=time.time)\n"
            "print(forbidden_modules())\n" % (REPO, tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_without_a_card_and_prints_no_result(tmp_path):
    """Without a CUDA device (as here), or with the program missing, the
    command exits with another code than 0 and prints no result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    args = ["--workload", "deepfm_dim9.uniform", "--seed", "1",
            "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable, "-m", "oebench.run", *args],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    shutil.copytree(os.path.join(REPO, "oebench"), bare / "oebench")
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), bare)
    out = subprocess.run([sys.executable, "-m", "oebench.run", *args],
                         cwd=bare, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
