"""The harness finds every piece by the name ``BENCHMARK.json`` gives it,
and a new cell is new files and new entries, with no file edited."""

from __future__ import annotations

import json
import os
import time

import pytest

from conftest import REPO

from oebench.harness import draw_inputs, run_cell
from oebench.layout import Bench


def test_finds_config_mix_limits_and_metrics_by_name():
    bench = Bench(REPO)
    for cell in bench.spec["workloads"]:
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"]
        assert bench.traffic(cell["traffic"])["pool_batches"] > 3
        assert set(bench.limits(cell["name"])) >= {"loss_gap", "grad_gap",
                                                   "change_gap"}
        readers = bench.readers(cell["name"])
        assert set(readers) == {m["name"] for m in bench.per_layer(
            cell["name"])}
        assert all(callable(r.read) for r in readers.values())
    entry = next(c for c in bench.spec["configs"]
                 if c["name"] == "deepfm_dim9")
    assert os.path.exists(os.path.join(REPO, entry["file"]))
    for cell in bench.spec["workloads"]:
        mix = bench.traffic(cell["traffic"])
        for part in ("ids", "dense"):
            assert callable(bench.distribution(mix[part]["dist"]).draw)


def test_the_reference_model_is_found_by_name():
    from oebench.reference import model
    config = Bench(REPO).config("deepfm_dim9")
    net = model(config)
    assert net.__name__ == "oebench.reference.deepfm"
    assert set(net.tables(config)) == {"fields", "fields:linear"}
    with pytest.raises(ModuleNotFoundError):
        model({**config, "model": "no_such_model"})


def test_every_metric_names_a_layer_and_an_end_to_end_metric():
    bench = Bench(REPO)
    e2e = {m["name"] for m in bench.spec["end_to_end"]}
    cells = {w["name"] for w in bench.spec["workloads"]}
    assert "setup_s" in e2e
    for m in bench.spec["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= cells


def _snapshot(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_new_cell_from_new_files_alone(tiny_root):
    """A configuration, a traffic mix, a metric and a cell, added as new
    files and appended entries, run without any file of the harness or of
    the cells already there changing."""
    before = _snapshot(os.path.join(REPO, "oebench"))
    root = tiny_root
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    with open(os.path.join(root, "oebench", "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["embedding_dim"] = 6
    with open(os.path.join(root, "oebench", "configs", "wide6.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "oebench", "traffic", "skewed.json"),
              "w") as f:
        json.dump({"pool_batches": 6, "ids": {"dist": "lowest", "n": 3},
                   "dense": {"dist": "normal"}, "positive_share": 0.5}, f)
    # a new id distribution: a file of its own, found by the name the mix
    # gives it
    with open(os.path.join(root, "oebench", "distributions", "lowest.py"),
              "w") as f:
        f.write("import torch\n\n\ndef draw(params, shape, g, device, "
                "sizes):\n    r = torch.randint(0, int(params['n']), shape,"
                " generator=g, device=device)\n"
                "    return torch.minimum(r, sizes - 1)\n")
    with open(os.path.join(root, "oebench", "metrics", "steps_seen.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    with open(os.path.join(root, "oebench", "limits",
                           "tiny.uniform.json")) as f:
        limits = json.load(f)
    with open(os.path.join(root, "oebench", "limits",
                           "wide6.skewed.json"), "w") as f:
        json.dump(limits, f)
    spec["configs"].append({**spec["configs"][0], "name": "wide6",
                            "file": "oebench/configs/wide6.json"})
    spec["workloads"].append({"name": "wide6.skewed", "config": "wide6",
                              "traffic": "skewed", "chips": 1,
                              "why": "a cell added by files alone"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "examples_per_s",
                              "workloads": ["wide6.skewed"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    bench = Bench(root)
    result = run_cell(bench, "wide6.skewed", 5, 0.2, True, device="cpu",
                      started=time.time(), clock=time.time)
    assert result["correct"] is True
    assert result["metrics"]["steps_seen"]["value"] >= 1
    # the new distribution drew the cell's ids
    pool, _ = draw_inputs(bench.config("wide6"), bench.traffic("skewed"), 5,
                          "cpu", bench.distribution)
    assert pool.ids.max() <= 2
    assert _snapshot(os.path.join(REPO, "oebench")) == before
