"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark, with
cells small enough for the CPU, laid out as the real one is."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = {"num_features": 4, "embedding_dim": 4, "dnn_units": [8, 4],
        "batch_size": 32}
# a tiny cell of each kind: (configuration, traffic mix, sizes)
CELLS = {
    "tiny.uniform": ("deepfm_dim9", "uniform",
                     {"vocab_sizes": [64, 5, 48, 64]}),
    "tiny_hash.zipf": ("deepfm_dim9_hash", "zipf",
                       {"vocab_sizes": [256, 7, 100, 256],
                        "hash_capacity": 4096}),
}
# The tiny cells' limits. A dense weight's first change is a few 1e-5 of
# a weight near 0.3 here, so the gradient worked out from it is good to a
# few 1e-4 of a small leaf (the real cells read under 1e-6); sound runs
# on the CPU read up to 1.3e-5, the faults 5e-3 and more.
TINY_LIMITS = {"loss_gap": 1e-6, "grad_gap": 1e-4, "change_gap": 1e-5}


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_tiny_root(root: str) -> str:
    """A benchmark under ``root`` whose cells are the real ones cut to a
    CPU's size: the real metric readers, configurations with fewer and
    smaller features, pools of 8 batches, and :data:`TINY_LIMITS`."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for part in ("metrics", "distributions"):
        shutil.copytree(os.path.join(REPO, "oebench", part),
                        os.path.join(root, "oebench", part))
    configs, workloads = [], []
    for name, (config, mix, sizes) in CELLS.items():
        cname = name.split(".")[0]
        with open(os.path.join(REPO, "oebench", "configs",
                               config + ".json")) as f:
            cfg = {**json.load(f), **TINY, **sizes}
        _dump(os.path.join(root, "oebench", "configs", cname + ".json"), cfg)
        with open(os.path.join(REPO, "oebench", "traffic",
                               mix + ".json")) as f:
            _dump(os.path.join(root, "oebench", "traffic", mix + ".json"),
                  {**json.load(f), "pool_batches": 8})
        _dump(os.path.join(root, "oebench", "limits", name + ".json"),
              TINY_LIMITS)
        entry = next(c for c in spec["configs"] if c["name"] == config)
        configs.append({**entry, "name": cname,
                        "file": f"oebench/configs/{cname}.json"})
        workloads.append({"name": name, "config": cname, "traffic": mix,
                          "chips": 1, "why": "a tiny cell for the CPU"})
    spec["configs"], spec["workloads"] = configs, workloads
    for m in spec["per_layer"]:
        m["workloads"] = list(CELLS)
    _dump(os.path.join(root, "BENCHMARK.json"), spec)
    return root


@pytest.fixture
def tiny_root(tmp_path) -> str:
    return make_tiny_root(str(tmp_path))
