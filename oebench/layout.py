"""Finding a cell's pieces by name.

``Bench(root)`` reads ``<root>/BENCHMARK.json`` and looks every other
piece up under ``<root>/oebench``: a configuration by the ``file`` its
``configs`` entry names, a traffic mix as ``traffic/<mix>.json``, the
distribution a mix names as ``distributions/<dist>.py``, a per-layer
metric's reader as ``metrics/<metric>.py`` and a cell's limits as
``limits/<workload>.json``; the reference model a configuration names is
``reference/<model>.py``. A new cell is new files and new entries; no
file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "oebench")
        self.spec = _load_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        known = [w["name"] for w in self.spec["workloads"]]
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{known}")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                cfg = _load_json(os.path.join(self.root, c["file"]))
                return {**cfg, "name": name}
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return {**_load_json(os.path.join(self.dir, "traffic",
                                          name + ".json")), "name": name}

    def distribution(self, name: str):
        """The module of ``distributions/<name>.py``."""
        from .traffic import load_distribution
        return load_distribution(name, os.path.join(self.dir,
                                                    "distributions"))

    def limits(self, workload: str) -> dict:
        return _load_json(os.path.join(self.dir, "limits",
                                       workload + ".json"))

    def _metrics(self, key: str, workload: str) -> List[dict]:
        return [m for m in self.spec[key]
                if workload in m.get("workloads", [workload])]

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics that ``workload`` reports."""
        return self._metrics("end_to_end", workload)

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics that ``workload`` reports."""
        return self._metrics("per_layer", workload)

    def reader(self, metric: str):
        """The module of ``metrics/<metric>.py``; its ``read(ctx)`` returns
        the metric's value, or None where it finds nothing to read."""
        path = os.path.join(self.dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "oebench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def readers(self, workload: str) -> Dict[str, object]:
        return {m["name"]: self.reader(m["name"])
                for m in self.per_layer(workload)}
