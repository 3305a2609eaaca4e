"""The one general generator of host batches.

A traffic mix is a data file (``traffic/<mix>.json``) of parameters::

    {"pool_batches": 256,
     "ids": {"dist": "zipf", "a": 1.2},
     "dense": {"dist": "log1p_poisson", "lam": 3.0},
     "positive_share": 0.25}

and a configuration gives the sizes: ``batch_size``, ``num_features``,
``num_dense`` and ``vocab_sizes`` (the ids each feature can take). Each
``dist`` names a module of its own, ``distributions/<dist>.py``, whose
``draw(params, shape, g, device, sizes)`` draws a tensor of ``shape``
(per-feature ids within ``sizes`` for ``ids``; float32 values for
``dense``); the other keys of the entry are its parameters.
:func:`make_pool` draws ``pool_batches`` batches of ids, dense features
and labels from the seed, on the device in a few large calls, and hands
them over as numpy arrays, the form in which data readers hand a trainer
its batches. Every seed gives the same sizes; only the values move.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import os
from typing import Callable

import numpy as np
import torch

from .reference.mapping import vocab_sizes

DISTRIBUTIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "distributions")


def seed_of(seed: int, *tags) -> int:
    """A 63-bit generator seed for ``(seed, tags)``: any whole number, of
    any size, and any tags."""
    raw = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(raw[:8], "little") >> 1


def load_distribution(name: str, where: str = DISTRIBUTIONS):
    """The module of ``<where>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "oebench_dist_" + name.replace(".", "_").replace("-", "_"),
        os.path.join(where, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class RawPool:
    """``ids [P, B, F]`` int64 per-feature ids, ``dense [P, B, D]``
    float32, ``label [P, B]`` float32 (0 or 1)."""

    ids: np.ndarray
    dense: np.ndarray
    label: np.ndarray

    def __len__(self) -> int:
        return self.ids.shape[0]

    def batch(self, p: int, names) -> dict:
        """Batch ``p`` as a trainer takes it: ``{"label", "dense",
        "sparse": {name: [B] ids}}``."""
        return {"label": self.label[p], "dense": self.dense[p],
                "sparse": {n: self.ids[p, :, j] for j, n in enumerate(names)}}


def make_pool(mix: dict, config: dict, seed: int, device,
              find: Callable = load_distribution) -> RawPool:
    """The mix's batches for ``config``, drawn from ``seed`` on
    ``device``; ``find(name)`` gives a distribution's module."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed_of(seed, "traffic"))
    p, b = int(mix["pool_batches"]), int(config["batch_size"])
    f, d = int(config["num_features"]), int(config["num_dense"])
    sizes = torch.from_numpy(vocab_sizes(config)).to(device)

    def draw(entry, shape, **kw):
        params = {k: v for k, v in entry.items() if k != "dist"}
        return find(entry["dist"]).draw(params, shape, g, device, **kw)
    ids = draw(mix["ids"], (p, b, f), sizes=sizes)
    if bool(((ids < 0) | (ids >= sizes)).any()):
        raise ValueError(f"{mix['ids']['dist']}: an id outside its "
                         f"feature's vocabulary")
    dense = draw(mix["dense"], (p, b, d), sizes=None)
    label = (torch.rand((p, b), generator=g, device=device)
             < float(mix["positive_share"])).to(torch.float32)
    return RawPool(ids=ids.cpu().numpy(), dense=dense.cpu().numpy(),
                   label=label.cpu().numpy())
