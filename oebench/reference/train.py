"""Three training steps of the plain reference, and what they read.

The reference keeps only the rows that the three batches touch (a compact
table: every other row keeps its initial value, which the program must
keep too). Each step pulls the batch's rows, runs DeepFM and its gradients
by autograd, sums each row's gradient over its occurrences, runs sparse
Adagrad on the touched rows and dense Adagrad on the dense parameters.
The model is the configuration's, found by name (``reference/<model>.py``),
with as many fused tables as it pulls from.

It reads, as the program's state is read:

* ``loss``: each step's loss;
* ``grad``: by leaf (each dense parameter, each table), the norm of the
  first step's gradient as the optimizer gets it;
* ``change``: by leaf, the norm of the change after the three steps.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from . import mapping, model, optim


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 matrix products at full precision, or in TF32."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def touched_ids(config: dict, ids: np.ndarray) -> np.ndarray:
    """The table entries that per-feature ids ``[..., F]`` reach: fused
    rows (-1 for none) or hash keys."""
    if config["table"] == "hash":
        return mapping.hash_keys(ids)
    return mapping.fused_rows(ids, mapping.vocab_sizes(config))


def run(config: dict, ids: List[np.ndarray], dense: List[np.ndarray],
        label: List[np.ndarray], initial, device, *, tf32: bool = False,
        half_batch: bool = False) -> Dict:
    """Train on the batches ``(ids[t] [B, F], dense[t], label[t])`` in
    turn from ``initial``'s values; returns the readings. ``tf32``: the
    matrix products in TF32 (the control); ``half_batch``: each step on the
    first half of its batch alone (a planted fault)."""
    device = torch.device(device)
    hashed = config["table"] == "hash"
    entries = [touched_ids(config, i) for i in ids]
    every = np.concatenate([e.ravel() for e in entries])
    uniq = np.unique(every if hashed else every[every >= 0])
    dims = initial.dims
    w0 = {leaf: (initial.hash_rows(leaf, uniq) if hashed
                 else initial.array_rows(leaf, uniq)).float()
          for leaf in dims}
    tables = {leaf: w.clone() for leaf, w in w0.items()}
    acc = {leaf: torch.full_like(w, initial.sparse_accumulator)
           for leaf, w in w0.items()}
    p0 = initial.dense()
    params = {k: v.clone() for k, v in p0.items()}
    sums = {k: torch.full_like(v, initial.dense_accumulator)
            for k, v in p0.items()}
    sp, dn = config["sparse_optimizer"], config["dense_optimizer"]
    net = model(config)
    out = {"loss": [], "grad": {}, "change": {}, "stray": {}}
    with matmul_precision(tf32):
        for t, e in enumerate(entries):
            n = e.shape[0] // 2 if half_batch else e.shape[0]
            pos = np.searchsorted(uniq, e[:n])
            if not hashed:
                pos = np.where(e[:n] >= 0, pos, -1)
            idx = torch.from_numpy(pos).to(device)
            ok = idx >= 0
            safe = torch.where(ok, idx, torch.zeros_like(idx))
            rows = {leaf: (tables[leaf][safe] * ok[..., None])
                    .requires_grad_() for leaf in dims}
            p = {k: v.detach().requires_grad_() for k, v in params.items()}
            x = torch.from_numpy(np.ascontiguousarray(dense[t][:n])) \
                .to(device)
            y = torch.from_numpy(np.ascontiguousarray(label[t][:n])) \
                .to(device)
            loss = net.logloss(net.logits(p, rows, x, config), y)
            grads = torch.autograd.grad(loss, list(p.values())
                                        + list(rows.values()))
            dense_grads = dict(zip(p, grads[:len(p)]))
            with torch.no_grad():
                hit = safe[ok]
                touched = torch.unique(hit)
                for leaf, g_rows in zip(dims, grads[len(p):]):
                    g = torch.zeros_like(tables[leaf]).index_add_(
                        0, hit, g_rows[ok])[touched]
                    if t == 0:
                        out["grad"][leaf] = norm(g)
                    w, a = optim.sparse_adagrad(
                        tables[leaf][touched], acc[leaf][touched], g,
                        float(sp["learning_rate"]), float(sp["epsilon"]))
                    tables[leaf][touched] = w
                    acc[leaf][touched] = a
                for k, g in dense_grads.items():
                    if t == 0:
                        out["grad"][k] = norm(g)
                    params[k], sums[k] = optim.dense_adagrad(
                        params[k], sums[k], g, float(dn["learning_rate"]),
                        float(dn["eps"]))
            out["loss"].append(float(loss.detach()))
    for leaf in dims:
        out["change"][leaf] = norm(tables[leaf] - w0[leaf])
        out["stray"][leaf] = 0.0
    for k in p0:
        out["change"][k] = norm(params[k] - p0[k])
        out["stray"][k] = 0.0
    return out
