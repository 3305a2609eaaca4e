"""Adagrad, as the configuration states it.

Sparse (a table's touched rows, each row's gradient summed over its
occurrences in the batch)::

    acc += g * g;   w -= lr * g / (sqrt(acc) + eps)

Dense (the optax form: ``eps`` inside the root)::

    s += g * g;     p -= lr * g / sqrt(s + eps)
"""

from __future__ import annotations

import torch


def sparse_adagrad(w: torch.Tensor, acc: torch.Tensor, g: torch.Tensor,
                   lr: float, eps: float):
    acc = acc + g * g
    return w - lr * g / (torch.sqrt(acc) + eps), acc


def dense_adagrad(p: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                  lr: float, eps: float):
    s = g * g + s
    return p - lr * g / torch.sqrt(s + eps), s
