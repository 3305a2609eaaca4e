"""The plain reference: a model's forward pass, its gradients by autograd,
sparse and dense Adagrad, the fused-id mapping and a hash table's key to
row semantics, in plain PyTorch and NumPy at float32 with TF32 off.

It imports nothing of the program under test, and takes nothing the
program made: it is handed the raw batches and the initial values that the
benchmark drew from the seed, and works out from them what three training
steps produce.

A model is a module of its own here, ``<model>.py``, found by the
configuration's ``model``: it gives ``tables(config)`` (the fused tables it
pulls from and their widths), ``param_shapes(config)``, ``logits(params,
rows, dense, config)``, ``logloss(logits, labels)`` and
``forward_flops(config)``.
"""

from __future__ import annotations

import importlib


def model(config: dict):
    """The reference module of ``config["model"]``."""
    return importlib.import_module(f"{__name__}.{config['model']}")
