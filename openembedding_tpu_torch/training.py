"""Training on one device: ``TrainState``, the loss and the ``Trainer``
(``openembedding_tpu/training.py``).

A step does what the JAX package's jitted step does, as PyTorch ops:
pull the batch's rows through the collection (on the card the CUDA
row-gather kernel for array tables; the probe-gather and init-rows
kernels for hash tables), take the loss and its gradients with respect to the dense
parameters and the pulled rows (``jax.value_and_grad(argnums=(0, 1))``),
update the dense parameters, and push the row gradients into the tables
(``EmbeddingCollection.apply_gradients``). No gradient flows into a table
through the gather, so the gather needs no backward.

The step has static shapes and reads nothing back to the host: no
``.item()``, no ``torch.unique``, no Boolean-mask indexing. The batch
moves to the device with copies that do not wait, and the step counter is
a device tensor. ``fit`` reads the loss only on its ``log_every`` steps.

The JAX ``train_step`` donates its input state and returns a new one; the
port's updates the state's tensors in place and returns the same state.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from .embedding import EmbeddingCollection, not_ported
from .models.deepctr import init_params
from .optim.initializers import split


@dataclasses.dataclass
class TrainState:
    """Whole-model training state on one device."""

    step: torch.Tensor               # int64 scalar: steps taken
    params: Dict[str, torch.Tensor]  # dense parameters, by module name
    opt_state: Dict[str, torch.Tensor]   # the dense optimizer's state
    emb: Dict[str, Any]              # embedding states (TableState)


def copy_state(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device`` (steps on one leave the other as
    it was): every tensor of the dense state and of each table state
    (a hash table's keys and failure count too)."""
    def cp(t):
        return t.to(device, copy=True)

    def cp_table(s):
        return dataclasses.replace(s, **{
            f.name: cp(v) if isinstance(v, torch.Tensor)
            else {k: cp(x) for k, x in v.items()} if isinstance(v, dict)
            else v
            for f in dataclasses.fields(s)
            for v in (getattr(s, f.name),)})
    return TrainState(
        step=cp(state.step),
        params={k: cp(v) for k, v in state.params.items()},
        opt_state={k: cp(v) for k, v in state.opt_state.items()},
        emb={n: cp_table(s) for n, s in state.emb.items()})


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Mean sigmoid cross-entropy, in ``optax.sigmoid_binary_cross_entropy``'s
    form: ``-y·log σ(x) - (1 - y)·log σ(-x)``."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    loss = -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)
    return torch.mean(loss)


def _placed(x, device: torch.device):
    """A host array or tensor as a tensor on ``device``, copied without
    waiting for the device."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(device, non_blocking=True)


class Trainer:
    """Train and eval steps for a dense ``module`` beside an
    ``EmbeddingCollection``.

    ``module(dense, rows)`` returns logits of shape ``[B]``; a batch is
    ``{"label": [B], "dense": [B, d] (optional), "sparse": {name: ids}}``
    of numpy arrays or tensors. ``dense_optimizer`` is one of
    ``optim/dense.py``'s. The step runs on the collection's device.

    The JAX ``Trainer``'s ``sparse_as_dense``, ``offload`` and
    ``pipeline_depth`` raise ``NotImplementedError`` naming their ROADMAP.md
    items.
    """

    def __init__(self, module: torch.nn.Module,
                 collection: EmbeddingCollection,
                 dense_optimizer,
                 loss_fn: Callable = binary_logloss,
                 sparse_as_dense: Optional[Any] = None,
                 offload: Optional[Dict[str, Any]] = None,
                 pipeline_depth: Optional[int] = None):
        if sparse_as_dense:
            raise not_ported("Trainer(sparse_as_dense=)",
                             "ragged and hybrid features")
        if offload:
            raise not_ported("Trainer(offload=)", "host offload")
        if pipeline_depth is not None:
            raise not_ported("Trainer(pipeline_depth=)", "host offload")
        self.collection = collection
        self.device = collection.device
        self.module = module.to(self.device)
        self.tx = dense_optimizer
        self.loss_fn = loss_fn
        # serving signature "<uuid>-<step>", as the JAX Trainer stamps it
        self.model_uuid = uuid.uuid4().hex[:12]

    # --- initialization ----------------------------------------------------
    def init(self, rng, sample_batch: Dict[str, Any]) -> TrainState:
        """Dense parameters, the dense optimizer's state and every
        embedding table, from the threefry key ``rng`` (``prng_key(seed)``)
        as JAX's ``Trainer.init(rng, batch)`` draws them: ``rng`` splits
        into the tables' key and the dense key (``split``), the tables
        come from ``collection.init(emb_rng)`` and the dense parameters
        from flax's keys under the dense key (``models.deepctr.
        init_params``). The same values on every device. The sample
        batch's sparse columns must be the collection's."""
        unknown = set(sample_batch["sparse"]) - set(self.collection.specs)
        if unknown:
            raise ValueError(f"batch columns {sorted(unknown)} are not in "
                             "the collection")
        emb_rng, dense_rng = split(rng)
        params = init_params(self.module, dense_rng, self.device)
        return TrainState(
            step=torch.zeros((), dtype=torch.int64, device=self.device),
            params=params, opt_state=self.tx.init(params),
            emb=self.collection.init(emb_rng))

    # --- steps ---------------------------------------------------------------
    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's arrays on the trainer's device (the JAX
        ``shard_batch``), copied without waiting."""
        return {"label": _placed(batch["label"], self.device),
                "dense": _placed(batch.get("dense"), self.device),
                "sparse": {k: self.collection.to_device(k, v)
                           for k, v in batch["sparse"].items()}}

    def _logits(self, params, dense, rows):
        return functional_call(self.module, params, (dense, rows))

    def train_step(self, state: TrainState, batch) -> tuple:
        """One step; returns ``(state, {"loss": device scalar})``. The
        state's tensors are updated in place."""
        batch = self.place_batch(batch)
        rows = self.collection.pull(state.emb, batch["sparse"])
        loss, row_grads = self.dense_step(state, batch, rows)
        with torch.no_grad():
            self.collection.apply_gradients(state.emb, batch["sparse"],
                                            row_grads)
            state.step.add_(1)
        return state, {"loss": loss}

    def dense_step(self, state: TrainState, batch, rows):
        """The dense half of a step on pulled rows: the loss, its
        gradients with respect to the dense parameters and the rows, and
        the dense update (in place). ``batch`` is placed
        (:meth:`place_batch`). Returns ``(loss, row gradients)``; a column
        the model does not read gets zero gradients, as ``jax.grad`` gives
        them."""
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        rows = {k: v.detach().requires_grad_() for k, v in rows.items()}
        loss = self.loss_fn(self._logits(params, batch["dense"], rows),
                            batch["label"])
        grads = torch.autograd.grad(
            loss, list(params.values()) + list(rows.values()),
            allow_unused=True, materialize_grads=True)
        self.tx.apply(state.params, dict(zip(params, grads[:len(params)])),
                      state.opt_state)
        return loss.detach(), dict(zip(rows, grads[len(params):]))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Scores ``sigmoid(logits)`` for a batch, ``[B]``."""
        batch = self.place_batch(batch)
        rows = self.collection.pull(state.emb, batch["sparse"])
        logits = self._logits(state.params, batch["dense"], rows)
        return torch.sigmoid(logits.reshape(-1))

    def model_sign(self, state: TrainState) -> str:
        """Version-stamped serving signature for this state (reads the
        step back to the host)."""
        return f"{self.model_uuid}-{int(state.step)}"

    def fit(self, state: TrainState, batches, *, log_every: int = 0,
            log_fn=print, persist_dir: Optional[str] = None,
            retrace_budget: Optional[int] = None,
            autosave_every: int = 0,
            autosave_dir: Optional[str] = None,
            resume_from: Optional[str] = None):
        """Step through ``batches``; returns ``(state, last metrics)``.
        Every ``log_every`` steps ``log_fn`` gets ``"step N: loss=..."``,
        the only reads of the loss. The JAX ``fit``'s persist, retrace,
        autosave and resume keywords raise ``NotImplementedError`` naming
        their ROADMAP.md items."""
        if persist_dir is not None:
            raise not_ported("fit(persist_dir=)", "host offload")
        if retrace_budget is not None:
            raise not_ported("fit(retrace_budget=)",
                             "captured training step")
        if autosave_every or autosave_dir is not None \
                or resume_from is not None:
            raise not_ported("fit(autosave_every=, autosave_dir=, "
                             "resume_from=)",
                             "delta checkpoints and other layouts")
        last = None
        for i, batch in enumerate(batches):
            state, last = self.train_step(state, batch)
            if log_every and (i + 1) % log_every == 0:
                log_fn(f"step {i + 1}: loss={float(last['loss']):.5f}")
        return state, last
