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

JAX compiles that step into one program (``jax.jit(step_fn,
donate_argnums=(0,))``) and caches it by the batch's structure, shapes
and dtypes. The port keeps a cache of step programs with the same key,
plus the identity of the state's tensors (a CUDA graph is bound to their
addresses, as a donated JAX state is to its buffers), so ``copy_state``,
a checkpoint load or a new ``init`` builds a new program. On CUDA a
program is one captured CUDA graph (``torch.cuda.graphs``) of pull,
gradients, dense update, push and ``step += 1`` over static input
buffers; building it takes one eager warm-up step on a side stream (a
real step, counted as one) and then the capture, and every later step
copies the batch into the buffers and replays the graph. A capture that
fails raises; nothing falls back to the eager step. On the CPU a program
is the eager step, cached and counted the same way, so that
``fit(retrace_budget=)`` means there what it means on the card.
``train_step_eager`` is the step without a program, on any device.
``eval_step`` keeps a cache of eval programs keyed the same way (JAX jits
it too): on CUDA one captured graph of pull, model and sigmoid, sharing
the step programs' memory pool (they replay one at a time, on one
stream); ``eval_step_eager`` is its oracle.

``Trainer(sparse_as_dense=...)`` keeps the small-vocabulary features as
dense parameters (``hybrid.py``): the module is wrapped in
``HybridModel``, and each batch column goes to the collection or to the
dense-kept tables by name, outside and inside the programs alike.

The step has static shapes and reads nothing back to the host: no
``.item()``, no ``torch.unique``, no Boolean-mask indexing. The batch
moves to the device with copies that do not wait, and the step counter is
a device tensor. ``fit`` reads the loss only on its ``log_every`` steps.

The JAX ``train_step`` donates its input state and returns a new one; the
port's updates the state's tensors in place and returns the same state.

With the collection's dirty tracking armed, each step marks the chunks
its batch touches from the host batch, after the step and outside any
program (JAX marks outside its jit), so a replayed step is marked as
often as an eager one. ``fit(autosave_every=, autosave_dir=)`` writes a
blocking delta autosave of the whole ``TrainState`` every N steps (its
tables by chunks, its dense parameters and optimizer state as
``dense_state.msgpack``) with the trained-batch cursor in the manifest;
``fit(resume_from=)`` restores the newest committed autosave into a new
state and skips the batches it holds. An autosave only reads the state,
so a captured program survives it; a resumed state builds its program
once, inside ``fit``'s two-step warm-up.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
import weakref
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from .analysis import scope
from .analysis.concurrency import sync_point
from .analysis.retrace import RetraceGuard, note_build
from .embedding import EmbeddingCollection, EmbeddingSpec, not_ported
from .hybrid import DENSE_SCOPE, HybridModel, to_dense_spec
from .models.deepctr import init_params
from .ops.launches import CountedGraph
from .optim.initializers import split
from .utils import observability


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


def _host(x):
    """A host array as a CPU tensor of its own; a tensor (or None) as it
    is."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


def _state_leaves(obj, path=()):
    """``(path, leaf)`` for every leaf of a state: its tensors, and its
    host values (a hash table's ``init_rng``, baked into its init-rows
    launches)."""
    if isinstance(obj, torch.Tensor):
        return ((path, obj),)
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, dict):
        items = list(obj.items())
    else:
        return ((path, obj),)
    return tuple(leaf for k, v in items
                 for leaf in _state_leaves(v, path + (k,)))


def _state_key(state) -> tuple:
    """The identity of a state as a step program sees it: each tensor's
    path, address, shape and dtype, and each host value."""
    return tuple((p, v.data_ptr(), tuple(v.shape), v.dtype)
                 if isinstance(v, torch.Tensor) else (p, v)
                 for p, v in _state_leaves(state))


def _batch_key(host: Dict[str, Any]) -> tuple:
    """What a ``jax.jit`` cache keys a batch on: its columns, and each
    array's shape and dtype; whether ``dense`` is present."""
    def sig(t):
        return None if t is None else (tuple(t.shape), t.dtype)
    return (sig(host["label"]), sig(host["dense"]),
            tuple((k, sig(v)) for k, v in sorted(host["sparse"].items())))


class _Program:
    """A step program, bound to the tensors of the state it was built on.
    It holds weak references to them: once one is gone the program is
    stale, so a new state that lands on the same addresses builds its own
    program, as a new state does in JAX."""

    build_s = 0.0
    pool_bytes = None

    def __init__(self, state: "TrainState"):
        self._refs = [weakref.ref(v) for _, v in _state_leaves(state)
                      if isinstance(v, torch.Tensor)]

    def live(self) -> bool:
        return all(r() is not None for r in self._refs)


class _EagerProgram(_Program):
    """A program on the CPU: ``fn(state, placed batch)``, eagerly."""

    def __init__(self, trainer: "Trainer", state: "TrainState", fn):
        super().__init__(state)
        self.trainer = trainer
        self.fn = fn

    def __call__(self, state: "TrainState", host) -> torch.Tensor:
        return self.fn(state, self.trainer.place_batch(host))


class _CapturedProgram(_Program):
    """A program on a CUDA device: one ``CountedGraph`` of ``fn(state,
    batch)`` (the step, or the eval) over static input buffers, bound to
    the state it was built on.

    Building it copies the first batch into the buffers, runs ``fn`` once
    eagerly on a side stream (``torch.cuda.graphs``' warm-up: lazy
    initialization and every kernel's first launch happen outside the
    capture), then captures it into the graph memory pool of the
    trainer's other captured programs, step and eval alike, which they all
    share (they replay one at a time, on one stream). ``first`` is the
    warm-up's output (a step's: its loss, and the step is taken);
    ``build_s`` the seconds the build took; ``pool_bytes`` the memory the
    capture reserved."""

    def __init__(self, trainer: "Trainer", state: "TrainState", host, fn):
        super().__init__(state)
        t0 = time.perf_counter()
        dev = trainer.device

        def buffer(t):
            return None if t is None else torch.empty(
                t.shape, dtype=t.dtype, device=dev)
        self.inputs = {"label": buffer(host["label"]),
                       "dense": buffer(host["dense"]),
                       "sparse": {k: buffer(v)
                                  for k, v in host["sparse"].items()}}
        self._load(host)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn(state, self.inputs)
        main.wait_stream(side)
        self.first.record_stream(main)
        self.graph = CountedGraph()
        with self.graph.capture(pool=trainer._graph_pool()):
            reserved = torch.cuda.memory_reserved(dev)
            self.out = fn(state, self.inputs)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.build_s = time.perf_counter() - t0

    def _load(self, host) -> None:
        """Copy a batch into the static buffers, on the current stream and
        without waiting for the device."""
        pairs = [(self.inputs["label"], host["label"]),
                 (self.inputs["dense"], host["dense"])] + [
            (self.inputs["sparse"][k], v) for k, v in host["sparse"].items()]
        for buf, x in pairs:
            if buf is not None:
                buf.copy_(x, non_blocking=True)

    def __call__(self, state: "TrainState", host) -> torch.Tensor:
        del state           # the graph holds its tensors' addresses
        self._load(host)
        self.graph.replay()
        # a copy of its own: the next replay overwrites the graph's output
        return self.out.clone()


class Trainer:
    """Train and eval steps for a dense ``module`` beside an
    ``EmbeddingCollection``.

    ``module(dense, rows)`` returns logits of shape ``[B]``; a batch is
    ``{"label": [B], "dense": [B, d] (optional), "sparse": {name: ids}}``
    of numpy arrays or tensors. ``dense_optimizer`` is one of
    ``optim/dense.py``'s. The step runs on the collection's device.

    ``sparse_as_dense``: the dense-kept features
    (``hybrid.split_sparse_dense``'s ``DenseFeatureSpec`` s, or array
    ``EmbeddingSpec`` s; a hash spec raises ``ValueError``), as in JAX:
    the module becomes ``HybridModel(module, specs)`` and their columns
    never reach the collection. The JAX ``Trainer``'s ``offload`` and
    ``pipeline_depth`` raise ``NotImplementedError`` naming their
    ROADMAP.md item.
    """

    def __init__(self, module: torch.nn.Module,
                 collection: EmbeddingCollection,
                 dense_optimizer,
                 loss_fn: Callable = binary_logloss,
                 sparse_as_dense: Optional[Any] = None,
                 offload: Optional[Dict[str, Any]] = None,
                 pipeline_depth: Optional[int] = None):
        if offload:
            raise not_ported("Trainer(offload=)", "host offload")
        if pipeline_depth is not None:
            raise not_ported("Trainer(pipeline_depth=)", "host offload")
        if sparse_as_dense:
            specs = tuple(to_dense_spec(x) if isinstance(x, EmbeddingSpec)
                          else x for x in sparse_as_dense)
            module = HybridModel(module, specs)
            self._dense_names = frozenset(x.name for x in specs)
        else:
            self._dense_names = frozenset()
        self.collection = collection
        self.device = collection.device
        self.module = module.to(self.device)
        self.tx = dense_optimizer
        self.loss_fn = loss_fn
        # serving signature "<uuid>-<step>", as the JAX Trainer stamps it
        self.model_uuid = uuid.uuid4().hex[:12]
        # step programs by (batch signature, state identity), and the
        # number of programs built
        self.programs: Dict[tuple, _Program] = {}
        self.builds = 0
        # eval programs, keyed the same way
        self.eval_programs: Dict[tuple, _Program] = {}
        self.eval_builds = 0
        # host step counter of the step spans (advances on errors too)
        self._host_step = 0

    # --- initialization ----------------------------------------------------
    def init(self, rng, sample_batch: Dict[str, Any]) -> TrainState:
        """Dense parameters, the dense optimizer's state and every
        embedding table, from the threefry key ``rng`` (``prng_key(seed)``)
        as JAX's ``Trainer.init(rng, batch)`` draws them: ``rng`` splits
        into the tables' key and the dense key (``split``), the tables
        come from ``collection.init(emb_rng)`` and the dense parameters
        from flax's keys under the dense key (``models.deepctr.
        init_params``; a dense-kept table only for a column of the sample
        batch, as flax creates it). The same values on every device. The
        sample batch's sparse columns must be the collection's or
        dense-kept."""
        unknown = set(sample_batch["sparse"]) - set(self.collection.specs) \
            - self._dense_names
        if unknown:
            raise ValueError(f"batch columns {sorted(unknown)} are not in "
                             "the collection")
        emb_rng, dense_rng = split(rng)
        params = init_params(self.module, dense_rng, self.device,
                             dense_ids=set(sample_batch["sparse"]))
        return TrainState(
            step=torch.zeros((), dtype=torch.int64, device=self.device),
            params=params, opt_state=self.tx.init(params),
            emb=self.collection.init(emb_rng))

    # --- steps ---------------------------------------------------------------
    def host_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's arrays as tensors where they lie, host arrays copied
        into CPU tensors and a hash variable's host ids widened on the
        host (``EmbeddingCollection.host_ids``; dense-kept columns pass as
        they are): the host's part of placing a batch, done outside any
        program."""
        return {"label": _host(batch["label"]),
                "dense": _host(batch.get("dense")),
                "sparse": {k: _host(v) if k in self._dense_names
                           else self.collection.host_ids(k, v)
                           for k, v in batch["sparse"].items()}}

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch's arrays on the trainer's device (the JAX
        ``shard_batch``), copied without waiting."""
        host = self.host_batch(batch)

        def placed(x):
            return None if x is None else x.to(self.device,
                                               non_blocking=True)
        return {"label": placed(host["label"]),
                "dense": placed(host["dense"]),
                "sparse": {k: placed(v) if k in self._dense_names
                           else self.collection.to_device(k, v)
                           for k, v in host["sparse"].items()}}

    def _split_sparse(self, sparse: Dict[str, Any]):
        """A batch's columns split by name: the collection's, and the
        dense-kept ids (None without ``sparse_as_dense``)."""
        if not self._dense_names:
            return sparse, None
        return ({k: v for k, v in sparse.items()
                 if k not in self._dense_names},
                {k: v for k, v in sparse.items() if k in self._dense_names})

    def _check_dense_ids(self, state: TrainState, host) -> None:
        """A dense-kept column needs its table: flax has none for a column
        its init batch lacked, and its apply fails; so does this."""
        _, dense_ids = self._split_sparse(host["sparse"])
        for k in dense_ids or ():
            if f"{DENSE_SCOPE}.{k}" not in state.params:
                raise ValueError(
                    f"dense-kept column {k!r} has no table: the sample "
                    "batch given to init lacked it")

    def _logits(self, params, dense, rows, dense_ids=None):
        args = (dense, rows) if dense_ids is None \
            else (dense, rows, dense_ids)
        return functional_call(self.module, params, args)

    def _step(self, state: TrainState, batch) -> torch.Tensor:
        """The step on a placed batch (or a program's static buffers):
        pull, loss and gradients, dense update, push, ``step += 1``, all
        in place. Returns the loss, a device scalar."""
        pull_inputs, _ = self._split_sparse(batch["sparse"])
        rows = self.collection.pull(state.emb, pull_inputs)
        loss, row_grads = self.dense_step(state, batch, rows)
        with torch.no_grad():
            # dirty marks come from the host batch, outside the step
            self.collection.apply_gradients(state.emb, pull_inputs,
                                            row_grads, mark=False)
            state.step.add_(1)
        return loss

    @torch.no_grad()
    def _scores(self, state: TrainState, batch) -> torch.Tensor:
        """The eval on a placed batch (or a program's static buffers):
        pull, model, ``sigmoid``; scores ``[B]``."""
        pull_inputs, dense_ids = self._split_sparse(batch["sparse"])
        rows = self.collection.pull(state.emb, pull_inputs)
        logits = self._logits(state.params, batch["dense"], rows, dense_ids)
        return torch.sigmoid(logits.reshape(-1))

    def _run(self, cache: Dict[tuple, _Program], fn, state: TrainState,
             host) -> tuple:
        """``fn`` on the host batch ``host`` (:meth:`host_batch`) through
        its program in ``cache`` (batch signature and state identity),
        building the program first when there is none: on CUDA a captured
        graph, whose warm-up is this call, on the CPU the eager ``fn``.
        Returns the output and whether a program was built."""
        self._check_dense_ids(state, host)
        key = (_batch_key(host), _state_key(state))
        program = cache.get(key)
        if program is not None and program.live():
            return program(state, host), False
        self._drop_stale_programs()
        if self.device.type == "cuda":
            program = _CapturedProgram(self, state, host, fn)
            out = program.first
        else:
            program = _EagerProgram(self, state, fn)
            out = program(state, host)
        cache[key] = program
        note_build()
        return out, True

    def train_step(self, state: TrainState, batch) -> tuple:
        """One step; returns ``(state, {"loss": device scalar})``. The
        state's tensors are updated in place.

        The step runs the cached step program of the batch's signature and
        the state's tensors, building it first when there is none (module
        note): on CUDA the build's warm-up is this step and later calls
        replay the captured graph; the loss returned is a tensor of its
        own, which no later step overwrites. With dirty tracking armed the
        batch's chunks are marked from the host batch after the step."""
        try:
            with scope.step_span(self._host_step):
                host = self.host_batch(batch)
                loss, built = self._run(self.programs, self._step, state,
                                        host)
                self.builds += built
                self._mark_dirty(host)
        finally:
            self._host_step += 1
        return state, {"loss": loss}

    def _mark_dirty(self, host) -> None:
        """Mark the chunks of a stepped batch's collection columns, from
        its host arrays (a no-op unless tracking is armed)."""
        if self.collection.dirty_trackers:
            cols, _ = self._split_sparse(host["sparse"])
            self.collection.mark_dirty(cols)

    def _graph_pool(self):
        """The memory pool of a live captured program, step or eval, or
        None (the next capture then takes a pool of its own). A pool lives
        as long as a graph that uses it, so it is always taken from one."""
        for p in list(self.programs.values()) \
                + list(self.eval_programs.values()):
            if isinstance(p, _CapturedProgram):
                return p.graph.graph.pool()
        return None

    def _drop_stale_programs(self) -> None:
        """Forget the step and eval programs of states that are gone,
        freeing their graphs once the device has finished with them."""
        caches = (self.programs, self.eval_programs)
        stale = [(c, k) for c in caches for k, p in c.items()
                 if not p.live()]
        if stale and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for c, k in stale:
            del c[k]

    def train_step_eager(self, state: TrainState, batch) -> tuple:
        """One step dispatched op by op, with no step program (the oracle
        of the captured step); the same result as :meth:`train_step`."""
        host = self.host_batch(batch)
        placed = self.place_batch(host)
        self._check_dense_ids(state, placed)
        loss = self._step(state, placed)
        self._mark_dirty(host)
        return state, {"loss": loss}

    def dense_step(self, state: TrainState, batch, rows):
        """The dense half of a step on pulled rows: the loss, its
        gradients with respect to the dense parameters (the dense-kept
        tables among them) and the rows, and the dense update (in place).
        ``batch`` is placed (:meth:`place_batch`). Returns ``(loss, row
        gradients)``; a column the model does not read gets zero
        gradients, as ``jax.grad`` gives them."""
        _, dense_ids = self._split_sparse(batch["sparse"])
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        rows = {k: v.detach().requires_grad_() for k, v in rows.items()}
        loss = self.loss_fn(
            self._logits(params, batch["dense"], rows, dense_ids),
            batch["label"])
        grads = torch.autograd.grad(
            loss, list(params.values()) + list(rows.values()),
            allow_unused=True, materialize_grads=True)
        self.tx.apply(state.params, dict(zip(params, grads[:len(params)])),
                      state.opt_state)
        return loss.detach(), dict(zip(rows, grads[len(params):]))

    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Scores ``sigmoid(logits)`` for a batch, ``[B]``, through the
        cached eval program of the batch's signature and the state's
        tensors (built at the first call, as a JAX ``jit``: on CUDA one
        captured graph, replayed by later calls; a failed capture
        raises). The scores are a tensor of their own."""
        scores, built = self._run(self.eval_programs, self._scores, state,
                                  self.host_batch(batch))
        self.eval_builds += built
        return scores

    def eval_step_eager(self, state: TrainState, batch) -> torch.Tensor:
        """The eval dispatched op by op (the oracle of :meth:`eval_step`)."""
        placed = self.place_batch(batch)
        self._check_dense_ids(state, placed)
        return self._scores(state, placed)

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
        the only reads of the loss.

        ``retrace_budget``: step-program builds allowed after a two-step
        warm-up, as the JAX ``fit`` allows XLA compilations (step 1 builds
        the program; the guard opens after step 2). A fixed-shape loop on
        one state needs 0. A trip raises
        :class:`analysis.retrace.RetraceBudgetExceeded` at the end of the
        loop.

        ``autosave_every=N`` with ``autosave_dir``: every N steps the loop
        blocks on a delta autosave of the whole state (``save_checkpoint(
        mode="delta")`` of the tables, ``(params, opt_state)`` as the
        dense state; the first save into an empty directory is full),
        committing ``{"fit": {"step", "epoch", "cursor"}}``, ``cursor``
        the batches trained so far. The collection's dirty tracking must
        be armed. ``resume_from=DIR``: before the loop, restore the state
        from the newest committed autosave under DIR (a torn last delta
        resumes one autosave earlier, a missing or unarmed DIR starts
        fresh at cursor 0) and skip the batches it holds
        (``batches.skip_batches(cursor)`` where the source has it, else
        ``cursor`` batches consumed). A killed and resumed ``fit`` then
        trains bit for bit as an uninterrupted one from that autosave.
        ``persist_dir`` (offloaded tables) raises ``NotImplementedError``
        naming its ROADMAP.md item.

        Ingest accounting (JAX's ``fit``): the next batch is fetched after
        each step is launched, so on the card the fetch overlaps the
        step, and the fetch's wall time is recorded as that step's stall
        (``observability.record_ingest_stall``; the first fetch, the
        warm-up, is not). A source that records its own waits (a
        ``ShardStream``, marked ``ingest_accounted``, or one wrapped so
        that the mark is hidden but which still records) is not counted
        twice. The window holds one batch: ``pipeline_depth`` is a later
        slice."""
        if persist_dir is not None:
            raise not_ported("fit(persist_dir=)", "host offload")
        if autosave_every and not autosave_dir:
            raise ValueError("fit(autosave_every=) requires autosave_dir=")
        last, guard = None, None
        it = iter(batches)
        base_cursor = 0
        if resume_from is not None:
            state, base_cursor = self._restore_fit(state, resume_from)
            if base_cursor:
                skip = getattr(batches, "skip_batches", None)
                if skip is not None:
                    skip(base_cursor)
                else:
                    for k in range(base_cursor):
                        if next(it, None) is None:
                            raise ValueError(
                                f"resume cursor {base_cursor} is past the "
                                f"batch source (exhausted after {k}): "
                                "wrong source for this checkpoint?")
        # a source that records its own waits (ShardStream) must not have
        # them counted twice; a wrapper hides the mark, so each fetch also
        # checks whether the source recorded an entry of its own
        self_accounted = bool(getattr(batches, "ingest_accounted", False)
                              or getattr(it, "ingest_accounted", False))
        i = 0
        try:
            batch = next(it, None)   # the first fetch: warm-up, unrecorded
            while batch is not None:
                # the chaos injection site for "kill the trainer between
                # two steps"
                sync_point("trainer.fit.step")
                state, last = self.train_step(state, batch)
                if retrace_budget is not None and guard is None and i >= 1:
                    guard = RetraceGuard(budget=retrace_budget,
                                         name="Trainer.fit steady state")
                    guard.__enter__()
                if autosave_every and (i + 1) % autosave_every == 0:
                    self._autosave_fit(state, autosave_dir,
                                       base_cursor + i + 1)
                if log_every and (i + 1) % log_every == 0:
                    log_fn(f"step {i + 1}: loss={float(last['loss']):.5f}")
                i += 1
                # the next batch, fetched while the device runs this step;
                # its wall time is the step's ingest stall
                pops0 = None if self_accounted \
                    else observability.ingest_stall_records()
                t0 = time.perf_counter()
                batch = next(it, None)
                if not self_accounted \
                        and observability.ingest_stall_records() == pops0:
                    observability.record_ingest_stall(
                        time.perf_counter() - t0)
        except BaseException as e:
            if guard is not None:
                guard.__exit__(type(e), e, None)
            raise
        if guard is not None:
            guard.__exit__(None, None, None)
        return state, last

    def _restore_fit(self, state: TrainState, path: str):
        """``(state, cursor)`` restored from the delta chain at ``path``
        (``fit``'s ``resume_from``). No manifest means nothing was ever
        committed: the caller's state at cursor 0. The restored state is
        new tensors; each hash table keeps ``state``'s init key (the init
        key is the trainer's, not the checkpoint's), so keys first seen
        after the resume draw the rows they draw in an uninterrupted
        run."""
        from . import checkpoint as ckpt_mod
        from . import checkpoint_delta as cd
        cd.join_compactor(path)
        if cd.read_manifest(path) is None:
            sync_point("trainer.resume.restore")
            return state, 0
        info: Dict[str, Any] = {}
        with scope.span("trainer.resume"):
            emb, (params, opt_state) = ckpt_mod.load_checkpoint(
                path, self.collection,
                dense_state_template=(state.params, state.opt_state),
                info=info)
        for name, st in emb.items():
            if hasattr(st, "init_rng"):
                st.init_rng = state.emb[name].init_rng
        fit_extra = (info.get("resume_extra") or {}).get("fit") or {}
        step = int(fit_extra.get("step", 0))
        cursor = int(fit_extra.get("cursor", 0))
        sync_point("trainer.resume.restore")
        return TrainState(
            step=torch.tensor(step, dtype=state.step.dtype,
                              device=self.device),
            params=params, opt_state=opt_state, emb=emb), cursor

    def _autosave_fit(self, state: TrainState, path: str,
                      cursor: int) -> None:
        """One blocking delta autosave of the whole state with the resume
        extra ``{"fit": {step, epoch, cursor}}`` (``cursor`` spans epochs
        of the batch sequence, so ``epoch`` is informational). It reads
        the state and changes none of its tensors."""
        from . import checkpoint as ckpt_mod
        step = int(state.step)
        extra = {"fit": {"step": step, "epoch": 0, "cursor": int(cursor)}}
        with scope.span("trainer.autosave", step=str(step)):
            ckpt_mod.save_checkpoint(
                path, self.collection, state.emb,
                dense_state=(state.params, state.opt_state),
                mode="delta", step=step, extra=extra)
