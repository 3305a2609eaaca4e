"""Training on one device, or one a process: ``TrainState``, the loss
and the ``Trainer`` (``openembedding_tpu/training.py``).

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
A step times itself (``utils/observability.py``): ``train_step`` reads
the host's clock at its phase boundaries (``StepClock``: the batch stats,
the host preparation, the program lookup, the batch copy, which holds
the wait for the card's previous step where the batch lies in pageable
memory, the launch, the output's copy and the work after it) and adds
them up over the steps that neither build a program nor run
under a ``torch.profiler`` session. A step program built while
``observability.evaluate_performance()`` is on is armed, and the arming
is part of its cache key: its pull, dense half and push open
``observability.stage`` marks, which a captured graph holds as CUDA
event-record nodes between the stages (an unarmed graph holds none) and
which read the host's clock on the CPU; ``observability.step_timings()``
sums them by stage.
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

The planes of a sharded collection that change the step: an int8_ef
variable's residual (``parallel/precision.py``) is sized for the batch
before a program is built (``EmbeddingCollection.size_ef``), so the
graph keeps its buffers; every ``"a2a+cache"`` variable has a
``HotCacheManager`` that observes each stepped batch on the host and
refreshes the replica in place every ``cache_refresh_every`` steps
(:meth:`Trainer._note_hot_cache`), outside the program, which it leaves
valid; pipelined variables (``parallel/pipelined.py``) run a step
program that consumes the rows prefetched by the step before, pushes,
and prefetches the next batch's rows (given as ``train_step(next_batch=
)``, ``fit``'s window head) into the same buffer, the numbers ``a2a``'s
bit for bit.

On a collection whose mesh spans processes (``distributed.py``), each
process steps its own slice of the global batch: the dense half runs on
the local rows, the loss is the local sum over the global count (each
process adds its share; the sum over the processes is the global
mean), the dense gradients are summed over the processes before the
update, so the dense parameters, which start equal from the same key,
stay equal, and the pushes exchange through the planes, every plane of
a single process's. A cached variable's sketch counts the global batch
(each column gathered over the processes) and every refresh checks that
the processes admitted the same keys; the pipelined schedule checks
that they prime on the same steps, and ``fit`` that their sources hold
as many batches, so a divergence raises instead of blocking in a
collective. Gloo's
collectives run on the host, which a CUDA graph cannot capture, so on
such a mesh ``train_step`` and ``eval_step`` run the eager step (their
programs are ``_EagerProgram`` s, counted as builds the same way); a
captured step over ``nccl`` is for a later slice.

``Trainer(offload=)`` trains variables whose rows live in a host store
(``offload.ShardedOffloadedTable``): before each step the batch's missing
rows are inserted into the variable's device cache, in place and outside
the program, from host prepares that run up to ``pipeline_depth`` batches
ahead on a lookahead thread; after it the table records its dirty rows.
An eviction rebuilds the cache in the same tensors, so the step program
stays valid. ``fit`` is JAX's loop: a window of ``pipeline_depth + 1``
batches, the refill timed as the step's ingest stall, and
``fit(persist_dir=)`` persisting offloaded tables in the background.

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

import contextlib
import dataclasses
import hashlib
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from .analysis import scope
from .analysis.concurrency import sync_point
from .analysis.retrace import RetraceGuard, note_build
from .embedding import EmbeddingCollection, EmbeddingSpec
from .hybrid import DENSE_SCOPE, HybridModel, to_dense_spec
from .models.deepctr import init_params
from .ops.launches import CountedGraph
from .optim.initializers import split
from .parallel import pipelined as pipeline_lib
from .utils import observability


@dataclasses.dataclass
class TrainState:
    """Whole-model training state on one device."""

    step: torch.Tensor               # int64 scalar: steps taken
    params: Dict[str, torch.Tensor]  # dense parameters, by module name
    opt_state: Dict[str, torch.Tensor]   # the dense optimizer's state
    emb: Dict[str, Any]              # embedding states (TableState; a
                                     # plane's wrapper: EFState, CachedState)
    # the pipelined schedule's prefetched rows (parallel/pipelined.py);
    # None outside it. Derived state, never checkpointed
    pipe: Any = None


def _copy_tree(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _copy_tree(getattr(x, f.name), device)
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _copy_tree(v, device) for k, v in x.items()}
    return x


def copy_state(state: TrainState, device) -> TrainState:
    """A copy of ``state`` on ``device`` (steps on one leave the other as
    it was): every tensor of the dense state and of each table state
    (a hash table's keys and failure count, a plane's replica, residual
    and prefetched rows too)."""
    return _copy_tree(state, device)


def binary_logloss(logits: torch.Tensor, labels: torch.Tensor,
                   count: Optional[int] = None) -> torch.Tensor:
    """Mean sigmoid cross-entropy, in ``optax.sigmoid_binary_cross_entropy``'s
    form: ``-y·log σ(x) - (1 - y)·log σ(-x)``. ``count``: divide the sum
    by it instead of the batch's own size (one process's share of a
    global batch's mean)."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    loss = -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)
    if count is None:
        return torch.mean(loss)
    return torch.sum(loss) / count


def _sum_over_processes(grads, loss, mesh):
    """The dense gradients and the loss summed over the processes: one
    all-reduce of their float32 concatenation."""
    from . import distributed
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads]
                     + [loss.reshape(1).to(torch.float32)])
    distributed.all_reduce(flat, mesh)
    out, o = [], 0
    for g in grads:
        out.append(flat[o:o + g.numel()].view(g.shape).to(g.dtype))
        o += g.numel()
    return out, flat[o].to(loss.dtype)


def _global_column(col, mesh) -> torch.Tensor:
    """A batch column of every process, in rank order: the global batch's
    column (the processes feed equal slices)."""
    from . import distributed
    t = col if isinstance(col, torch.Tensor) \
        else torch.from_numpy(np.array(col, copy=True))
    g = distributed.all_gather(t, mesh)
    return g.reshape((-1,) + tuple(t.shape[1:]))


def _digest(t: torch.Tensor) -> int:
    """A 63-bit digest of a tensor's bytes."""
    raw = t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return int.from_bytes(hashlib.sha256(raw).digest()[:8], "little") >> 1


def _host(x):
    """A host array as a CPU tensor of its own; a tensor (or None) as it
    is."""
    if x is None or isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


def _stats_view(x) -> np.ndarray:
    """A batch column as the numpy array ``record_batch_stats`` scans: a
    host array as it is, a tensor copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    array's shape and dtype; whether ``dense`` is present (and the
    pipelined schedule's next-batch columns)."""
    def sig(t):
        return None if t is None else (tuple(t.shape), t.dtype)
    return (sig(host["label"]), sig(host["dense"]),
            tuple((k, sig(v)) for k, v in sorted(host["sparse"].items())),
            tuple((k, sig(v)) for k, v in sorted(
                (host.get("next") or {}).items())))


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
    """A program on the CPU: ``fn(state, placed batch)``, eagerly. An
    armed one (``Trainer._run``) records its stages on every call:
    ``observability.stage`` marks on the host's clock, or CUDA events on
    the eager card of a mesh across processes."""

    def __init__(self, trainer: "Trainer", state: "TrainState", fn,
                 armed: bool = False):
        super().__init__(state)
        self.trainer = trainer
        self.fn = fn
        self.armed = armed

    def __call__(self, state: "TrainState", host, clock=None,
                 counted: bool = True) -> torch.Tensor:
        placed = self.trainer.place_batch(host)
        if clock is not None:
            clock.mark()                                    # copy
        if not self.armed:
            out = self.fn(state, placed)
        else:
            observability.stages_before_run()
            rec = observability.StageRecorder(
                self.trainer.device.type == "cuda")
            with rec.recording():
                out = self.fn(state, placed)
            if counted:
                observability.stages_after_run(rec)
        if clock is not None:
            clock.mark()                                    # launch
            clock.mark()                                    # output
        return out


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
    capture reserved. An armed program (``Trainer._run``) captures with
    ``stages`` recording, so its graph holds the stage events, and each
    replay first reads the previous armed replay's
    (``observability.stages_before_run``)."""

    def __init__(self, trainer: "Trainer", state: "TrainState", host, fn,
                 armed: bool = False, clock=None):
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
        if host.get("next") is not None:
            self.inputs["next"] = {k: buffer(v)
                                   for k, v in host["next"].items()}
        self._load(host)
        if clock is not None:
            clock.mark()                                    # copy
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn(state, self.inputs)
        main.wait_stream(side)
        self.first.record_stream(main)
        self.graph = CountedGraph()
        self.armed = armed
        self.stages = observability.StageRecorder(True) if armed else None
        with self.graph.capture(pool=trainer._graph_pool()), \
                (self.stages.recording() if armed
                 else contextlib.nullcontext()):
            reserved = torch.cuda.memory_reserved(dev)
            self.out = fn(state, self.inputs)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.build_s = time.perf_counter() - t0
        if clock is not None:
            clock.mark()                                    # launch
            clock.mark()                                    # output

    def _load(self, host) -> None:
        """Copy a batch into the static buffers, on the current stream and
        without waiting for the device."""
        pairs = [(self.inputs["label"], host["label"]),
                 (self.inputs["dense"], host["dense"])] + [
            (self.inputs["sparse"][k], v) for k, v in host["sparse"].items()
        ] + [(self.inputs["next"][k], v)
             for k, v in (host.get("next") or {}).items()]
        for buf, x in pairs:
            if buf is not None:
                buf.copy_(x, non_blocking=True)

    def __call__(self, state: "TrainState", host,
                 clock=None) -> torch.Tensor:
        del state           # the graph holds its tensors' addresses
        self._load(host)
        if clock is not None:
            # a copy from pageable memory waits for the card's previous
            # step once the driver's staging buffer fills: ``copy`` holds it
            clock.mark()                                    # copy
        if self.stages is None:
            self.graph.replay()
        else:
            observability.stages_before_run()
            self.graph.replay()
            observability.stages_after_run(self.stages)
        if clock is not None:
            clock.mark()                                    # launch
        # a copy of its own: the next replay overwrites the graph's output
        out = self.out.clone()
        if clock is not None:
            clock.mark()                                    # output
        return out


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
    never reach the collection.

    ``offload``: name -> ``offload.ShardedOffloadedTable`` for variables
    whose rows live in a host store (registered in the collection by
    their ``embedding_spec()``; the cache state rides ``TrainState.emb``
    like any hash variable). Each step first inserts the batch's missing
    rows into the cache (:meth:`prepare_offload`), then runs its program,
    then records dirty marks (``note_update``). ``pipeline_depth``: how
    many batches of host prepares (residency math and host-store gather,
    on a lookahead thread) may run ahead of the device; results are the
    same at any depth. Default 4, as JAX's.
    """

    def __init__(self, module: torch.nn.Module,
                 collection: EmbeddingCollection,
                 dense_optimizer,
                 loss_fn: Callable = binary_logloss,
                 sparse_as_dense: Optional[Any] = None,
                 offload: Optional[Dict[str, Any]] = None,
                 pipeline_depth: int = 4):
        self.offload = dict(offload or {})
        for oname in self.offload:
            if oname not in collection.specs:
                raise ValueError(
                    f"offloaded variable {oname!r} is not in the collection; "
                    "register table.embedding_spec() in its specs")
            if collection.mesh.spans_processes:
                from .offload import across_processes_error
                raise across_processes_error(
                    f"offloaded variable {oname!r}")
            want = collection.sharding_spec(oname).num_shards \
                if collection.sharded(oname) else 1
            tspec = getattr(self.offload[oname], "spec", None)
            got = tspec.num_shards if tspec is not None else 1
            if got != want:
                raise ValueError(
                    f"offloaded variable {oname!r}: its cache has {got} "
                    f"shard(s) but the collection's variable {want}; build "
                    "the table on the collection's mesh")
        self.pipeline_depth = max(1, int(pipeline_depth))
        # in-flight lookahead prepares, oldest first; each entry's thread
        # chains on the previous one, so host prepares run in batch order
        self._preps: deque = deque()
        # the pipelined schedule: its variables, and the batch the live
        # row buffer was prefetched for plus that buffer's identity (a
        # replayed older state re-primes); a drained buffer is kept to
        # take the next prime in place
        self._pipelined = collection.pipelined_names()
        clash = sorted(set(self._pipelined) & set(self.offload))
        if clash:
            raise ValueError(
                f"offloaded variable(s) {clash} cannot ride a pipelined "
                "plane: offload host-prepare inserts rows between steps, "
                "invalidating the prefetched row buffer")
        self._pipe_for = None
        self._pipe_token = None
        self._pipe_spare = None
        # one admission driver a cached variable; a ':linear' twin shares
        # its base's sketch (the same id column, counted once a step)
        self._hot = {name: collection.make_hot_cache_manager(name)
                     for name in collection.cached_names()}
        for name, mgr in self._hot.items():
            if name.endswith(":linear"):
                base = self._hot.get(name[: -len(":linear")])
                if base is not None:
                    mgr.share_sketch(base)
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
        ``shard_batch``), copied without waiting; a pipelined step's
        ``next`` columns too."""
        host = self.host_batch(batch)

        def placed(x):
            return None if x is None else x.to(self.device,
                                               non_blocking=True)
        out = {"label": placed(host["label"]),
               "dense": placed(host["dense"]),
               "sparse": {k: placed(v) if k in self._dense_names
                          else self.collection.to_device(k, v)
                          for k, v in host["sparse"].items()}}
        if batch.get("next") is not None:
            out["next"] = {k: self.collection.to_device(k, v)
                           for k, v in batch["next"].items()}
        return out

    def shard_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """JAX's ``shard_batch``: the batch on the mesh's device. The
        dense half of a step runs once over the global batch there, as
        JAX's SPMD program computes it; each sharded variable's exchange
        splits the batch over the data axis itself
        (``parallel/alltoall.py``), so the placed batch is
        :meth:`place_batch`'s. On a mesh across processes ``batch`` is
        this process's slice, checked and placed by
        ``distributed.local_batch_to_global``."""
        if self.spans_processes:
            from . import distributed
            batch = distributed.local_batch_to_global(batch,
                                                      self.collection.mesh)
        return self.place_batch(batch)

    @property
    def spans_processes(self) -> bool:
        """Whether the collection's mesh spans processes."""
        return self.collection.mesh.spans_processes

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
        in place. Returns the loss, a device scalar. On a collection with
        pipelined variables their rows come from ``state.pipe`` and the
        step ends with the prefetch of ``batch["next"]`` into it, after
        the push (``parallel/pipelined.py``)."""
        stage = observability.stage
        pull_inputs, _ = self._split_sparse(batch["sparse"])
        stage("pull")
        if self._pipelined:
            _pre, inline = pipeline_lib.split_columns(self.collection,
                                                      pull_inputs)
            rows = dict(state.pipe.rows)
            if inline:
                # the other planes' variables keep their in-step pull
                rows.update(self.collection.pull(state.emb, inline))
        else:
            rows = self.collection.pull(state.emb, pull_inputs)
        stage("dense")
        loss, row_grads = self.dense_step(state, batch, rows)
        with torch.no_grad():
            # dirty marks come from the host batch, outside the step
            stage("push")
            self.collection.apply_gradients(state.emb, pull_inputs,
                                            row_grads, mark=False)
            state.step.add_(1)
            if self._pipelined:
                # the version barrier: pull(N + 1) reads push(N)'s tables
                stage("pull")
                pipeline_lib.prefetch_pull(self.collection, state.emb,
                                           batch["next"], out=state.pipe)
            stage("end")
        return loss

    # --- the pipelined schedule (parallel/pipelined.py) ---------------------
    @property
    def pipeline_plane(self) -> str:
        """The step-span label of the pipelined schedule."""
        if self._pipelined and all(
                self.collection.sharding_spec(n).is_grouped
                for n in self._pipelined):
            return "a2a+grouped+pipelined"
        return "a2a+pipelined"

    def _prime_pipeline(self, state: TrainState, batch) -> TrainState:
        """Pull ``batch``'s pipelined rows eagerly from the tables (the
        pull a serial step opens with) into the state's buffer: in place
        where the buffer (or the one a drain left) fits, so a captured
        program stays bound to it."""
        pull_inputs, _ = self._split_sparse(batch["sparse"])
        pre, _ = pipeline_lib.split_columns(self.collection, pull_inputs)
        fresh = pipeline_lib.prefetch_pull(self.collection, state.emb,
                                           self.shard_batch(
                                               {"label": None,
                                                "sparse": pre})["sparse"])
        pipe = state.pipe if state.pipe is not None else self._pipe_spare
        if pipeline_lib.fits(pipe, fresh.rows):
            with torch.no_grad():
                for k, v in fresh.rows.items():
                    pipe.rows[k].copy_(v)
        else:
            pipe = fresh
        state.pipe = pipe
        return state

    def drain_pipeline(self, state: TrainState) -> TrainState:
        """``state`` without its prefetched rows (``pipe`` None). The
        tables are authoritative after every step, so nothing is lost;
        the next ``train_step`` re-primes, into the same buffer. Eval
        needs no drain."""
        if getattr(state, "pipe", None) is not None:
            self._pipe_spare = state.pipe
        self._pipe_for = None
        self._pipe_token = None
        return pipeline_lib.drain(state)

    def _pipelined_host(self, state: TrainState, batch, next_batch):
        """The host batch of a pipelined step, its ``next`` columns those
        of ``next_batch`` (the batch itself without one), after priming
        the buffer where it does not hold this batch's rows. On a mesh
        across processes every process must prime on the same steps (a
        prime is an exchange): the decision is checked across them, and
        the next columns are this process's slice
        (``distributed.local_batch_to_global``)."""
        prime = state.pipe is None or self._pipe_for is not batch \
            or self._pipe_token != id(state.pipe)
        if self.spans_processes:
            from . import distributed
            distributed.check_agree(
                int(prime), "pipeline primes: every process primes on the "
                "same step (the same batches and next batches)")
        if prime:
            # a first step, a drain, a batch the lookahead did not
            # predict, or an older state: fill the buffer for this batch
            observability.GLOBAL.add("pipeline_primes", 1)
            state = self._prime_pipeline(state, batch)
        nxt = next_batch if next_batch is not None else batch
        host = self.host_batch(batch)
        pipelined = set(self._pipelined)
        cols = {k: v for k, v in nxt["sparse"].items() if k in pipelined}
        if self.spans_processes:
            cols = distributed.local_batch_to_global(cols,
                                                     self.collection.mesh)
        host["next"] = {k: self.collection.host_ids(k, v)
                        for k, v in cols.items()}
        return state, host, nxt

    @torch.no_grad()
    def _scores(self, state: TrainState, batch) -> torch.Tensor:
        """The eval on a placed batch (or a program's static buffers):
        pull, model, ``sigmoid``; scores ``[B]``."""
        pull_inputs, dense_ids = self._split_sparse(batch["sparse"])
        rows = self.collection.pull(state.emb, pull_inputs)
        logits = self._logits(state.params, batch["dense"], rows, dense_ids)
        return torch.sigmoid(logits.reshape(-1))

    def _run(self, cache: Dict[tuple, _Program], fn, state: TrainState,
             host, clock=None, armed: bool = False) -> tuple:
        """``fn`` on the host batch ``host`` (:meth:`host_batch`) through
        its program in ``cache`` (batch signature, state identity and
        ``armed``), building the program first when there is none: on
        CUDA a captured graph, whose warm-up is this call, on the CPU the
        eager ``fn``. An armed program records its stages
        (``observability.stage``). ``clock``: the step's
        ``observability.StepClock``, marked after the lookup, the copy,
        the launch and the output. Returns the output and whether a
        program was built."""
        self._check_dense_ids(state, host)
        key = (_batch_key(host), _state_key(state), armed)
        program = cache.get(key)
        live = program is not None and program.live()
        if clock is not None:
            clock.mark()                                    # lookup
        if live:
            return program(state, host, clock), False
        self._drop_stale_programs()
        if self.device.type == "cuda" and not self.spans_processes:
            program = _CapturedProgram(self, state, host, fn, armed, clock)
            out = program.first
        else:
            if self.spans_processes:
                # the flag decides whether the exchanges' stats run a
                # collective (``alltoall.record_stat``)
                from . import distributed
                distributed.check_agree(
                    observability.evaluate_performance(),
                    "observability.evaluate_performance() must be set "
                    "alike on every process")
            program = _EagerProgram(self, state, fn, armed)
            # a build's first call is its warm-up: its stages go unread
            out = program(state, host, clock, counted=False)
        cache[key] = program
        note_build()
        return out, True

    def train_step(self, state: TrainState, batch, *,
                   next_batch=None) -> tuple:
        """One step; returns ``(state, {"loss": device scalar})``. The
        state's tensors are updated in place.

        The step runs the cached step program of the batch's signature and
        the state's tensors, building it first when there is none (module
        note): on CUDA the build's warm-up is this step and later calls
        replay the captured graph; the loss returned is a tensor of its
        own, which no later step overwrites. With dirty tracking armed the
        batch's chunks are marked from the host batch after the step.

        With offloaded tables, the batch's rows are inserted into their
        caches first (from the lookahead window when its oldest entry
        prepared this very batch object, else synchronously), and
        ``note_update`` records the step after it. ``next_batch``: start
        that batch's host prepare on the lookahead thread while the device
        runs this step (``fit`` keeps ``pipeline_depth`` in flight;
        :meth:`prefetch` is the hand-driven form). The lookahead is keyed
        on batch object identity."""
        profiling = scope.profiling()
        clock = observability.StepClock(self._host_step, profiling)
        self._host_step += 1
        try:
            # the batch-shape stats of JAX's step (always-on gauges, one
            # scan a table a second; every batch when the gate is on), from
            # the batch's host arrays, outside the program
            observability.record_batch_stats(batch["sparse"],
                                             view=_stats_view)
            clock.mark()                                    # stats
            state, uniqs = self._apply_prepared_offload(state, batch)
            if self._pipelined:
                state, host, nxt = self._pipelined_host(state, batch,
                                                        next_batch)
            else:
                host = self.host_batch(batch)
            self._size_ef(state, host)
            clock.mark()                                    # prepare
            record = observability.evaluate_performance()
            loss, built = observability.plane_timed(
                "step", self.pipeline_plane, record and bool(
                    self._pipelined), self._run, self.programs, self._step,
                state, host, clock, record)
            self.builds += built
            if self._pipelined:
                self._pipe_for = nxt
                self._pipe_token = id(state.pipe)
            self._mark_dirty(host)
            self._note_offload(batch, uniqs)
            self._note_hot_cache(state, batch)
            if next_batch is not None and self.offload \
                    and not self._prep_started(next_batch):
                self._start_host_prepare(next_batch)
        except BaseException as e:
            clock.close(False, type(e).__name__)
            raise
        clock.close(not built and not profiling)                 # after
        return state, {"loss": loss}

    def _size_ef(self, state: TrainState, host) -> None:
        """Size the int8_ef residuals for this batch before its program is
        looked up (``EmbeddingCollection.size_ef``)."""
        cols, _ = self._split_sparse(host["sparse"])
        self.collection.size_ef(state.emb, cols)

    def _note_hot_cache(self, state: TrainState, batch) -> TrainState:
        """Feed each cached variable's admission sketch with the stepped
        batch's keys (a shared sketch once a step) and refresh the due
        replicas, in place, outside the program: a re-gather from the
        authoritative table, never a write-back. The refresh's wall time
        is kept per manager (``last_refresh_s``).

        On a mesh across processes each process counts the global batch,
        as JAX's one process does: the column is gathered over the
        processes in rank order (one collective) before it is counted, so
        every sketch, top K and replica is the one-process one. After a
        refresh a digest of the admitted keys is checked across the
        processes: a divergence raises rather than trains on different
        replicas."""
        counted = set()
        mesh = self.collection.mesh
        for name, mgr in self._hot.items():
            col = batch["sparse"].get(name)
            if col is None:
                continue
            if id(mgr.sketch) in counted:
                mgr.tick()
            else:
                if mesh.spans_processes:
                    col = _global_column(col, mesh)
                mgr.observe(col)
                counted.add(id(mgr.sketch))
            if mgr.due:
                mgr.refresh(state.emb[name])
                if mesh.spans_processes:
                    from . import distributed
                    distributed.check_agree(
                        _digest(state.emb[name].cache.keys),
                        f"the replica keys of {name!r} after a refresh")
        return state

    # --- the offload lane -----------------------------------------------------
    def _prep_started(self, batch) -> bool:
        return any(e[1] is batch for e in self._preps)

    def prefetch(self, batches) -> None:
        """Queue offload host prepares for upcoming batches: the batch
        about to step plus up to ``pipeline_depth`` ahead, in the order
        they will be stepped (``fit`` does this itself)."""
        if not self.offload:
            return
        for b in list(batches)[: self.pipeline_depth + 1]:
            if b is not None and not self._prep_started(b):
                self._start_host_prepare(b)

    def _start_host_prepare(self, batch) -> None:
        """Run the host prepare of ``batch`` for every offloaded table on
        a thread of its own that first joins its predecessor, so prepares
        run strictly in batch order (the planned-residency books need
        it). ``_apply_prepared_offload`` joins it and takes the result."""
        prev = self._preps[-1][0] if self._preps else None
        results: Dict[str, Any] = {}
        err: list = []

        def _run():
            if prev is not None:
                prev.join()
            try:
                sync_point("trainer.prep.run")
                for name, table in self.offload.items():
                    with scope.span("lookahead.prepare", table=name):
                        results[name] = table.host_prepare(
                            batch["sparse"][name])
            except BaseException as e:  # noqa: BLE001 — re-raised at join
                err.append(e)

        t = threading.Thread(target=_run, daemon=True, name="oe-prep")
        t.start()
        self._preps.append((t, batch, results, err))

    def _cancel_preps(self) -> None:
        """Abandon every in-flight prepare, oldest first, the whole window
        (later prepares' misses assume the earlier ones' inserts)."""
        while self._preps:
            t, _, results, _err = self._preps.popleft()
            t.join()
            for name, prep in results.items():
                self.offload[name].cancel_prepared(prep)

    def _apply_prepared_offload(self, state: TrainState, batch):
        """Insert this batch's rows into the offloaded caches (in place),
        from the window's oldest entry when it prepared exactly this batch,
        else after cancelling the window. Returns ``(state, {name: unique
        valid ids})``."""
        if not self.offload:
            return state, {}
        prepped = None
        if self._preps and self._preps[0][1] is batch:
            t, _, results, err = self._preps.popleft()
            t.join()
            if err:
                for name, prep in results.items():
                    self.offload[name].cancel_prepared(prep)
                self._cancel_preps()
                raise RuntimeError("background offload prepare failed") \
                    from err[0]
            prepped = results
        else:
            self._cancel_preps()
        uniqs: Dict[str, Any] = {}
        names = list(self.offload)
        for i, name in enumerate(names):
            table = self.offload[name]
            prep = prepped.get(name) if prepped is not None else None
            if prep is None:
                prep = table.host_prepare(batch["sparse"][name])
            try:
                state.emb[name] = table.apply_prepared(state.emb[name], prep)
            except BaseException:
                # release this entry's not-yet-applied preps and the window:
                # a caller that survives must not inherit leaked marks
                table.cancel_prepared(prep)
                if prepped is not None:
                    for later in names[i + 1:]:
                        lp = prepped.get(later)
                        if lp is not None:
                            self.offload[later].cancel_prepared(lp)
                self._cancel_preps()
                raise
            uniqs[name] = prep.uniq
        return state, uniqs

    def _note_offload(self, batch, uniqs) -> None:
        """Each offloaded table's record of a stepped batch: dirty marks
        and the watermark's advance."""
        for name, table in self.offload.items():
            table.note_update(batch["sparse"][name], uniq=uniqs.get(name))

    def prepare_offload(self, state: TrainState, batch) -> TrainState:
        """Insert the batch's offloaded rows into their caches (what
        ``train_step`` does first); call it before :meth:`eval_step` on a
        batch the caches may lack."""
        if not self.offload:
            return state
        state, _ = self._apply_prepared_offload(state, batch)
        return state

    def _drain_suppressed(self) -> None:
        """Unwind-path drain: join the lookahead and every table's
        threads, suppressing secondary failures."""
        try:
            self._cancel_preps()
        except Exception:  # noqa: BLE001 — unwinding
            pass
        for table in self.offload.values():
            try:
                table.finish()
            except Exception:  # noqa: BLE001 — unwinding
                pass

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

    def train_step_eager(self, state: TrainState, batch, *,
                         next_batch=None) -> tuple:
        """One step dispatched op by op, with no step program (the oracle
        of the captured step); the same result as :meth:`train_step`."""
        state, uniqs = self._apply_prepared_offload(state, batch)
        if self._pipelined:
            state, host, nxt = self._pipelined_host(state, batch,
                                                    next_batch)
        else:
            host = self.host_batch(batch)
        self._size_ef(state, host)
        placed = self.place_batch(host)
        self._check_dense_ids(state, placed)
        loss = self._step(state, placed)
        if self._pipelined:
            self._pipe_for = nxt
            self._pipe_token = id(state.pipe)
        self._mark_dirty(host)
        self._note_offload(batch, uniqs)
        self._note_hot_cache(state, batch)
        return state, {"loss": loss}

    def dense_step(self, state: TrainState, batch, rows):
        """The dense half of a step on pulled rows: the loss, its
        gradients with respect to the dense parameters (the dense-kept
        tables among them) and the rows, and the dense update (in place).
        ``batch`` is placed (:meth:`place_batch`). Returns ``(loss, row
        gradients)``; a column the model does not read gets zero
        gradients, as ``jax.grad`` gives them. On a mesh across
        processes (module note) ``loss_fn`` takes ``count=``, the global
        batch's size; the dense gradients and the loss are summed over
        the processes."""
        _, dense_ids = self._split_sparse(batch["sparse"])
        params = {k: v.detach().requires_grad_()
                  for k, v in state.params.items()}
        rows = {k: v.detach().requires_grad_() for k, v in rows.items()}
        logits = self._logits(params, batch["dense"], rows, dense_ids)
        mesh = self.collection.mesh
        if mesh.spans_processes:
            loss = self.loss_fn(
                logits, batch["label"],
                count=batch["label"].shape[0] * mesh.process_count)
        else:
            loss = self.loss_fn(logits, batch["label"])
        grads = torch.autograd.grad(
            loss, list(params.values()) + list(rows.values()),
            allow_unused=True, materialize_grads=True)
        dense_grads = list(grads[:len(params)])
        loss = loss.detach()
        if mesh.spans_processes:
            dense_grads, loss = _sum_over_processes(dense_grads, loss, mesh)
        self.tx.apply(state.params, dict(zip(params, dense_grads)),
                      state.opt_state)
        return loss, dict(zip(rows, grads[len(params):]))

    def eval_step(self, state: TrainState, batch) -> torch.Tensor:
        """Scores ``sigmoid(logits)`` for a batch, ``[B]``, through the
        cached eval program of the batch's signature and the state's
        tensors (built at the first call, as a JAX ``jit``: on CUDA one
        captured graph, replayed by later calls; a failed capture
        raises). The scores are a tensor of their own.

        With ``observability.set_evaluate_performance(True)`` the eval
        runs under an ``eval`` span and waits for its scores, as JAX's
        does; otherwise it returns without waiting."""
        if not observability.evaluate_performance():
            return self._eval(state, batch)
        with scope.span("eval"):
            scores = self._eval(state, batch)
            if scores.device.type == "cuda":
                torch.cuda.synchronize(scores.device)
            return scores

    def _eval(self, state: TrainState, batch) -> torch.Tensor:
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
        be armed, on one shard or a one-process mesh; on a mesh across
        processes ``autosave_every`` raises ``ValueError`` before the
        first step, since a delta save there raises, as JAX's does).
        ``resume_from=DIR``: before
        the loop, restore the state
        from the newest committed autosave under DIR (a torn last delta
        resumes one autosave earlier, a missing or unarmed DIR starts
        fresh at cursor 0) and skip the batches it holds
        (``batches.skip_batches(cursor)`` where the source has it, else
        ``cursor`` batches consumed). A killed and resumed ``fit`` then
        trains bit for bit as an uninterrupted one from that autosave.
        Autosave and resume cover the ``TrainState`` only; offloaded
        tables persist through ``persist_dir``, so either with ``offload``
        raises ``ValueError``, as in JAX.

        ``persist_dir``: after each step, every offloaded table whose
        ``should_persist`` is set writes an incremental persist into
        ``persist_dir/<name>`` on a background thread (``blocking=
        False``), while the loop trains on.

        The loop is JAX's: a window holds the next ``pipeline_depth + 1``
        batches; each turn starts the host prepares of the whole window
        (offload), pops its head, refills it (the refill's wall time is
        that step's ingest stall, ``observability.record_ingest_stall``;
        the first fill, the warm-up, is not recorded) and steps the head
        with ``next_batch`` the new head. A source that records its own
        waits (a ``ShardStream``, marked ``ingest_accounted``, or one
        wrapped so that the mark is hidden but which still records) is not
        counted twice. On an error, and at the end, the lookahead is
        cancelled and every offloaded table finished (joined, its pending
        overflow read), secondary failures suppressed on the error path."""
        if autosave_every:
            if not autosave_dir:
                raise ValueError(
                    "fit(autosave_every=) requires autosave_dir=")
            if self.offload:
                raise ValueError(
                    "fit autosave covers the TrainState only; offloaded "
                    "tables persist via persist_dir= — don't combine "
                    "autosave_every with offload")
            if self.spans_processes:
                raise ValueError(
                    "fit(autosave_every=) saves mode='delta', which is "
                    "single-process; dumps across processes use the full "
                    "part format")
        if resume_from is not None and self.offload:
            raise ValueError(
                "fit(resume_from=) does not restore offloaded tables; "
                "restore them via their own persist lane first")
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
        # them counted twice; a wrapper hides the mark, so each refill also
        # checks whether the source recorded an entry of its own
        self_accounted = bool(getattr(batches, "ingest_accounted", False)
                              or getattr(it, "ingest_accounted", False))
        # the window: the batch about to step and pipeline_depth after it
        window: deque = deque()

        def refill() -> float:
            t0 = time.perf_counter()
            while len(window) <= self.pipeline_depth:
                nxt = next(it, None)
                if nxt is None:
                    break
                window.append(nxt)
            return time.perf_counter() - t0

        refill()   # the window's first fill: warm-up, unrecorded
        i = 0
        try:
            while self._window_agrees(window):
                if self.offload:
                    for b in window:
                        if not self._prep_started(b):
                            self._start_host_prepare(b)
                batch = window.popleft()
                pops0 = None if self_accounted \
                    else observability.ingest_stall_records()
                stall_s = refill()
                if not self_accounted \
                        and observability.ingest_stall_records() == pops0:
                    observability.record_ingest_stall(stall_s)
                # the chaos injection site for "kill the trainer between
                # two steps"
                sync_point("trainer.fit.step")
                # next_batch feeds the offload lookahead and the
                # pipelined prefetch
                kw = {"next_batch": window[0] if window else None} \
                    if self.offload or self._pipelined else {}
                state, last = self.train_step(state, batch, **kw)
                if retrace_budget is not None and guard is None and i >= 1:
                    guard = RetraceGuard(budget=retrace_budget,
                                         name="Trainer.fit steady state")
                    guard.__enter__()
                if persist_dir:
                    for name, table in self.offload.items():
                        if table.should_persist:
                            info = table.persist(state.emb[name],
                                                 f"{persist_dir}/{name}",
                                                 blocking=False)
                            if log_every:
                                log_fn(f"persisted {name}: {info}")
                if autosave_every and (i + 1) % autosave_every == 0:
                    self._autosave_fit(state, autosave_dir,
                                       base_cursor + i + 1)
                if log_every and (i + 1) % log_every == 0:
                    log_fn(f"step {i + 1}: loss={float(last['loss']):.5f}")
                i += 1
        except BaseException as e:
            if guard is not None:
                guard.__exit__(type(e), e, None)
            self._drain_suppressed()
            raise
        if guard is not None:
            try:
                guard.__exit__(None, None, None)
            except BaseException:
                self._drain_suppressed()
                raise
        # the last batch's pending overflow and any background persist
        # raise here, not later
        self._cancel_preps()
        for table in self.offload.values():
            table.finish()
        return state, last

    def _window_agrees(self, window) -> bool:
        """Whether ``fit``'s window holds a batch to step. On a mesh
        across processes every process must step the same count of
        batches (each step is collectives): the window's length is
        checked across them each turn, so a source that runs out on one
        process first raises on all."""
        if self.spans_processes:
            from . import distributed
            distributed.check_agree(
                len(window), "fit's window: every process's batch source "
                "must hold as many batches")
        return bool(window)

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
        of the batch sequence, so ``epoch`` is informational): the first
        into an unarmed directory is a full base, every later one a delta
        of the chunks the steps since marked, on one shard or a
        one-process mesh alike (a sharded variable's deltas hold its
        logical rows). It reads the state and changes none of its
        tensors."""
        from . import checkpoint as ckpt_mod
        step = int(state.step)
        extra = {"fit": {"step": step, "epoch": 0, "cursor": int(cursor)}}
        with scope.span("trainer.autosave", step=str(step)):
            ckpt_mod.save_checkpoint(
                path, self.collection, state.emb,
                dense_state=(state.params, state.opt_state),
                mode="delta", step=step, extra=extra)
