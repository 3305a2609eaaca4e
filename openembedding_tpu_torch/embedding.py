"""Embedding specs and a collection of tables on one device
(``openembedding_tpu/embedding.py``).

``EmbeddingSpec`` keeps the JAX package's fields and validation, so a
model's spec list reads the same in both packages. ``EmbeddingCollection``
is the single-device case of the JAX collection: variable ids by
registration order, the same ``model_meta`` JSON, ``init`` and ``pull``,
for array tables and for hash tables (``input_dim=-1``) with ``"wide"``
pair keys or ``"int32"`` keys, and ``apply_gradients`` (the push) for
both. A hash pull gives a missing key its deterministic init row (zero
rows under ``read_only``, the serving contract) and the push inserts it.
``enable_dirty_tracking`` arms one chunk bitmap per variable
(``dirty.py``) for delta checkpoints: ``apply_gradients`` marks the
chunks its ids touch, and the ``Trainer`` marks each step's host batch.
A pooled spec (``pooling="sum" | "mean" | "sqrtn"``) takes padded ``[B,
L]`` id matrices (``[B, L, 2]`` pairs on a wide hash variable): the pull
pools its rows to ``[B, dim]`` and the push expands the pooled gradient
back (``ragged.py``). What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP.md item: ``key_dtype="int64"``,
the hot-row cache (``cache_k``), and every exchange plane but the
one-shard ``a2a``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .meta import (UNBOUNDED_VOCAB, EmbeddingVariableMeta, ModelMeta,
                   ModelVariableMeta)
from .optim.initializers import (fold_in, make_initializer, prng_key,
                                 threefry_key)
from .optim.optimizers import make_optimizer
from . import hash_table as hash_lib
from . import ragged
from . import table as table_lib
from .utils.device import DeviceLike, resolve_device

POOLINGS = ragged.POOLINGS
_LAYOUTS = ("mod", "div")
_PRECISIONS = ("f32", "bf16", "int8_ef")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for what a later slice of the port brings; ``item`` names
    its ROADMAP.md Queue 1 entry."""
    return NotImplementedError(
        f"{what} is not in the torch port yet (ROADMAP.md Queue 1, {item})")


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Static description of one embedding variable (the JAX package's
    ``EmbeddingSpec``, same fields and defaults)."""

    name: str
    input_dim: int                   # -1 => unbounded hash-key space
    output_dim: int
    dtype: str = "float32"
    optimizer: Any = None            # None => collection default
    initializer: Any = None          # None => collection default
    num_shards: int = -1             # -1 => one shard per device
    hash_capacity: int = 2**20
    layout: str = "mod"
    key_dtype: Optional[str] = None  # None resolves to "wide" for hash
    plane: str = "a2a"
    a2a_capacity: int = 0
    a2a_slack: float = 2.0
    cache_k: int = 0
    exchange_precision: str = "f32"
    push_precision: str = "f32"
    cache_refresh_every: int = 64
    cache_decay: float = 0.8
    pooling: Optional[str] = None

    def __post_init__(self):
        if self.key_dtype is None:
            object.__setattr__(self, "key_dtype",
                               "wide" if self.input_dim == -1 else "int32")
        if self.pooling is not None and self.pooling not in POOLINGS:
            raise ValueError(
                f"embedding {self.name!r}: unknown pooling "
                f"{self.pooling!r}; known: {POOLINGS}")
        if self.layout not in _LAYOUTS:
            raise ValueError(f"embedding {self.name!r}: unknown layout "
                             f"{self.layout!r}; known: {_LAYOUTS}")
        for knob in ("exchange_precision", "push_precision"):
            if getattr(self, knob) not in _PRECISIONS:
                raise ValueError(
                    f"embedding {self.name!r}: unknown {knob} "
                    f"{getattr(self, knob)!r}; known: {_PRECISIONS}")
        if self.use_hash and self.key_dtype == "int64":
            raise not_ported(f"hash variable {self.name!r} with "
                             "key_dtype='int64'", "int64 hash keys")
        if self.use_hash and self.key_dtype not in ("wide", "int32"):
            raise ValueError(f"embedding {self.name!r}: unknown key_dtype "
                             f"{self.key_dtype!r}; known: ('wide', "
                             "'int32', 'int64')")
        if self.plane != "a2a" or self.num_shards not in (-1, 1) \
                or self.exchange_precision != "f32" \
                or self.push_precision != "f32":
            raise not_ported(
                f"variable {self.name!r} on plane {self.plane!r} with "
                f"num_shards={self.num_shards}, precisions "
                f"{self.exchange_precision}/{self.push_precision}",
                "multi-shard exchange planes")
        if self.cache_k:
            raise not_ported(f"hot-row cache of {self.name!r} "
                             f"(cache_k={self.cache_k})",
                             "multi-shard exchange planes")

    @property
    def use_hash(self) -> bool:
        return self.input_dim == -1

    def meta(self) -> EmbeddingVariableMeta:
        vocab = UNBOUNDED_VOCAB if self.use_hash else self.input_dim
        return EmbeddingVariableMeta(datatype=self.dtype,
                                     embedding_dim=self.output_dim,
                                     vocabulary_size=vocab)


class EmbeddingCollection:
    """All sparse variables of one model, on one device.

    ``states`` (from :meth:`init` or ``checkpoint.load_checkpoint``) is a
    plain dict ``name -> TableState``. A spec without an optimizer gets
    ``default_optimizer``, ``{"category": "sgd", "learning_rate": 0.01}``
    unless given, as in the JAX collection.
    """

    num_shards = 1

    def __init__(self, specs, device: DeviceLike = None,
                 default_optimizer: Any = None,
                 default_initializer: Any = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        self.seed = int(seed)
        if default_optimizer is None:
            default_optimizer = {"category": "sgd", "learning_rate": 0.01}
        if default_initializer is None:
            default_initializer = dict(table_lib.DEFAULT_INITIALIZER)
        self.specs: Dict[str, EmbeddingSpec] = {}
        self._variable_ids: Dict[str, int] = {}
        self._optimizers = {}
        self._initializers = {}
        self._dirty_trackers: Dict[str, Any] = {}
        for i, spec in enumerate(specs):
            if spec.name in self.specs:
                raise ValueError(f"duplicate embedding name {spec.name!r}")
            self.specs[spec.name] = spec
            self._variable_ids[spec.name] = i
            self._optimizers[spec.name] = make_optimizer(
                spec.optimizer if spec.optimizer is not None
                else default_optimizer)
            self._initializers[spec.name] = make_initializer(
                spec.initializer if spec.initializer is not None
                else default_initializer)

    # --- introspection -----------------------------------------------------
    def variable_id(self, name: str) -> int:
        return self._variable_ids[name]

    def optimizer(self, name: str):
        return self._optimizers[name]

    def initializer(self, name: str):
        return self._initializers[name]

    def model_meta(self, model_sign: str = "",
                   model_uri: str = "") -> ModelMeta:
        variables = [
            ModelVariableMeta(meta=self.specs[name].meta(),
                              variable_id=self._variable_ids[name],
                              name=name)
            for name in self.specs
        ]
        variables.sort(key=lambda v: v.variable_id)
        meta = ModelMeta(model_sign=model_sign, model_uri=model_uri,
                         variables=variables, num_shards=self.num_shards)
        meta.extra["variable_num_shards"] = {
            name: self.num_shards for name in self.specs}
        poolings = {name: s.pooling for name, s in self.specs.items()
                    if s.pooling}
        if poolings:
            # serving rebuilds its specs from the meta alone, combiners too
            meta.extra["variable_pooling"] = poolings
        return meta

    # --- dirty tracking (delta checkpoints) ---------------------------------
    def enable_dirty_tracking(self, *, target_chunks: int = 1024,
                              names=None) -> None:
        """Arm chunk-level dirty bitmaps for every variable (idempotent),
        or for the variables in ``names`` (an unknown name raises
        ``ValueError``): about ``target_chunks`` chunks of contiguous rows
        an array variable, ``min(target_chunks, hash_capacity)`` key
        chunks a hash variable, as in JAX. Required before
        ``checkpoint.save_checkpoint(mode="delta")``, which writes only
        the marked chunks. A delta save writes tracked variables only: an
        untracked variable that trains reverts to its base rows on a
        restore. A loop that runs its own pushes without
        :meth:`apply_gradients` must call :meth:`mark_dirty` with each
        step's ids, as ``Trainer.train_step`` does."""
        from .dirty import make_array_tracker, make_hash_tracker
        if names is not None:
            unknown = set(names) - set(self.specs)
            if unknown:
                raise ValueError(
                    f"enable_dirty_tracking: unknown variable(s) "
                    f"{sorted(unknown)}; known: {sorted(self.specs)}")
        for name, spec in self.specs.items():
            if name in self._dirty_trackers:
                continue
            if names is not None and name not in names:
                continue
            if spec.use_hash:
                self._dirty_trackers[name] = make_hash_tracker(
                    name, spec.hash_capacity, target_chunks)
            else:
                self._dirty_trackers[name] = make_array_tracker(
                    name, spec.input_dim, target_chunks)

    @property
    def dirty_trackers(self) -> Dict[str, Any]:
        """``name -> DirtyTracker`` (empty unless tracking is enabled)."""
        return self._dirty_trackers

    def mark_dirty(self, sparse_inputs: Dict[str, Any]) -> None:
        """Mark the chunks a batch's pushes touch, from its ids (numpy
        arrays or tensors; a no-op unless tracking is enabled). Over-
        marking is safe. Hash keys are the joined 64-bit values of wide
        pairs (``hash_table.join64``) or the ids themselves; array ids
        outside ``[0, input_dim)`` are dropped. Ids on a CUDA device are
        read back (a synchronization); nothing is marked while a CUDA
        graph is captured, where the push runs once per capture, not
        once per replay: the ``Trainer`` marks its host batch after each
        step instead."""
        if not self._dirty_trackers:
            return
        for name, idx in sparse_inputs.items():
            tracker = self._dirty_trackers.get(name)
            if tracker is None or idx is None:
                continue
            if isinstance(idx, torch.Tensor):
                if idx.is_cuda and torch.cuda.is_current_stream_capturing():
                    continue
                idx = idx.detach().cpu().numpy()
            arr = np.asarray(idx)
            spec = self.specs[name]
            if spec.use_hash:
                if spec.key_dtype == "wide" and arr.ndim >= 2 \
                        and arr.shape[-1] == 2:
                    keys = hash_lib.join64(arr.reshape(-1, 2))
                else:
                    keys = arr.astype(np.int64).ravel()
                tracker.mark_keys(keys)
            else:
                ids = arr.astype(np.int64).ravel()
                tracker.mark_rows(ids[(ids >= 0) & (ids < spec.input_dim)])

    # --- state lifecycle ---------------------------------------------------
    def variable_key(self, name: str, rng=None) -> Tuple[int, int]:
        """The threefry key of variable ``name`` under the collection key
        ``rng`` (None: ``PRNGKey(seed)``): ``fold_in(rng, variable_id)``,
        the JAX collection's rule. A hash variable keeps it as its init
        key (one for all shards); an array table draws from
        :meth:`table_key`."""
        rng = prng_key(self.seed) if rng is None else threefry_key(rng)
        return fold_in(rng, self._variable_ids[name])

    def table_key(self, name: str, rng=None) -> Tuple[int, int]:
        """The key array variable ``name``'s weights are drawn from:
        :meth:`variable_key` folded with shard 0, as the JAX collection's
        one-shard table draws (``parallel/sharded_table.py``)."""
        return fold_in(self.variable_key(name, rng), 0)

    def hash_init_rng(self, name: str, rng=None) -> Tuple[int, int]:
        """The threefry key of hash variable ``name``'s init rows
        (:meth:`variable_key`), so a port collection initialized with
        ``rng`` draws the rows of JAX's ``collection.init(rng)``."""
        return self.variable_key(name, rng)

    def init(self, rng=None, only: Optional[Any] = None) -> Dict[str, Any]:
        """Materialize every variable (``only`` restricts to some names),
        with JAX's signature and keys: ``rng`` is a threefry key (two
        uint32 words, ``prng_key(seed)``; None: ``prng_key(self.seed)``).
        Array tables draw from :meth:`table_key`, the same values on every
        device and as JAX's ``collection.init(rng)`` on one shard. Hash
        variables start empty, ``round_capacity(hash_capacity)`` slots,
        with :meth:`hash_init_rng` as their init key."""
        states = {}
        for name, spec in self.specs.items():
            if only is not None and name not in only:
                continue
            if spec.use_hash:
                states[name] = hash_lib.create_hash_table(
                    spec.meta(), self._optimizers[name],
                    capacity=spec.hash_capacity,
                    rng=self.hash_init_rng(name, rng),
                    key_dtype=spec.key_dtype, device=self.device)
                continue
            states[name] = table_lib.create_table(
                spec.meta(), self._optimizers[name],
                self._initializers[name], rng=self.table_key(name, rng),
                device=self.device)
        return states

    # --- data plane --------------------------------------------------------
    def pull(self, states: Dict[str, Any], inputs: Dict[str, Any], *,
             batch_sharded: bool = True, read_only: bool = False,
             serving_rows: bool = False) -> Dict[str, torch.Tensor]:
        """Rows for every input column: ``name -> rows``, shaped
        ``indices.shape + (dim,)`` (``indices.shape[:-1] + (dim,)`` for
        pair keys on a wide hash variable); a pooled variable's ``[B, L]``
        sequences (``[B, L, 2]`` pairs) pool to ``[B, dim]``.

        Inputs are integer tensors or numpy arrays of any shape; they move
        to the collection's device. A hash variable gives a missing key
        its deterministic init row, or a zero row under ``read_only`` (the
        serving contract). ``serving_rows`` selects the serving plane's
        row contract, as in JAX: one row per id, no pooling, and any
        trailing dim of 2 on a wide variable is a pair axis.
        ``batch_sharded`` keeps the JAX signature and selects nothing on
        one device.
        """
        del batch_sharded
        pair_ndim = 2 if serving_rows else None
        rows = {}
        for name, idx in inputs.items():
            spec = self.specs[name]
            idx = self.to_device(name, idx, pair_ndim)
            if spec.use_hash:
                r = hash_lib.pull(
                    states[name], idx,
                    None if read_only else self._initializers[name])
            else:
                r = table_lib.pull(states[name], idx)
            if spec.pooling and not serving_rows:
                r = self._pool(spec, r, idx)
            rows[name] = r
        return rows

    def _pool_args(self, spec: EmbeddingSpec) -> dict:
        """``ragged.pool_rows``' key-space arguments for a pooled spec."""
        return {"pad_id": ragged.pad_id_for(spec),
                "vocab": None if spec.use_hash else spec.input_dim,
                "wide": spec.use_hash and spec.key_dtype == "wide"}

    def _pool(self, spec: EmbeddingSpec, rows: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
        return ragged.pool_rows(rows, idx, spec.pooling,
                                **self._pool_args(spec))

    def apply_gradients(self, states: Dict[str, Any],
                        inputs: Dict[str, Any],
                        row_grads: Dict[str, torch.Tensor], *,
                        batch_sharded: bool = True,
                        mark: bool = True) -> Dict[str, Any]:
        """Push and update every column present in ``row_grads``, in place.

        ``row_grads[name]`` has the shape of the pulled rows and
        ``inputs[name]`` the ids they were pulled for; a pooled variable's
        ``[B, dim]`` gradient is expanded over its sequence slots first
        (``ragged.expand_pooled_grads``; padding slots hold invalid ids,
        which the push drops). Array tables run ``table.apply_gradients``
        (dedup, combine, update the touched rows and slots, scatter back),
        hash tables ``hash_table.apply_gradients`` (the same, inserting
        missing keys with their init rows); the other variables' states
        are not touched. Returns ``states``. With dirty tracking armed the
        push marks its ids' chunks first (:meth:`mark_dirty`); ``mark=
        False`` leaves that to the caller (the ``Trainer``'s step, which
        marks its host batch outside the step program, as JAX marks
        outside its jit).
        """
        del batch_sharded
        if mark:
            self.mark_dirty({n: inputs.get(n) for n in row_grads})
        for name, g in row_grads.items():
            spec = self.specs[name]
            idx = self.to_device(name, inputs[name])
            if spec.pooling:
                g = ragged.expand_pooled_grads(g, idx, spec.pooling,
                                               **self._pool_args(spec))
            if spec.use_hash:
                hash_lib.apply_gradients(states[name], self._optimizers[name],
                                         self._initializers[name], idx, g)
            else:
                table_lib.apply_gradients(states[name],
                                          self._optimizers[name], idx, g)
        return states

    def host_ids(self, name: str, idx,
                 pair_ndim: Optional[int] = None) -> torch.Tensor:
        """Input column ``name`` as an integer tensor where it lies (a host
        array becomes a CPU tensor of its own), host int64 ids of a hash
        variable widened on the host (:meth:`_widen`). The host's half of
        :meth:`to_device`."""
        spec = self.specs[name]
        idx = self._widen(spec, idx, pair_ndim)
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.array(idx, copy=True))
        if idx.dtype.is_floating_point or idx.dtype == torch.bool:
            raise TypeError(f"{spec.name!r}: indices must be integers, got "
                            f"{idx.dtype}")
        return idx

    def to_device(self, name: str, idx,
                  pair_ndim: Optional[int] = None) -> torch.Tensor:
        """Input column ``name`` as an integer tensor on the collection's
        device (a copy that does not wait for the device), pair-widened
        for a wide hash variable. ``pair_ndim``: as in :meth:`_widen`."""
        spec = self.specs[name]
        idx = self.host_ids(name, idx, pair_ndim).to(self.device,
                                                     non_blocking=True)
        if spec.use_hash and spec.key_dtype == "wide" and not _is_pairs(
                idx, self._pair_ndim(spec, pair_ndim)):
            idx = hash_lib.widen_ids(idx)
        return idx

    @staticmethod
    def _pair_ndim(spec: EmbeddingSpec, pair_ndim: Optional[int]) -> int:
        """The least ndim at which a trailing dim of 2 is a pair axis:
        ``pair_ndim`` if given, else 3 for a pooled spec (its ``[B, L=2]``
        matrices are sequences) and 2 otherwise, the JAX rule."""
        if pair_ndim is not None:
            return pair_ndim
        return 3 if spec.pooling else 2

    def _widen(self, spec: EmbeddingSpec, idx,
               pair_ndim: Optional[int] = None):
        """Host int64 ids for a hash variable, before they move to the
        device: (lo, hi) pairs for a wide variable, int32 for an int32 one;
        every other input passes.

        The JAX collection's rule (``EmbeddingCollection._widen``): a
        trailing dim of 2 is a pair axis from ndim ``pair_ndim`` on
        (:meth:`_pair_ndim`: 3 for a pooled spec, 2 otherwise; the serving
        row plane passes 2, its queries being flat pair lists). Host int64
        ids split on the host (``hash_table.split64``); host pair words
        typed int64, and int64 ids for an int32-key table, must fit int32,
        never wrap. Narrow ids that reach the device widen there
        (``hash_table.widen_ids``, in :meth:`to_device`).
        """
        if not spec.use_hash or isinstance(idx, torch.Tensor):
            return idx
        arr = np.asarray(idx)
        if arr.dtype.kind not in "iu" or arr.dtype.itemsize != 8:
            return arr
        if spec.key_dtype == "wide" and not _is_pairs(
                arr, self._pair_ndim(spec, pair_ndim)):
            return hash_lib.split64(arr)
        if arr.size and (arr.max() > np.iinfo(np.int32).max
                         or arr.min() < np.iinfo(np.int32).min):
            raise ValueError(
                f"embedding {spec.name!r}: ids exceed int32 — pass "
                "hash_table.split64(ids) pairs to a key_dtype='wide' "
                "variable, not raw 64-bit ids")
        return arr.astype(np.int32)


def _is_pairs(idx, pair_ndim: int) -> bool:
    """A trailing pair axis at ``pair_ndim`` dims or more."""
    return idx.ndim >= pair_ndim and idx.shape[-1] == 2
