"""Serving-side model registry (``openembedding_tpu/serving/registry.py``).

Loads a checkpoint for serving and answers read-only lookups: models are
keyed by ``model_sign``, carry CREATING/NORMAL/DELETING/ERROR status, load
synchronously or on a thread (CREATING while it runs), and a lookup takes
one snapshot of the model's states per request. Every lookup is a pull on
the registry's device: through the CUDA row-gather kernel
(``ops/gather.py``) for an array variable, through the CUDA probe-gather
kernel (``ops/probe_gather.py``) for a hash variable, whose table the load
fills by inserting the dump's rows. Wide hash variables take ``[..., 2]``
int32 (lo, hi) pair queries or narrow ids, which the lookup widens. Shard
slices, delta hot-swaps and micro-batching are later slices and raise
``NotImplementedError`` when asked for.
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Dict, List, Optional

import torch

from .. import checkpoint as ckpt_lib
from ..embedding import EmbeddingCollection, EmbeddingSpec, not_ported
from ..meta import ModelMeta, ModelStatus, UNBOUNDED_VOCAB
from ..utils import fs
from ..utils.device import DeviceLike, resolve_device


class ServingModel:
    """One loaded model: collection + read-only states."""

    def __init__(self, sign: str, collection: EmbeddingCollection,
                 states: Dict[str, Any], meta: ModelMeta, version: int = 0):
        self.sign = sign
        self.collection = collection
        self.states = states
        self.meta = meta
        self.version = int(version)
        self._by_id = {collection.variable_id(name): name
                       for name in collection.specs}

    def variable_name(self, variable_id: int) -> str:
        return self._by_id[variable_id]

    def lookup(self, variable: Any, indices) -> torch.Tensor:
        """Read-only pull for one variable (by name or variable_id), on the
        model's device: zero rows for ids outside ``[0, input_dim)`` and
        for hash keys the table does not hold.

        The JAX registry's shape contract, which reads the sequence axis,
        never the pooled spec's training rule:

        - a flat query (narrow ``[n]`` ids, or ``[n, 2]`` pairs on a wide
          hash variable) returns one row per id, never pooled;
        - a sequence query on a pooled variable (``[B, L]``, or ``[B, L,
          2]`` pairs on a wide one) returns the pooled ``[B, dim]`` rows.

        On a wide variable any trailing dim of 2 is a pair axis, so a
        narrow ``[B, 2]`` sequence reads as ``B`` pairs: send such
        sequences padded to another length, or as ``[B, 2, 2]`` pairs."""
        name = (variable if isinstance(variable, str)
                else self._by_id[int(variable)])
        if name not in self.collection.specs:
            raise KeyError(f"model {self.sign!r} has no variable {name!r}")
        spec = self.collection.specs[name]
        # ONE reference grab = one consistent version of the states
        states = self.states
        idx = self.collection.to_device(name, indices, pair_ndim=2)
        seq_ndim = 3 if spec.use_hash and spec.key_dtype == "wide" else 2
        as_rows = spec.pooling is None or idx.dim() < seq_ndim
        rows = self.collection.pull(states, {name: idx},
                                    batch_sharded=False, read_only=True,
                                    serving_rows=as_rows)
        return rows[name]


def _specs_from_meta(meta: ModelMeta,
                     hash_capacity: int) -> List[EmbeddingSpec]:
    """Rebuild EmbeddingSpecs from a checkpoint's model_meta alone, with
    the stateless ``default`` optimizer (serving allocates and loads no
    slot tensors) and the combiners of ``variable_pooling``. Hash capacity and key dtype come from the meta's
    ``hash_variables`` extra where the dump recorded them, else
    ``hash_capacity`` and ``"int32"``, as in the JAX registry."""
    hash_info = meta.extra.get("hash_variables", {})
    poolings = meta.extra.get("variable_pooling", {})
    specs = []
    for v in sorted(meta.variables, key=lambda v: v.variable_id):
        hash_var = v.meta.vocabulary_size >= UNBOUNDED_VOCAB
        info = hash_info.get(v.name, {})
        specs.append(EmbeddingSpec(
            name=v.name, input_dim=-1 if hash_var else v.meta.vocabulary_size,
            output_dim=v.meta.embedding_dim, dtype=v.meta.datatype,
            optimizer={"category": "default"},
            hash_capacity=int(info.get("hash_capacity", hash_capacity)),
            key_dtype=info.get("key_dtype", "int32"),
            pooling=poolings.get(v.name)))
    return specs


class ModelRegistry:
    """All models served by this process, on one device (cuda unless the
    caller names another). ``default_hash_capacity`` sizes the hash tables
    of a dump that did not record its own."""

    def __init__(self, device: DeviceLike = None, *,
                 default_hash_capacity: int = 2**20):
        self.device = resolve_device(device)
        self.default_hash_capacity = default_hash_capacity
        self._lock = threading.Lock()
        self._models: Dict[str, ServingModel] = {}
        self._status: Dict[str, Dict[str, Any]] = {}
        # async create_model load threads, joined by close()
        self._loaders: Dict[str, threading.Thread] = {}

    def create_model(self, model_uri: str, *,
                     model_sign: Optional[str] = None,
                     replica_num: int = 3, num_shards: int = -1,
                     shard_index: int = 0, shard_count: int = 1,
                     block: bool = True) -> str:
        """Load a checkpoint for serving; returns the model_sign. With
        ``block=False`` the load runs on a thread and the status is
        CREATING until it ends in NORMAL or ERROR."""
        if shard_count > 1:
            raise not_ported("serving a shard slice (shard_count > 1)",
                             "multi-shard exchange planes")
        if num_shards not in (-1, 1):
            raise not_ported(f"num_shards={num_shards}",
                             "multi-shard exchange planes")
        with fs.open_file(fs.join(model_uri, ckpt_lib.MODEL_META_FILE),
                          "rb") as f:
            meta = ModelMeta.loads(f.read().decode("utf-8"))
        sign = model_sign or meta.model_sign or model_uri
        with self._lock:
            if sign in self._status and self._status[sign][
                    "model_status"] == ModelStatus.CREATING:
                raise ValueError(f"model {sign!r} is already being created")
            self._status[sign] = {
                "model_sign": sign, "model_uri": model_uri,
                "model_status": ModelStatus.CREATING, "model_error": "",
                "replica_num": replica_num,
                "shard_index": shard_index, "shard_count": shard_count,
            }

        def _load():
            try:
                coll = EmbeddingCollection(
                    _specs_from_meta(meta, self.default_hash_capacity),
                    device=self.device)
                load_info: Dict[str, Any] = {}
                states = ckpt_lib.load_checkpoint(model_uri, coll,
                                                  info=load_info)
                if self.device.type == "cuda":
                    # a failed copy must surface here, as an ERROR
                    # status, not under the first lookup
                    torch.cuda.synchronize(self.device)
                model = ServingModel(sign, coll, states, meta,
                                     version=load_info["applied_seq"])
                with self._lock:
                    self._models[sign] = model
                    self._status[sign]["model_status"] = ModelStatus.NORMAL
                    self._status[sign]["version"] = model.version
            except Exception as e:  # noqa: BLE001 — recorded as ERROR status
                with self._lock:
                    self._status[sign]["model_status"] = ModelStatus.ERROR
                    self._status[sign]["model_error"] = (
                        f"{e}\n{traceback.format_exc()}")
            finally:
                me = threading.current_thread()
                with self._lock:
                    if self._loaders.get(sign) is me:
                        del self._loaders[sign]

        if block:
            _load()
            with self._lock:
                status = dict(self._status[sign])
            if status["model_status"] == ModelStatus.ERROR:
                raise RuntimeError(status["model_error"])
        else:
            t = threading.Thread(target=_load, daemon=True,
                                 name=f"oe-model-load-{sign}")
            with self._lock:
                self._loaders[sign] = t
                t.start()
        return sign

    def lookup(self, sign: str, variable: Any, indices) -> torch.Tensor:
        """Serve one lookup against a NORMAL model."""
        return self.find_model(sign).lookup(variable, indices)

    def enable_batching(self, **_kwargs) -> None:
        raise not_ported("micro-batched serving", "serving micro-batching")

    def apply_delta(self, sign: str, delta) -> Dict[str, Any]:
        raise not_ported("delta hot-swap",
                         "delta checkpoints and other layouts")

    def join_loads(self, timeout: float = 60.0) -> None:
        with self._lock:
            loaders, self._loaders = dict(self._loaders), {}
        for t in loaders.values():
            t.join(timeout)

    def close(self, timeout: float = 60.0) -> None:
        """Join outstanding async loads."""
        self.join_loads(timeout)

    def delete_model(self, sign: str) -> None:
        with self._lock:
            if sign not in self._status:
                raise KeyError(sign)
            self._status[sign]["model_status"] = ModelStatus.DELETING
            self._models.pop(sign, None)
            del self._status[sign]

    def find_model(self, sign: str) -> ServingModel:
        """NORMAL-status model, KeyError when unknown, RuntimeError while
        it is CREATING or after a failed load."""
        with self._lock:
            st = self._status.get(sign)
            if st is None:
                raise KeyError(f"unknown model {sign!r}")
            if st["model_status"] != ModelStatus.NORMAL:
                raise RuntimeError(
                    f"model {sign!r} is {st['model_status']}: "
                    f"{st.get('model_error', '')}")
            return self._models[sign]

    def show_model(self, sign: str) -> Dict[str, Any]:
        with self._lock:
            if sign not in self._status:
                raise KeyError(sign)
            return dict(self._status[sign])

    def show_models(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._status.values()]
