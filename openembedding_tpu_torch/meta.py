"""Model / variable metadata (copy of ``openembedding_tpu/meta.py``).

The JSON it reads and writes is the JAX package's, byte for byte, so a
checkpoint written by either package loads in the other.

A re-design of the original OpenEmbedding ``variable/Meta.h``: the same
logical metadata
(datatype, embedding_dim, vocabulary_size, model signature, per-variable list,
format version) round-tripped through JSON so checkpoints are self-describing,
but without the master-tree plumbing — metadata travels inside checkpoint
directories and in-process registries instead of a TCP master.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

# Checkpoint/meta format version. The reference uses "0.2"
# (variable/Meta.h:109-111); we start our own
# lineage at "tpu-1" to make cross-loading errors explicit.
# "tpu-2": per-variable storage dtypes recorded in extra["storage_dtypes"]
# so at-rest bf16 dumps (numpy-serialized as opaque '<V2' descrs, incl.
# through the compress.py-framed .npyz streams) decode under their TRUE
# dtype on load — and upcast transparently into f32 targets. Readers
# accept every version in META_COMPAT_VERSIONS: an old f32 "tpu-1"
# checkpoint loads unchanged.
META_FORMAT_VERSION = "tpu-2"
META_COMPAT_VERSIONS = ("tpu-1", "tpu-2")

# The reference treats vocabulary_size >= 2**63 as "unbounded key space ->
# use a hash table" (Meta.h:44-46). We keep the same convention.
UNBOUNDED_VOCAB = 2**63

_DTYPE_NAMES = {
    "float32": np.float32,
    "float64": np.float64,
    "bfloat16": None,  # no numpy dtype; the port maps it to torch.bfloat16
}


def normalize_dtype_name(dtype: Any) -> str:
    """Canonical string name for a supported embedding dtype."""
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported embedding dtype {name!r}; "
                         f"supported: {sorted(_DTYPE_NAMES)}")
    return name


@dataclasses.dataclass(frozen=True)
class EmbeddingVariableMeta:
    """Mirror of the reference's EmbeddingVariableMeta (Meta.h:20-60)."""

    datatype: str = "float32"
    embedding_dim: int = 0
    vocabulary_size: int = 0  # UNBOUNDED_VOCAB => hash table

    def __post_init__(self):
        object.__setattr__(self, "datatype", normalize_dtype_name(self.datatype))

    @property
    def use_hash_table(self) -> bool:
        return self.vocabulary_size >= UNBOUNDED_VOCAB

    def to_json(self) -> dict:
        return {
            "datatype": self.datatype,
            "embedding_dim": int(self.embedding_dim),
            "vocabulary_size": int(self.vocabulary_size),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "EmbeddingVariableMeta":
        return cls(datatype=obj["datatype"],
                   embedding_dim=int(obj["embedding_dim"]),
                   vocabulary_size=int(obj["vocabulary_size"]))


@dataclasses.dataclass(frozen=True)
class ModelVariableMeta:
    """Per-variable entry in a model meta (reference Meta.h:62-88)."""

    meta: EmbeddingVariableMeta
    variable_id: int
    name: str = ""

    def to_json(self) -> dict:
        out = self.meta.to_json()
        out["variable_id"] = int(self.variable_id)
        out["name"] = self.name
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "ModelVariableMeta":
        return cls(meta=EmbeddingVariableMeta.from_json(obj),
                   variable_id=int(obj["variable_id"]),
                   name=obj.get("name", ""))


class ModelStatus:
    """Serving model lifecycle states (reference Meta.h / ModelController)."""

    CREATING = "CREATING"
    NORMAL = "NORMAL"
    DELETING = "DELETING"
    ERROR = "ERROR"


@dataclasses.dataclass
class ModelMeta:
    """Model-level metadata: signature, variables, status.

    Mirrors the reference's ModelOfflineMeta/ModelMeta JSON (Meta.h:90-180):
    ``model_sign`` is the serving signature ("<uuid>-<version>"), the variable
    list is ordered by variable_id, and ``version`` guards format drift.
    """

    model_sign: str = ""
    model_uri: str = ""
    model_status: str = ModelStatus.NORMAL
    model_error: str = ""
    variables: list = dataclasses.field(default_factory=list)
    num_shards: int = 1
    version: str = META_FORMAT_VERSION
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "model_sign": self.model_sign,
            "model_uri": self.model_uri,
            "model_status": self.model_status,
            "model_error": self.model_error,
            "num_shards": int(self.num_shards),
            "variables": [v.to_json() for v in self.variables],
            "extra": self.extra,
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ModelMeta":
        version = obj.get("version", "")
        if version not in META_COMPAT_VERSIONS:
            raise ValueError(
                f"checkpoint meta version {version!r} is not one of "
                f"{META_COMPAT_VERSIONS} (writer newer than this reader?)")
        return cls(
            model_sign=obj.get("model_sign", ""),
            model_uri=obj.get("model_uri", ""),
            model_status=obj.get("model_status", ModelStatus.NORMAL),
            model_error=obj.get("model_error", ""),
            num_shards=int(obj.get("num_shards", 1)),
            variables=[ModelVariableMeta.from_json(v) for v in obj.get("variables", [])],
            version=version,
            extra=obj.get("extra", {}),
        )

    def dumps(self) -> str:
        # ensure_ascii=False: variable names go into file paths verbatim, so
        # the meta must carry the same UTF-8 bytes (the native loader reads
        # them raw, it does not decode \\u escapes)
        return json.dumps(self.to_json(), indent=2, sort_keys=True,
                          ensure_ascii=False)

    @classmethod
    def loads(cls, text: str) -> "ModelMeta":
        return cls.from_json(json.loads(text))
