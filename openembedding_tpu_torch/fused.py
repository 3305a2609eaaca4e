"""Fused feature groups: many categorical features, one table, one gather
(``openembedding_tpu/fused.py``).

Bounded vocabs: feature ``f``'s id ``i`` maps to ``offset[f] + i`` in the
fused row space, the concatenation of the member vocabs; out-of-range ids
map to ``-1`` and pull as zero rows. Hash fusion (``vocab_sizes=-1``):
feature ``f``'s id ``k`` maps to the key ``k * F + f`` (int64, wrapping),
carried as (lo, hi) int32 pairs for ``key_dtype="wide"`` or mixed down to
31 bits for ``"int32"``. ``make_fused_specs`` builds the dim-k table and
its dim-1 ``:linear`` twin exactly as the JAX package does; a hash group
with ``key_dtype="int64"`` raises ``NotImplementedError`` when its specs
are built.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np

from .data.criteo import mix64
from .embedding import EmbeddingSpec
from .hash_table import empty_key, split64

FUSED_NAME = "fields"
LINEAR_SUFFIX = ":linear"


def segment_offsets(sizes: Sequence[int]) -> Tuple[int, ...]:
    """Exclusive prefix sums over per-segment sizes (plus the total)."""
    out = [0]
    for s in sizes:
        out.append(out[-1] + int(s))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FusedMapper:
    """Static map from per-feature id columns to fused table ids."""

    feature_names: Tuple[str, ...]
    vocab_sizes: Tuple[int, ...]        # -1 everywhere => hash fusion
    name: str = FUSED_NAME
    need_linear: bool = True
    key_dtype: str = "wide"

    @property
    def use_hash(self) -> bool:
        return self.vocab_sizes[0] == -1

    @property
    def num_features(self) -> int:
        return len(self.feature_names)

    @property
    def offsets(self) -> np.ndarray:
        return np.asarray(segment_offsets(self.vocab_sizes)[:-1],
                          dtype=np.int64)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    def fuse(self, sparse: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Per-feature columns -> ``{name: [B, F] fused ids}`` (+ the
        ``:linear`` copy); ``[B, F, 2]`` pairs for a wide hash group.
        Host-side numpy, like the JAX package's."""
        ids = np.stack([np.asarray(sparse[f]) for f in self.feature_names],
                       axis=1)  # [B, F]
        if self.use_hash:
            fused = self._fuse_hash(ids)
        else:
            vocab = np.asarray(self.vocab_sizes, dtype=np.int64)[None, :]
            valid = (ids >= 0) & (ids < vocab)
            fused = np.where(valid, ids + self.offsets[None, :], -1)
            fused = fused.astype(np.int32 if self.total_vocab < 2**31
                                 else np.int64)
        out = {self.name: fused}
        if self.need_linear:
            out[self.name + LINEAR_SUFFIX] = fused
        return out

    def _fuse_hash(self, ids: np.ndarray) -> np.ndarray:
        """``k * F + f`` keys (int64 arithmetic, wrapping) in the group's
        key encoding."""
        fused = ids.astype(np.int64) * np.int64(self.num_features) \
            + np.arange(self.num_features, dtype=np.int64)[None, :]
        if self.key_dtype == "wide":
            # the pair encoding excludes hi == INT32_MIN (the EMPTY band);
            # keys that wrap into it move up one hi step, as in the JAX
            # package (a 2^-32 alias band)
            pairs = split64(fused)
            band = pairs[..., 1] == empty_key(np.int32)
            pairs[..., 1][band] = empty_key(np.int32) + 1
            return pairs
        if ids.dtype == np.int32:
            # mix before keeping 31 bits: F shares a factor with 2^31, so a
            # plain mask would alias features onto rows in a pattern
            return (mix64(fused) & np.uint64(2**31 - 1)).astype(np.int32)
        return fused.astype(ids.dtype)

    def fuse_batch(self, batch: Dict) -> Dict:
        return {**batch, "sparse": self.fuse(batch["sparse"])}


def make_fused_specs(feature_names: Sequence[str],
                     vocab_sizes,
                     embedding_dim: int,
                     *,
                     name: str = FUSED_NAME,
                     need_linear: bool = True,
                     dtype: str = "float32",
                     optimizer: Any = None,
                     initializer: Any = None,
                     key_dtype: str = "wide",
                     **spec_kwargs) -> Tuple[Tuple[EmbeddingSpec, ...],
                                             FusedMapper]:
    """Specs + mapper for one fused table over ``feature_names``.

    ``vocab_sizes``: per-feature ints or a single int. Returns (specs,
    mapper): one dim-k spec named ``name`` (normal(0, 1e-4) init unless
    ``initializer`` is given) plus, with ``need_linear``, one dim-1
    ``name:linear`` spec initialized to zero. ``spec_kwargs`` pass through
    to every ``EmbeddingSpec`` (the JAX signature's plane and hash knobs).
    """
    if isinstance(vocab_sizes, int):
        vocab_sizes = [vocab_sizes] * len(feature_names)
    if len(vocab_sizes) != len(feature_names):
        raise ValueError("vocab_sizes must match feature_names")
    hash_members = [v == -1 for v in vocab_sizes]
    if any(hash_members) and not all(hash_members):
        raise ValueError("cannot fuse hash (-1) and bounded vocabs in one "
                         "group; make two groups")
    mapper = FusedMapper(feature_names=tuple(feature_names),
                         vocab_sizes=tuple(int(v) for v in vocab_sizes),
                         name=name, need_linear=need_linear,
                         key_dtype=key_dtype)
    input_dim = -1 if mapper.use_hash else mapper.total_vocab
    emb_init = initializer or {"category": "normal", "mean": 0.0,
                               "stddev": 1e-4}
    specs = [EmbeddingSpec(
        name=name, input_dim=input_dim, output_dim=embedding_dim,
        dtype=dtype, optimizer=optimizer, initializer=emb_init,
        key_dtype=key_dtype, **spec_kwargs)]
    if need_linear:
        specs.append(EmbeddingSpec(
            name=name + LINEAR_SUFFIX, input_dim=input_dim,
            output_dim=1, dtype=dtype, optimizer=optimizer,
            initializer={"category": "constant", "value": 0.0},
            key_dtype=key_dtype, **spec_kwargs))
    return tuple(specs), mapper
