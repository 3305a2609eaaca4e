"""Variable-length sequence features: padding and pooling
(``openembedding_tpu/ragged.py``).

A sequence feature is a padded ``[B, L]`` id matrix (``[B, L, 2]`` pairs
on a wide hash variable). Padding slots hold an invalid id (``pad_id_for``):
``-1`` for array tables, the EMPTY sentinel for hash variables, so the
pull gives them zero rows and the push drops their gradients with no
mask of its own. Pooling is declared on the spec
(``EmbeddingSpec(pooling="mean")``): ``EmbeddingCollection.pull`` reduces
``[B, L, dim]`` rows to ``[B, dim]`` with :func:`pool_rows`, and
``apply_gradients`` expands the pooled gradient back with
:func:`expand_pooled_grads`, its VJP.

``sum`` adds the rows; ``mean`` divides the sum by the number of valid
ids (at least 1); ``sqrtn`` by its square root. The operations and their
order are those XLA runs for the JAX package on the CPU (a sequential
sum, then one division in the rows' dtype), so the port's pooled rows
equal JAX's bit for bit there, for sequences of up to 32 ids, but for
``sqrtn`` on ``dim`` 1 rows: there XLA's simplifier turns the division
by ``sqrt(n)`` into a product with its ``rsqrt``, the processor's
approximation, and the two differ by an ulp or two.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from . import hash_table as hash_lib

POOLINGS = ("sum", "mean", "sqrtn")


def pad_id_for(spec) -> int:
    """The padding id of one ``EmbeddingSpec``'s key space: ``-1`` for an
    array table, the EMPTY sentinel (the key dtype's minimum) for a hash
    variable. A wide variable pads with EMPTY hi words: a ``[B, L, 2]``
    matrix's padding slots are ``(EMPTY, EMPTY)`` pairs, and a narrow
    ``[B, L]`` matrix padded with it widens to them."""
    if spec.use_hash:
        return hash_lib.empty_key(
            np.int32 if spec.key_dtype == "wide" else np.dtype(spec.key_dtype))
    return -1


def pad_ragged(sequences: Iterable[Sequence[int]],
               max_len: Optional[int] = None,
               pad_id: int = -1,
               dtype=np.int32) -> np.ndarray:
    """Host: variable-length id lists -> a ``[B, L]`` padded matrix. A
    sequence longer than ``max_len`` keeps its last ``max_len`` ids
    (histories truncate from the front). ``pad_id`` must fit ``dtype``."""
    info = np.iinfo(np.dtype(dtype))
    if not (info.min <= pad_id <= info.max):
        raise ValueError(
            f"pad_id {pad_id} does not fit dtype {np.dtype(dtype)} — for "
            "int64-keyed hash features pass dtype=np.int64 (numpy would "
            "silently wrap the sentinel onto a valid key)")
    seqs = [np.asarray(s, dtype=dtype).ravel() for s in sequences]
    if max_len is None:
        max_len = max((s.size for s in seqs), default=1) or 1
    out = np.full((len(seqs), max_len), pad_id, dtype=dtype)
    for i, s in enumerate(seqs):
        if s.size > max_len:
            s = s[-max_len:]
        out[i, :s.size] = s
    return out


def pad_ragged_wide(sequences: Iterable[Sequence[int]],
                    max_len: Optional[int] = None) -> np.ndarray:
    """Host: variable-length int64 id lists -> a ``[B, L, 2]`` int32 pair
    matrix (``hash_table.split64`` per id), padded with ``(EMPTY, EMPTY)``
    pairs. Ids whose hi word would be EMPTY (``[-2^63, -2^63 + 2^32)``)
    would read as padding, so they raise."""
    empty = hash_lib.empty_key(np.int32)
    seqs = [np.asarray(s, dtype=np.int64).ravel() for s in sequences]
    if max_len is None:
        max_len = max((s.size for s in seqs), default=1) or 1
    out = np.full((len(seqs), max_len, 2), empty, dtype=np.int32)
    for i, s in enumerate(seqs):
        if s.size > max_len:
            s = s[-max_len:]
        if s.size:
            pairs = hash_lib.split64(s)
            banded = pairs[:, 1] == empty
            if banded.any():
                raise ValueError(
                    f"sequence {i}: {int(banded.sum())} id(s) fall in the "
                    "wide-key EMPTY band (ids in [-2^63, -2^63+2^32)); "
                    "the pair encoding excludes that range")
            out[i, :s.size] = pairs
    return out


def valid_mask(ids: torch.Tensor, pad_id: int,
               vocab: Optional[int] = None,
               wide: bool = False) -> torch.Tensor:
    """``[B, L]`` bool: the slots that hold a real id (the pull's validity
    rule). ``wide``: ids are ``[B, L, 2]`` pairs, invalid where the hi
    word is EMPTY."""
    if wide:
        return ids[..., 1] != pad_id
    if vocab is not None and pad_id == -1:
        return (ids >= 0) & (ids < vocab)
    return ids != pad_id


def seq_lengths(ids: torch.Tensor, pad_id: int,
                vocab: Optional[int] = None,
                wide: bool = False) -> torch.Tensor:
    """``[B]`` valid ids per row, at least 1 (a divisor)."""
    n = valid_mask(ids, pad_id, vocab, wide).sum(-1)
    return torch.clamp_min(n, 1)


def _divide(x: torch.Tensor, pooling: str, ids: torch.Tensor, pad_id: int,
            vocab: Optional[int], wide: bool) -> torch.Tensor:
    """``x`` (``[B, dim]``) over the pooling's ``[B, 1]`` divisor, JAX's
    ``x / scale``: ``sum`` divides by one (exact, so skipped), ``mean`` by
    the lengths, ``sqrtn`` by their square root."""
    if pooling == "sum":
        return x
    n = seq_lengths(ids, pad_id, vocab, wide).to(x.dtype)[:, None]
    return x / (n if pooling == "mean" else torch.sqrt(n))


def _check(pooling: str) -> None:
    if pooling not in POOLINGS:
        raise ValueError(f"unknown pooling {pooling!r}; known: {POOLINGS}")


def pool_rows(rows: torch.Tensor, ids: torch.Tensor, pooling: str,
              pad_id: int, vocab: Optional[int] = None,
              wide: bool = False) -> torch.Tensor:
    """``[B, L, dim]`` rows -> ``[B, dim]``. Padding rows are zero by the
    pull's contract, so the sum needs no mask; mean and sqrtn divide by
    the true lengths. ``wide``: ids are ``[B, L, 2]`` pairs."""
    _check(pooling)
    if rows.dim() != 3:
        raise ValueError(
            f"pooling needs [B, L, dim] rows, got shape {tuple(rows.shape)} "
            "— sequence features take [B, L] padded id matrices "
            "([B, L, 2] pair matrices for wide keys)")
    return _divide(_sequential_sum(rows), pooling, ids, pad_id, vocab, wide)


def _sequential_sum(rows: torch.Tensor) -> torch.Tensor:
    """``rows.sum(1)`` added in XLA's order, ``((0 + r_0) + r_1) + ...``:
    ``torch.sum`` keeps several partial sums once ``L`` is large, and
    rounds apart from JAX's reduce."""
    s = rows[:, 0] + 0.0
    for i in range(1, rows.shape[1]):
        s = s + rows[:, i]
    return s


def expand_pooled_grads(g: torch.Tensor, ids: torch.Tensor, pooling: str,
                        pad_id: int, vocab: Optional[int] = None,
                        wide: bool = False) -> torch.Tensor:
    """The VJP of :func:`pool_rows` with respect to the rows: ``[B, dim]``
    -> ``[B, L, dim]``. Every slot gets the pooled gradient (divided for
    mean and sqrtn); a padding slot's invalid id makes its update a no-op
    in the push."""
    _check(pooling)
    scaled = _divide(g, pooling, ids, pad_id, vocab, wide)
    return scaled[:, None, :].expand(ids.shape[0], ids.shape[1], g.shape[-1])
