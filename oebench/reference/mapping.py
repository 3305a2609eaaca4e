"""Where a feature's id lands in a fused table.

A configuration gives each feature's vocabulary, ``vocab_sizes``: the ids
``0 .. V_f - 1`` that feature ``f`` can take. An array group concatenates
its features' rows: feature ``f``'s id ``i`` is row ``O_f + i`` of the
fused table, ``O_f`` the sum of the vocabularies before ``f``; an id
outside ``[0, V_f)`` is no row (``-1``), pulls as zeros and takes no
update.

A hash group keys feature ``f``'s id ``k`` as the int64 ``k * F + f``
(wrapping). A wide key travels as its (lo, hi) int32 words; the words
exclude ``hi == INT32_MIN``, the EMPTY band, so a key whose high word is
that moves up one high step (``+ 2^32``). A key's row is the row stored
for it: nothing else about the table's layout matters.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MIN = np.iinfo(np.int32).min


def vocab_sizes(config: dict) -> np.ndarray:
    """Each feature's vocabulary (int64 ``[F]``)."""
    sizes = np.asarray(config["vocab_sizes"], np.int64)
    if sizes.shape != (int(config["num_features"]),):
        raise ValueError("vocab_sizes must give one size a feature")
    return sizes


def fused_rows(ids: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """``[..., F]`` per-feature ids -> fused rows (int64, -1 for none)."""
    ids = np.asarray(ids, np.int64)
    sizes = np.asarray(sizes, np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    valid = (ids >= 0) & (ids < sizes)
    return np.where(valid, ids + offsets, -1)


def _out_of_band(keys: np.ndarray) -> np.ndarray:
    band = (keys >> np.int64(32)).astype(np.int64) == INT32_MIN
    return np.where(band, keys + (np.int64(1) << np.int64(32)), keys)


def hash_keys(ids: np.ndarray) -> np.ndarray:
    """``[..., F]`` per-feature ids -> int64 keys ``k * F + f``, moved out
    of the EMPTY band."""
    ids = np.asarray(ids, np.int64)
    f = ids.shape[-1]
    with np.errstate(over="ignore"):
        keys = ids * np.int64(f) + np.arange(f, dtype=np.int64)
    return _out_of_band(keys)


def vocabulary_keys(sizes: np.ndarray, device="cpu") -> np.ndarray:
    """Every key that ids within the vocabularies ``sizes`` reach, sorted
    (sorted on ``device``)."""
    f = len(sizes)
    keys = torch.cat([torch.arange(int(v), dtype=torch.int64, device=device)
                      * f + j for j, v in enumerate(sizes)])
    keys = torch.from_numpy(_out_of_band(keys.cpu().numpy())).to(device)
    return torch.sort(keys).values.cpu().numpy()


def key_words(keys: np.ndarray) -> np.ndarray:
    """int64 keys -> ``[..., 2]`` int32 (lo, hi) words."""
    k = np.asarray(keys, np.int64)
    lo = (k & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return np.stack([lo, (k >> np.int64(32)).astype(np.int32)], axis=-1)


def word_keys(words: np.ndarray) -> np.ndarray:
    """``[..., 2]`` int32 (lo, hi) words -> int64 keys."""
    w = np.asarray(words)
    lo = w[..., 0].view(np.uint32).astype(np.int64)
    return (w[..., 1].astype(np.int64) << np.int64(32)) | lo
