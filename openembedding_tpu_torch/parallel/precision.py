"""The precision ladder of the exchange planes
(``openembedding_tpu/parallel/precision.py``).

Rows and gradients can cross the owner exchange (``parallel/alltoall.py``)
narrower than the tables hold them; master weights and optimizer slots
stay at their storage dtype on the owner:

* ``exchange_precision = "bf16"``: pulled rows cross the response leg and
  the row assembly as bfloat16, one round-to-nearest cast a row, and are
  widened after the last leg;
* ``push_precision = "bf16"``: the pre-reduced gradient rows cross the
  push as bfloat16 (keys and counts stay integers), widened before the
  owner's optimizer;
* ``push_precision = "int8_ef"``: per-row max-abs int8 quantization of the
  pre-reduced gradients with an error-feedback residual: each sender
  keeps its last step's keys and quantization errors (:class:`EFState`,
  carried in the collection's states beside the table) and adds the
  residual back into the next gradient it pre-reduces for the same key.

A plane token's suffix is shorthand: ``"a2a+bf16"`` is ``a2a`` with bf16
both ways, ``"a2a+int8"`` bf16 pulls and int8_ef pushes. Where there is no
wire there is nothing to compress: a one-shard variable runs at full
precision, and ``psum`` with a compressed rung is refused when the spec is
built. ``"f32"`` computes exactly what the plane computes without it.

In the port every sender's residual block is one row of the stacked
``[S * m(, 2)]`` key and ``[S * m, dim]`` residual buffers (sender ``p`` at
rows ``[p * m, (p + 1) * m)``), JAX's global arrays. The collection sizes
them for a batch shape before a step program is built
(``EmbeddingCollection.size_ef``), so the first push does not replace
them inside a captured graph: a fresh buffer is sentinel keys and zero
residuals, the values JAX's first push sizes its own to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# pull-wire rungs (exchange.precision) and push-wire rungs (push.precision)
EXCHANGE_PRECISIONS = ("f32", "bf16")
PUSH_PRECISIONS = ("f32", "bf16", "int8_ef")

# plane-token suffix -> (exchange_precision, push_precision)
PLANE_SUFFIXES = {
    "+bf16": ("bf16", "bf16"),
    "+int8": ("bf16", "int8_ef"),
}

# the base planes int8_ef rides: its residual lives per sender beside the
# per-table exchange
INT8_EF_PLANES = ("a2a", "a2a+pipelined")


def parse_plane(plane: str) -> Tuple[str, str, str]:
    """``plane`` token -> ``(base_plane, exchange_precision,
    push_precision)``; a token without a suffix is at the f32 rung."""
    for suffix, (ep, pp) in PLANE_SUFFIXES.items():
        if plane.endswith(suffix):
            return plane[: -len(suffix)], ep, pp
    return plane, "f32", "f32"


def plane_label(base_plane: str, exchange_precision: str,
                push_precision: str) -> str:
    """The observable label of a (plane, precision) combination (spans,
    timings): ``+int8`` for anything int8, ``+bf16`` for any other bf16."""
    if push_precision == "int8_ef":
        return base_plane + "+int8"
    if "bf16" in (exchange_precision, push_precision):
        return base_plane + "+bf16"
    return base_plane


def wire_dtype(precision: str) -> Optional[torch.dtype]:
    """The dtype rows take on the wire for one rung (None: no cast)."""
    return torch.bfloat16 if precision == "bf16" else None


def wire_itemsize(precision: str, *, f32_itemsize: int = 4) -> int:
    """Bytes of one gradient or row element on the wire."""
    if precision == "bf16":
        return 2
    if precision == "int8_ef":
        return 1
    return f32_itemsize


def check_spec_precision(base_plane: str, exchange_precision: str,
                         push_precision: str, *, name: str = "") -> None:
    """Validate one spec's precision rungs against its base plane."""
    where = f"embedding {name!r}: " if name else ""
    if exchange_precision not in EXCHANGE_PRECISIONS:
        raise ValueError(
            f"{where}unknown exchange_precision {exchange_precision!r}; "
            f"known: {EXCHANGE_PRECISIONS}")
    if push_precision not in PUSH_PRECISIONS:
        raise ValueError(
            f"{where}unknown push_precision {push_precision!r}; "
            f"known: {PUSH_PRECISIONS}")
    compressed = (exchange_precision, push_precision) != ("f32", "f32")
    if base_plane == "psum" and compressed:
        raise ValueError(
            f"{where}the psum ablation plane has no routed wire to "
            "compress; keep precision='f32' or use an a2a plane")
    if push_precision == "int8_ef" and base_plane not in INT8_EF_PLANES:
        raise ValueError(
            f"{where}push_precision='int8_ef' rides only the per-table "
            f"owner exchange (base planes {INT8_EF_PLANES}); "
            f"{base_plane!r} needs its own residual story — use 'bf16'")


def resolve_precision(plane: str, exchange_precision: str,
                      push_precision: str) -> Tuple[str, str, str]:
    """Fold a ``+bf16``/``+int8`` suffix into the precision fields and
    validate the combination (JAX's ``sharded_table._resolve_precision``):
    ``(base_plane, exchange_precision, push_precision)``."""
    base, sep, spp = parse_plane(plane)
    if (sep, spp) != ("f32", "f32"):
        for given, suffixed, knob in (
                (exchange_precision, sep, "exchange_precision"),
                (push_precision, spp, "push_precision")):
            if given not in ("f32", suffixed):
                raise ValueError(
                    f"plane {plane!r} implies {knob}={suffixed!r} but "
                    f"{given!r} was passed explicitly")
        exchange_precision, push_precision = sep, spp
    check_spec_precision(base, exchange_precision, push_precision)
    return base, exchange_precision, push_precision


# --- error-feedback residual state -------------------------------------------

@dataclasses.dataclass
class EFState:
    """A table and its int8_ef push residual: ``keys`` ``[S * m]`` (``[S *
    m, 2]`` pairs) and ``resid`` ``[S * m, dim]`` float32, each sender's
    last unique keys and quantization errors, sentinel- and zero-padded.
    Derived state: checkpoints dump only ``table``, and a restore attaches
    an empty residual (one step of feedback forfeited)."""

    table: Any
    keys: torch.Tensor
    resid: torch.Tensor


def empty_ef(table_state: Any, *, dim: int, wide: bool, sentinel: int,
             key_dtype: torch.dtype = torch.int32,
             device=None) -> EFState:
    """A zero-length residual beside ``table_state`` (attached at init
    and restore; :func:`ensure_ef` sizes it for a batch shape)."""
    if device is None:
        device = _device_of(table_state)
    kshape = (0, 2) if wide else (0,)
    return EFState(
        table=table_state,
        keys=torch.full(kshape, sentinel, dtype=key_dtype, device=device),
        resid=torch.zeros((0, dim), dtype=torch.float32, device=device))


def _device_of(table_state: Any) -> torch.device:
    return table_state.weights.device


def ef_global_len(n_flat_global: int, data: int, model: int,
                  batch_sharded: bool) -> int:
    """Rows of the stacked EF buffers for one push batch shape: every
    sender carries one ``m``-entry block, ``m`` the exchange's slice."""
    if batch_sharded:
        n_local = -(-n_flat_global // data)
        m = -(-n_local // model)
    else:
        m = -(-n_flat_global // (data * model))
    return data * model * m


def ef_key_space(*, use_hash: bool, wide: bool = False,
                 key_dtype: Any = None) -> Tuple[int, torch.dtype]:
    """``(sentinel, key dtype)`` of one table's EF key buffer: int32 words
    for array streams and wide pairs, a narrow hash table's own key dtype;
    the sentinel is the dtype's minimum (``dedup.FILL``,
    ``hash_table.empty_key``)."""
    if not use_hash or wide:
        kd = torch.int32
    else:
        kd = torch.int64 if str(key_dtype) in ("int64", "torch.int64") \
            else torch.int32
    return int(torch.iinfo(kd).min), kd


def sized_ef(ef: EFState, glen: int, *, dim: int, wide: bool,
             sentinel: int, key_dtype: torch.dtype = torch.int32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keys, resid)`` of exactly ``glen`` rows: ``ef``'s own when they
    fit, else fresh sentinel keys and zero residuals (one step of feedback
    forfeited; a steady loop keeps one shape)."""
    if ef.keys.shape[0] == glen and ef.resid.shape[0] == glen \
            and (ef.keys.dim() == 2) == wide and ef.keys.dtype == key_dtype:
        return ef.keys, ef.resid
    dev = ef.resid.device
    kshape = (glen, 2) if wide else (glen,)
    return (torch.full(kshape, sentinel, dtype=key_dtype, device=dev),
            torch.zeros((glen, dim), dtype=torch.float32, device=dev))


def ensure_ef(state: Any, *, dim: int, wide: bool, sentinel: int,
              n_flat: int, data: int, model: int, batch_sharded: bool,
              key_dtype: torch.dtype = torch.int32) -> EFState:
    """The EF state one int8_ef push runs on, sized for its batch shape:
    ``state`` itself, its buffers replaced in place when their shape does
    not fit; a bare table gets a fresh wrapper (the caller keeps it)."""
    ef = state if isinstance(state, EFState) else empty_ef(
        state, dim=dim, wide=wide, sentinel=sentinel, key_dtype=key_dtype)
    glen = ef_global_len(n_flat, data, model, batch_sharded)
    ef.keys, ef.resid = sized_ef(ef, glen, dim=dim, wide=wide,
                                 sentinel=sentinel, key_dtype=key_dtype)
    return ef
