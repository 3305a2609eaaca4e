"""The dense-state file of a checkpoint, ``dense_state.msgpack``, in the
bytes ``flax.serialization.to_bytes`` writes for the JAX ``Trainer``'s
``(params, opt_state)``, with no msgpack, flax or optax.

The JAX package saves ``to_bytes((params, opt_state))``: flax's state
dict of the pair (a tuple is a map ``{"0": ..., "1": ...}``, an optax
state namedtuple a map by field name, ``EmptyState`` an empty map,
parameter trees nested maps with string keys in the order ``jax.tree``
leaves them, sorted) packed by msgpack, each array an extension of type
1 holding the msgpack triple ``(shape, dtype name, raw C-order bytes)``.
This module writes and reads exactly that subset:

* :func:`pack` / :func:`unpack`: msgpack for maps, arrays, strings,
  binaries, integers, floats, booleans, nil and extensions, each value in
  the smallest form msgpack-python picks (``use_bin_type=True``);
  :class:`NDArray` is the type-1 extension;
* :func:`dense_state_to_bytes` / :func:`dense_state_from_bytes`: the
  port's parameter dict (``{module name: tensor}``, a torch ``weight``
  the transposed flax ``kernel``) and ``optim/dense.py``'s state
  (Adagrad: ``{name: sum_of_squares}``; Adam: ``count``, ``mu/<name>``,
  ``nu/<name>``; SGD: ``{}``) as optax's ``(ScaleByRssState,
  EmptyState)``, ``(ScaleByAdamState, EmptyState)`` and
  ``(EmptyState, EmptyState)``.

bfloat16 tensors travel as their 16-bit words under the dtype name
``bfloat16``, as flax writes ml_dtypes' bfloat16. Arrays above flax's
chunking size (2^30 bytes) are refused: flax would split them into
chunk maps, which no dense state of the port's models reaches.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..interop import flax_path, tensor_to_numpy

ND_EXT = 1                    # flax's _MsgpackExtType.ndarray
MAX_LEAF_BYTES = 2 ** 30      # flax's MAX_CHUNK_SIZE


class NDArray:
    """One array as flax packs it: C-order bytes, a shape and a numpy
    dtype name (``"bfloat16"`` for 16-bit words of bfloat16)."""

    __slots__ = ("shape", "dtype", "data")

    def __init__(self, shape, dtype: str, data: bytes):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = str(dtype)
        self.data = bytes(data)

    @classmethod
    def of(cls, t) -> "NDArray":
        if isinstance(t, torch.Tensor):
            name = "bfloat16" if t.dtype == torch.bfloat16 else None
            arr = tensor_to_numpy(t)
        else:
            arr = np.asarray(t)
            name = None
        name = name or arr.dtype.name
        return cls(arr.shape, name, arr.tobytes(order="C"))

    def numpy(self) -> np.ndarray:
        """The array; bfloat16 as its uint16 words."""
        dt = np.dtype(np.uint16) if self.dtype == "bfloat16" \
            else np.dtype(self.dtype)
        return np.frombuffer(self.data, dtype=dt).reshape(self.shape)

    def tensor(self, device) -> torch.Tensor:
        arr = self.numpy().copy()
        if self.dtype == "bfloat16":
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device)


# --- msgpack -------------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if v >= 0:
        if v <= 0x7F:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + struct.pack(">B", v)
        elif v <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", v)
        else:
            out += b"\xcf" + struct.pack(">Q", v)
    elif v >= -32:
        out += struct.pack(">b", v)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    else:
        out += b"\xd3" + struct.pack(">q", v)


def _pack_len(n: int, out: bytearray, fix: int, fixmax: int,
              codes: Tuple[int, ...], widths=(">B", ">H", ">I")) -> None:
    """A length header: the fix form below ``fixmax``, else the first of
    ``codes`` (8/16/32-bit lengths, or 16/32 where no 8-bit form exists)
    whose width holds ``n``."""
    if fix is not None and n < fixmax:
        out.append(fix | n)
        return
    for code, width in zip(codes, widths[-len(codes):]):
        if n < (1 << (8 * struct.calcsize(width))):
            out.append(code)
            out += struct.pack(width, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, (0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, Mapping):
        _pack_len(len(obj), out, 0x80, 16, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, NDArray):
        if len(obj.data) > MAX_LEAF_BYTES:
            raise ValueError(
                f"array of {len(obj.data)} bytes: flax would chunk it, "
                "which this writer does not")
        body = pack((list(obj.shape), obj.dtype, obj.data))
        n = len(body)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", ND_EXT)
        out += body
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def pack(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (maps keep their insertion order)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(bytes(data))
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data truncated at byte {self.pos}")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.read() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.num(ints[c])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lens:
            return self.take(self.num(lens[c])).decode("utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in bins:
            return self.take(self.num(bins[c]))
        if c in (0xDC, 0xDD):
            return [self.read()
                    for _ in range(self.num(">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self._map(self.num(">H" if c == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self._ext(fixext[c])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in exts:
            return self._ext(self.num(exts[c]))
        raise ValueError(f"msgpack byte 0x{c:02x} at {self.pos - 1} is not "
                         "in the subset a dense state uses")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int) -> Any:
        code = self.num(">b")
        body = self.take(n)
        if code != ND_EXT:
            raise ValueError(f"msgpack extension type {code} is not an "
                             "array")
        shape, dtype, data = unpack(body)
        if isinstance(dtype, bytes):
            dtype = dtype.decode("utf-8")
        return NDArray(shape, dtype, data)


def unpack(data: bytes) -> Any:
    """The object of msgpack bytes; arrays as :class:`NDArray`."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the "
                         "msgpack object")
    return obj


# --- the dense state --------------------------------------------------------------

def _sorted_tree(tree: Dict) -> Dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def _flax_tree(params: Mapping[str, torch.Tensor]) -> Dict:
    """A parameter dict as flax's nested tree of :class:`NDArray`, keys
    sorted at every level (the order ``jax.tree`` gives them)."""
    tree: Dict = {}
    for name, t in params.items():
        path = flax_path(name)
        if path[-1] == "kernel":
            t = t.t()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = NDArray.of(t)
    return _sorted_tree(tree)


def _optimizer_kind(params: Mapping[str, Any],
                    opt_state: Mapping[str, Any]) -> str:
    if not opt_state:
        return "sgd"
    if "count" in opt_state and all(f"mu/{k}" in opt_state
                                    for k in params):
        return "adam"
    if set(opt_state) == set(params):
        return "adagrad"
    raise ValueError(f"dense optimizer state with keys "
                     f"{sorted(opt_state)[:4]}... is none of Adagrad, "
                     "Adam and SGD")


def _slot(opt_state: Mapping[str, torch.Tensor], prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in opt_state.items()
            if k.startswith(prefix)}


def state_dict(params: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, torch.Tensor]) -> Dict:
    """flax's state dict of the JAX ``(params, opt_state)`` pair."""
    kind = _optimizer_kind(params, opt_state)
    if kind == "adagrad":
        first = {"sum_of_squares": _flax_tree(opt_state)}
    elif kind == "adam":
        first = {"count": NDArray.of(opt_state["count"]),
                 "mu": _flax_tree(_slot(opt_state, "mu/")),
                 "nu": _flax_tree(_slot(opt_state, "nu/"))}
    else:
        first = {}
    return {"0": _flax_tree(params), "1": {"0": first, "1": {}}}


def dense_state_to_bytes(params: Mapping[str, torch.Tensor],
                         opt_state: Mapping[str, torch.Tensor]) -> bytes:
    """``flax.serialization.to_bytes((params, opt_state))`` of the JAX
    ``Trainer`` whose state the port's ``(params, opt_state)`` holds."""
    return pack(state_dict(params, opt_state))


def _leaf(tree: Any, name: str, want: torch.Tensor, device) -> torch.Tensor:
    path = flax_path(name)
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise ValueError(f"dense state has no {'/'.join(path)}")
        node = node[k]
    if not isinstance(node, NDArray):
        raise ValueError(f"dense state {'/'.join(path)} is not an array")
    t = node.tensor(device)
    if path[-1] == "kernel":
        t = t.t().contiguous()
    if tuple(t.shape) != tuple(want.shape):
        raise ValueError(f"dense state {'/'.join(path)} of shape "
                         f"{tuple(t.shape)}, the template's "
                         f"{tuple(want.shape)}")
    return t.to(want.dtype)


def _restore_tree(tree: Any, template: Mapping[str, torch.Tensor],
                  device) -> Dict[str, torch.Tensor]:
    return {name: _leaf(tree, name, t, device)
            for name, t in template.items()}


def dense_state_from_bytes(data: bytes, template: Tuple[Mapping, Mapping],
                           device=None) -> Tuple[Dict, Dict]:
    """``(params, opt_state)`` from ``dense_state.msgpack`` bytes (the
    JAX package's or the port's), shaped like ``template`` (a ``(params,
    opt_state)`` pair of the port's), on ``device`` (default: the
    template's)."""
    params_t, opt_t = template
    if device is None:
        device = next(iter(params_t.values())).device if params_t else "cpu"
    sd = unpack(data)
    try:
        ptree, first = sd["0"], sd["1"]["0"]
    except (KeyError, TypeError) as e:
        raise ValueError("dense state is not a (params, opt_state) "
                         "pair") from e
    params = _restore_tree(ptree, params_t, device)
    kind = _optimizer_kind(params_t, opt_t)
    if kind == "adagrad":
        opt = _restore_tree(first["sum_of_squares"], opt_t, device)
    elif kind == "adam":
        opt = {"count": first["count"].tensor(device).to(
            opt_t["count"].dtype).reshape(opt_t["count"].shape)}
        for slot in ("mu", "nu"):
            tmpl = _slot(opt_t, f"{slot}/")
            opt.update({f"{slot}/{k}": v for k, v in _restore_tree(
                first[slot], tmpl, device).items()})
    else:
        opt = {}
    return params, opt
