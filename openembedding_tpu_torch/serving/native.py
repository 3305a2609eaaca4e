"""ctypes binding of the native serving reader (``native/oe_serving.cc``),
the port's own copy of ``openembedding_tpu/serving/native.py``.

The native library memory-maps a checkpoint directory and answers
read-only pulls on the host, with no Python framework behind it: C++
serving stacks link ``liboe_serving.so`` against ``native/oe_serving.h``
directly, and this binding serves tests and Python hosts that want the
framework-free lookup path. It reads the uncompressed layouts the port
writes: the local ``.npy`` dump, ``part<k>_*.npy`` part files, and a
delta chain over a base (``delta_manifest``), which it replays at open.
Compressed payloads (``.npyz`` part files, deflated delta npz members)
are refused by the library with a typed error, which ``NativeModel``
raises as ``RuntimeError``.

Build: ``make -C native`` (g++ only, no dependencies); ``build_library``
runs it at first use when the library is absent.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from ..analysis import scope

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liboe_serving.so")


def build_library(force: bool = False, variant: str = "") -> str:
    """Compile ``liboe_serving.so`` if absent (or ``force``); returns its
    path. ``variant`` selects a sanitizer build (``"asan"``, ``"ubsan"``:
    ``liboe_serving_<variant>.so`` from the Makefile's target of that
    name)."""
    if variant not in ("", "asan", "ubsan"):
        raise ValueError(f"unknown native build variant {variant!r}")
    lib_path = (os.path.join(_NATIVE_DIR, f"liboe_serving_{variant}.so")
                if variant else _LIB_PATH)
    if not force and os.path.exists(lib_path):
        return lib_path
    if not os.path.isdir(_NATIVE_DIR):
        raise RuntimeError(
            "native/ sources not found: the native serving library builds "
            "from a source checkout (make -C native); elsewhere build it "
            "and pass lib_path to NativeModel")
    target = ["make", "-C", _NATIVE_DIR] + ([variant] if variant else [])
    try:
        subprocess.run(target, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native build failed:\n{e.stdout}\n{e.stderr}") from e
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.oe_last_error.restype = ctypes.c_char_p
    lib.oe_model_load.restype = ctypes.c_void_p
    lib.oe_model_load.argtypes = [ctypes.c_char_p]
    lib.oe_model_free.argtypes = [ctypes.c_void_p]
    lib.oe_model_sign.restype = ctypes.c_char_p
    lib.oe_model_sign.argtypes = [ctypes.c_void_p]
    lib.oe_model_num_variables.restype = ctypes.c_int
    lib.oe_model_num_variables.argtypes = [ctypes.c_void_p]
    lib.oe_model_variable.restype = ctypes.c_void_p
    lib.oe_model_variable.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.oe_model_variable_by_id.restype = ctypes.c_void_p
    lib.oe_model_variable_by_id.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.oe_variable_name.restype = ctypes.c_char_p
    lib.oe_variable_name.argtypes = [ctypes.c_void_p]
    lib.oe_variable_dim.restype = ctypes.c_int
    lib.oe_variable_dim.argtypes = [ctypes.c_void_p]
    lib.oe_variable_vocab.restype = ctypes.c_int64
    lib.oe_variable_vocab.argtypes = [ctypes.c_void_p]
    lib.oe_variable_rows.restype = ctypes.c_int64
    lib.oe_variable_rows.argtypes = [ctypes.c_void_p]
    lib.oe_pull_weights.restype = ctypes.c_int
    lib.oe_pull_weights.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.oe_model_version.restype = ctypes.c_int64
    lib.oe_model_version.argtypes = [ctypes.c_void_p]
    lib.oe_pull_weights_gather.restype = ctypes.c_int
    lib.oe_pull_weights_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    return lib


def _join_keys(arr: np.ndarray) -> np.ndarray:
    """Wide ``[..., 2]`` int32 pairs as their joined 64-bit values (the
    native index is keyed by joined ids); other arrays as they are."""
    if arr.ndim >= 2 and arr.shape[-1] == 2 and arr.dtype == np.int32:
        from ..hash_table import join64
        return join64(arr)
    return arr


class NativeModel:
    """A checkpoint served by the native library (read-only lookups on
    the host)."""

    def __init__(self, path: str, lib_path: Optional[str] = None):
        self._lib = _bind(ctypes.CDLL(lib_path or build_library()))
        self._model = self._lib.oe_model_load(os.fsencode(path))
        if not self._model:
            raise RuntimeError(
                f"native load failed: {self._lib.oe_last_error().decode()}")

    def close(self) -> None:
        if self._model:
            self._lib.oe_model_free(self._model)
            self._model = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def sign(self) -> str:
        return self._lib.oe_model_sign(self._model).decode()

    @property
    def version(self) -> int:
        """Delta-chain seq this load replayed up to (0 for a plain full
        dump): the reader resolves a ``delta_manifest`` chain at open."""
        return int(self._lib.oe_model_version(self._model))

    @property
    def num_variables(self) -> int:
        return self._lib.oe_model_num_variables(self._model)

    def _var(self, variable) -> ctypes.c_void_p:
        if isinstance(variable, int):
            v = self._lib.oe_model_variable_by_id(self._model, variable)
        else:
            v = self._lib.oe_model_variable(self._model, variable.encode())
        if not v:
            raise KeyError(self._lib.oe_last_error().decode())
        return v

    def variable_dim(self, variable) -> int:
        return self._lib.oe_variable_dim(self._var(variable))

    def variable_vocab(self, variable) -> int:
        return self._lib.oe_variable_vocab(self._var(variable))

    def lookup(self, variable, keys: Sequence[int]) -> np.ndarray:
        """Read-only pull: ``[n]`` keys -> ``[n, dim]`` float32 rows (zero
        rows for missing or invalid keys). Wide ``[n, 2]`` int32 pair keys
        are joined to their 64-bit values."""
        v = self._var(variable)
        dim = self._lib.oe_variable_dim(v)
        name = self._lib.oe_variable_name(v).decode()
        arr = _join_keys(np.asarray(keys))
        k = np.ascontiguousarray(arr.astype(np.int64).ravel())
        out = np.zeros((k.size, dim), np.float32)
        with scope.span("serving.native_lookup", table=name):
            rc = self._lib.oe_pull_weights(
                v, k.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                k.size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(self._lib.oe_last_error().decode())
        return out.reshape(arr.shape + (dim,))

    def pull_gather(self, variable, unique_keys: np.ndarray,
                    gather: np.ndarray) -> np.ndarray:
        """The batched C entry point (``oe_pull_weights_gather``): each
        unique key probes the index once, and ``out[i] =
        row(unique_keys[gather[i]])``."""
        v = self._var(variable)
        dim = self._lib.oe_variable_dim(v)
        name = self._lib.oe_variable_name(v).decode()
        uniq = np.ascontiguousarray(
            _join_keys(np.asarray(unique_keys)).astype(np.int64).ravel())
        gidx = np.ascontiguousarray(np.asarray(gather, np.int64).ravel())
        out = np.zeros((gidx.size, dim), np.float32)
        with scope.span("serving.native_lookup_batched", table=name):
            rc = self._lib.oe_pull_weights_gather(
                v, uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                uniq.size,
                gidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                gidx.size,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise RuntimeError(self._lib.oe_last_error().decode())
        return out

    def lookup_batched(self, variable, requests) -> list:
        """Several key arrays resolved by ONE deduplicated native call
        (concatenate, ``np.unique`` on the joined keys, one
        :meth:`pull_gather`), rows split back per request."""
        name = (variable if isinstance(variable, str)
                else self._lib.oe_variable_name(
                    self._var(variable)).decode())
        joined = [_join_keys(np.asarray(r)) for r in requests]
        cat = np.concatenate([j.astype(np.int64).ravel()
                              for j in joined]) if joined \
            else np.zeros(0, np.int64)
        uniq, inverse = np.unique(cat, return_inverse=True)
        rows = self.pull_gather(name, uniq, inverse)
        out, off = [], 0
        for j in joined:
            n = int(np.prod(j.shape, dtype=np.int64)) if j.ndim else 1
            out.append(rows[off:off + n].reshape(j.shape + (rows.shape[1],)))
            off += n
        return out
