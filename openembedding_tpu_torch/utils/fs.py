"""Filesystem helpers (``openembedding_tpu/utils/fs.py``): local paths
and fsspec URIs (``gs://``, ``s3://``, ``hdfs://``, ``memory://``).

* plain paths keep the fast local path (memmap writers and readers);
* ``scheme://`` URIs dispatch to fsspec with purely SEQUENTIAL streams,
  the only access pattern object stores do well.

``NpyWriter``/``iter_npy_chunks`` implement the ``.npy`` container
(header and raw C-order data) over any stream, so remote arrays never
materialize whole: the writer appends blocks, the reader yields bounded
row chunks. ``NpyzWriter``/``iter_npyz_chunks`` are their compressed
twin, the framed ``.npyz`` container of compressed checkpoints. The
delta plane's crash-consistent writes go through :func:`open_atomic`
(local: tmp file, fsync, atomic rename, directory fsync; remote: tmp
object and ``mv``), whose local commit the fault injector of
``analysis/chaos.py`` can tear (:func:`set_commit_hook`).
"""

from __future__ import annotations

import io
import json
import os
import posixpath
import shutil
import struct
from collections import deque
from typing import Any, Iterator, Optional, Tuple

import numpy as np

try:  # torch requires fsspec; gated so local paths never depend on it
    import fsspec
except ImportError:  # pragma: no cover
    fsspec = None


def is_remote(path: str) -> bool:
    """True for fsspec URIs (``scheme://...``), False for local paths."""
    return "://" in str(path)


def _fs(path: str):
    if fsspec is None:  # pragma: no cover
        raise RuntimeError(
            f"remote path {path!r} needs fsspec, which is unavailable")
    fs, _ = fsspec.core.url_to_fs(path)
    return fs


def join(path: str, *parts: str) -> str:
    if is_remote(path):
        return posixpath.join(path, *parts)
    return os.path.join(path, *parts)


def open_file(path: str, mode: str = "rb"):
    if is_remote(path):
        return _fs(path).open(path, mode)
    return open(path, mode)


def exists(path: str) -> bool:
    if is_remote(path):
        return _fs(path).exists(path)
    return os.path.exists(path)


def isdir(path: str) -> bool:
    if is_remote(path):
        return _fs(path).isdir(path)
    return os.path.isdir(path)


def makedirs(path: str) -> None:
    if is_remote(path):
        _fs(path).makedirs(path, exist_ok=True)
    else:
        os.makedirs(path, exist_ok=True)


def listdir(path: str):
    if is_remote(path):
        return [posixpath.basename(p.rstrip("/"))
                for p in _fs(path).ls(path, detail=False)]
    return os.listdir(path)


def remove(path: str) -> None:
    if is_remote(path):
        _fs(path).rm(path)
    else:
        os.remove(path)


ATOMIC_TMP_SUFFIX = ".tmp"

# fault-injection seam (analysis/chaos.py torn_write): when set, every
# LOCAL atomic commit offers the hook the (path, tmp, fileobj) triple
# first; a True return means the hook performed the commit itself
# (normally by tearing it). None in production — one global read per
# commit, same cost model as the sync_point slot.
_COMMIT_HOOK = None


def set_commit_hook(hook) -> None:
    """Install/clear (None) the atomic-commit interposer. Test/chaos
    harness facility, not production state."""
    global _COMMIT_HOOK
    _COMMIT_HOOK = hook


def open_atomic(path: str):
    """Open ``path`` for a crash-consistent whole-file write.

    Local paths get the full tmp + fsync + atomic-rename protocol (plus a
    directory fsync so the rename itself is durable): a reader can only
    ever observe the complete old file or the complete new file, never a
    torn one — the transactional-commit property of the reference's PMem
    checkpoint root (PmemEmbeddingItemPool.h:236-296). Remote URIs write a
    tmp object and ``mv`` it over the final name: on object stores the mv
    is a server-side copy whose destination PUT is all-or-nothing, on
    hdfs/file it is a rename — either way a reader never observes a torn
    file, and a crashed write leaves only a GC-able ``*.tmp.<pid>``
    (writing the final name directly would TRUNCATE the committed file
    in place on filesystem-like backends).

    Usage::

        with fs.open_atomic(p) as f:
            f.write(...)
    """
    if is_remote(path):
        return _AtomicRemoteFile(path)
    return _AtomicFile(path)


class _AtomicBase:
    """Shared writer shell: tmp naming, file protocol, abort cleanup.
    Subclasses implement ``_commit`` (and may override ``_abort``)."""

    def __init__(self, path: str):
        self._path = path
        self._tmp = f"{path}{ATOMIC_TMP_SUFFIX}.{os.getpid()}"
        self._f = self._open_tmp()

    def write(self, data) -> int:
        return self._f.write(data)

    def __getattr__(self, name):
        # full file protocol (seek/tell/...): np.savez's zip container
        # needs a seekable stream, not just .write
        f = self.__dict__.get("_f")
        if f is None:  # guard against recursion during __init__
            raise AttributeError(name)
        return getattr(f, name)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self._f.close()
            try:
                self._remove_tmp()
            except OSError:
                pass
            return False
        self._commit()
        return False


class _AtomicFile(_AtomicBase):
    """Local tmp+fsync+rename writer (see :func:`open_atomic`)."""

    def _open_tmp(self):
        return open(self._tmp, "wb")

    def _remove_tmp(self) -> None:
        os.remove(self._tmp)

    def _commit(self) -> None:
        hook = _COMMIT_HOOK
        if hook is not None and hook(self._path, self._tmp, self._f):
            return
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self._path)
        _fsync_dir(os.path.dirname(self._path) or ".")


class _AtomicRemoteFile(_AtomicBase):
    """Remote tmp+mv writer (see :func:`open_atomic`)."""

    def _open_tmp(self):
        return open_file(self._tmp, "wb")

    def _remove_tmp(self) -> None:
        remove(self._tmp)

    def _commit(self) -> None:
        self._f.close()
        fsobj = _fs(self._path)
        try:
            fsobj.mv(self._tmp, self._path)
        except (OSError, FileExistsError):
            # only treat this as mv-onto-existing when the destination
            # actually exists; on a transient backend error the committed
            # copy must NOT be deleted (the tmp object survives either way)
            if not fsobj.exists(self._path):
                raise
            # exists-conflict (some hdfs configs refuse overwrite): clear
            # and retry. The rm->mv gap is two metadata ops — not the zero
            # window object stores give, but far smaller than a truncate-
            # in-place whole-write window, and a crash inside it leaves
            # the complete tmp file for manual recovery
            fsobj.rm(self._path)
            fsobj.mv(self._tmp, self._path)


def _fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-committed rename survives power loss."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover — platform without dir fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def is_tmp_orphan(fname: str) -> bool:
    """A leftover ``*.tmp.<pid>`` from a write that never committed."""
    stem, _, pid = fname.rpartition(".")
    return stem.endswith(ATOMIC_TMP_SUFFIX) and pid.isdigit()


def rmtree(path: str) -> None:
    if is_remote(path):
        _fs(path).rm(path, recursive=True)
    else:
        shutil.rmtree(path)


# --- sequential .npy streaming ----------------------------------------------

def _npy_header(dtype: np.dtype, shape: Tuple[int, ...],
                descr: Optional[str] = None) -> bytes:
    d = {"descr": descr or np.lib.format.dtype_to_descr(dtype),
         "fortran_order": False, "shape": tuple(shape)}
    bio = io.BytesIO()
    np.lib.format.write_array_header_1_0(bio, d)
    return bio.getvalue()


class NpyWriter:
    """Append-only .npy writer over any byte stream (local or fsspec).

    The row count must be known up front (both dump passes already count
    rows first); blocks are appended in C order. This is the remote twin of
    ``np.lib.format.open_memmap`` for writers that can only append —
    the reference's piped hadoop writes (EmbeddingShardFile.h:57-63).
    ``descr`` overrides the header's type string, for words stored under
    another name (bfloat16 as ``uint16`` words under ``'<V2'``, what
    numpy writes for ml_dtypes' bfloat16).
    """

    def __init__(self, path: str, dtype, shape: Tuple[int, ...],
                 descr: Optional[str] = None):
        self._dtype = np.dtype(dtype)
        self._shape = tuple(shape)
        self._written = 0
        self._f = open_file(path, "wb")
        self._f.write(_npy_header(self._dtype, self._shape, descr))

    def write(self, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, dtype=self._dtype)
        self._written += block.shape[0] if block.ndim else 1
        self._f.write(block.tobytes())

    def close(self) -> None:
        if self._written != (self._shape[0] if self._shape else 1):
            # a short file must fail the SAVE, not the eventual load
            self._f.close()
            raise IOError(
                f"NpyWriter: wrote {self._written} rows, header promised "
                f"{self._shape[0]}")
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:  # pragma: no cover - propagate original error
            self._f.close()


_NPYZ_MAGIC = b"\x93NPYZ1\n"
NPYZ_AHEAD = 8      # frames a writer or reader keeps in flight on its pool


class NpyzWriter:
    """Compressed twin of :class:`NpyWriter`: the same append-only
    interface, but blocks are written as independently-compressed FRAMES
    (``[u64 comp_len][u64 rows][comp bytes]``) after a JSON header line —
    the reference's compressed shard-file streams, container edition
    (``descr`` as in :class:`NpyWriter`). Frames decompress one at a
    time, so neither side ever holds the whole array; readers are strictly
    sequential (``iter_npyz_chunks``), matching the remote/.part load
    path. Blocks compress on ``pool``'s threads (an executor shared by
    the files of one save), at most ``NPYZ_AHEAD`` of them in flight,
    and their frames are written in order: the bytes of a serial writer.
    """

    def __init__(self, path: str, dtype, shape: Tuple[int, ...],
                 codec: str = "zlib", descr: Optional[str] = None, *,
                 pool):
        from . import compress as C
        self._codec = C.check(codec) or "zlib"
        self._dtype = np.dtype(dtype)
        self._shape = tuple(shape)
        self._written = 0
        self._pool = pool
        self._pending: deque = deque()
        self._f = open_file(path, "wb")
        head = json.dumps({
            "codec": self._codec,
            "descr": descr or np.lib.format.dtype_to_descr(self._dtype),
            "shape": list(self._shape)}).encode() + b"\n"
        self._f.write(_NPYZ_MAGIC + head)

    def write(self, block: np.ndarray) -> None:
        from . import compress as C
        block = np.ascontiguousarray(block, dtype=self._dtype)
        rows = block.shape[0] if block.ndim else 1
        if not rows:
            return
        self._pending.append((self._pool.submit(
            C.compress, self._codec, block.tobytes()), rows))
        while len(self._pending) > NPYZ_AHEAD:
            self._drain_one()

    def _drain_one(self) -> None:
        fut, rows = self._pending.popleft()
        comp = fut.result()
        self._f.write(struct.pack("<QQ", len(comp), rows))
        self._f.write(comp)
        self._written += rows

    def close(self) -> None:
        try:
            while self._pending:
                self._drain_one()
        except BaseException:
            self._f.close()
            raise
        if self._written != (self._shape[0] if self._shape else 1):
            self._f.close()
            raise IOError(
                f"NpyzWriter: wrote {self._written} rows, header promised "
                f"{self._shape[0]}")
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:  # pragma: no cover - propagate original error
            for fut, _rows in self._pending:
                fut.cancel()
            self._f.close()


def read_npyz_header(f) -> Tuple[str, np.dtype, Tuple[int, ...]]:
    magic = f.read(len(_NPYZ_MAGIC))
    if magic != _NPYZ_MAGIC:
        raise ValueError("not a .npyz stream (bad magic)")
    line = bytearray()
    while True:
        c = f.read(1)
        if not c:
            raise IOError("truncated .npyz header")
        if c == b"\n":
            break
        line += c
    head = json.loads(bytes(line))
    return (head["codec"], np.dtype(np.lib.format.descr_to_dtype(
        head["descr"])), tuple(head["shape"]))


def npyz_shape(path: str) -> Tuple[np.dtype, Tuple[int, ...]]:
    with open_file(path, "rb") as f:
        _, dtype, shape = read_npyz_header(f)
        return dtype, shape


def iter_npyz_chunks(path: str, chunk_rows: int, *,
                     pool) -> Iterator[np.ndarray]:
    """Yield C-order row chunks of a .npyz stream, re-buffered to exactly
    ``chunk_rows`` rows per chunk (except the last) regardless of the
    writer's frame sizes — the contract ``_aligned_reader_chunks`` needs
    to walk several fields in lockstep. Frames decompress on ``pool``'s
    threads (an executor), at most ``NPYZ_AHEAD`` of them ahead of the
    one yielded, while the file is read in order."""
    from . import compress as C
    with open_file(path, "rb") as f:
        codec, dtype, shape = read_npyz_header(f)
        row_shape = tuple(shape[1:])
        total = shape[0] if shape else 1

        def frames():
            seen = 0
            while seen < total:
                hdr = f.read(16)
                if len(hdr) != 16:
                    raise IOError(f"truncated .npyz frame header in {path}")
                comp_len, rows = struct.unpack("<QQ", hdr)
                comp = f.read(comp_len)
                if len(comp) != comp_len:
                    raise IOError(f"truncated .npyz frame in {path}")
                seen += rows
                yield comp, rows

        def decoded():
            pending: deque = deque()
            for comp, rows in frames():
                pending.append((pool.submit(C.decompress, codec, comp),
                                rows))
                if len(pending) > NPYZ_AHEAD:
                    fut, n = pending.popleft()
                    yield fut.result(), n
            while pending:
                fut, n = pending.popleft()
                yield fut.result(), n

        pending_arrs: list = []
        pending_rows = 0
        for raw, rows in decoded():
            arr = np.frombuffer(raw, dtype=dtype).reshape(
                (rows,) + row_shape)
            pending_arrs.append(arr)
            pending_rows += rows
            while pending_rows >= chunk_rows:
                buf = np.concatenate(pending_arrs) \
                    if len(pending_arrs) > 1 else pending_arrs[0]
                yield buf[:chunk_rows]
                rest = buf[chunk_rows:]
                pending_arrs = [rest] if rest.shape[0] else []
                pending_rows = rest.shape[0]
        if pending_rows:
            yield (np.concatenate(pending_arrs) if len(pending_arrs) > 1
                   else pending_arrs[0])


def read_npy_header(f) -> Tuple[np.dtype, Tuple[int, ...]]:
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"unsupported .npy format version {version}")
    if fortran:
        raise ValueError("fortran-order .npy not supported")
    return np.dtype(dtype), shape


def view_as(arr: np.ndarray, want) -> np.ndarray:
    """Reinterpret a raw chunk under its true dtype.

    numpy serializes non-native dtypes (ml_dtypes bfloat16) as opaque void
    descrs ('<V2'); the loader knows the real dtype from the model meta and
    must view the bytes back before handing them on.
    """
    want = np.dtype(want)
    if arr.dtype == want:
        return arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == want.itemsize:
        return arr.view(want)
    return arr.astype(want)


def iter_npy_chunks(path: str, chunk_rows: int
                    ) -> Iterator[np.ndarray]:
    """Yield C-order row chunks of a (possibly remote) .npy sequentially."""
    with open_file(path, "rb") as f:
        dtype, shape = read_npy_header(f)
        row_items = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) \
            else 1
        row_bytes = row_items * dtype.itemsize
        n = shape[0] if shape else 1
        for lo in range(0, n, chunk_rows):
            hi = min(n, lo + chunk_rows)
            buf = f.read((hi - lo) * row_bytes)
            if len(buf) != (hi - lo) * row_bytes:
                raise IOError(f"truncated .npy data in {path}")
            yield np.frombuffer(buf, dtype=dtype).reshape(
                (hi - lo,) + tuple(shape[1:]))


def npy_shape(path: str) -> Tuple[np.dtype, Tuple[int, ...]]:
    with open_file(path, "rb") as f:
        return read_npy_header(f)


def write_json_atomic(path: str, obj: Any) -> None:
    """Crash-consistent JSON commit (see :func:`open_atomic`)."""
    with open_atomic(path) as f:
        f.write(json.dumps(obj).encode("utf-8"))


def read_json(path: str) -> Any:
    with open_file(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))
