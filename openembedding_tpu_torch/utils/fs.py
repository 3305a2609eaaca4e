"""Filesystem helpers: the local-path subset of ``openembedding_tpu/utils/fs.py``.

Checkpoints live on local disk. ``scheme://`` URIs (gs://, s3://,
hdfs://, memory://), which the JAX package routes through fsspec, raise
``NotImplementedError`` until ROADMAP.md Queue 1's "delta checkpoints
and other layouts" item. The delta plane's crash-consistent writes go
through :func:`open_atomic` (tmp file, fsync, atomic rename, directory
fsync), whose commit the fault injector of ``analysis/chaos.py`` can
tear (:func:`set_commit_hook`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any


def is_remote(path: str) -> bool:
    """True for fsspec-style URIs (``scheme://...``)."""
    return "://" in str(path)


def _local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"remote path {path!r}: the torch port reads and writes local "
            "paths only (ROADMAP.md Queue 1, delta checkpoints and other "
            "layouts)")
    return path


def join(path: str, *parts: str) -> str:
    return os.path.join(_local(path), *parts)


def open_file(path: str, mode: str = "rb"):
    return open(_local(path), mode)


def exists(path: str) -> bool:
    return os.path.exists(_local(path))


def isdir(path: str) -> bool:
    return os.path.isdir(_local(path))


def makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def listdir(path: str):
    return os.listdir(_local(path))


def rmtree(path: str) -> None:
    shutil.rmtree(_local(path))


def remove(path: str) -> None:
    os.remove(_local(path))


ATOMIC_TMP_SUFFIX = ".tmp"

# fault-injection seam (analysis/chaos.py torn_write): when set, every
# atomic commit offers the hook the (path, tmp, fileobj) triple first; a
# True return means the hook did the commit itself (normally by tearing
# it). None in production: one global read per commit.
_COMMIT_HOOK = None


def set_commit_hook(hook) -> None:
    """Install or clear (None) the atomic-commit interposer (a test and
    fault-injection facility, not production state)."""
    global _COMMIT_HOOK
    _COMMIT_HOOK = hook


def open_atomic(path: str):
    """Open ``path`` for a crash-consistent whole-file write: the bytes go
    to ``<path>.tmp.<pid>``, which is flushed, fsynced and renamed over
    ``path`` (then the directory is fsynced) when the ``with`` block ends
    without an error, and removed when it raises. A reader sees the whole
    old file or the whole new one, never a torn one::

        with fs.open_atomic(p) as f:
            f.write(...)
    """
    return _AtomicFile(_local(path))


class _AtomicFile:
    """Local tmp + fsync + rename writer (see :func:`open_atomic`)."""

    def __init__(self, path: str):
        self._path = path
        self._tmp = f"{path}{ATOMIC_TMP_SUFFIX}.{os.getpid()}"
        self._f = open(self._tmp, "wb")

    def write(self, data) -> int:
        return self._f.write(data)

    def __getattr__(self, name):
        # the rest of the file protocol (seek, tell, ...)
        f = self.__dict__.get("_f")
        if f is None:
            raise AttributeError(name)
        return getattr(f, name)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self._f.close()
            try:
                os.remove(self._tmp)
            except OSError:
                pass
            return False
        hook = _COMMIT_HOOK
        if hook is not None and hook(self._path, self._tmp, self._f):
            return False
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, self._path)
        _fsync_dir(os.path.dirname(self._path) or ".")
        return False


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
    """A leftover ``*.tmp.<pid>`` of a write that never committed."""
    stem, _, pid = fname.rpartition(".")
    return stem.endswith(ATOMIC_TMP_SUFFIX) and pid.isdigit()


def write_json_atomic(path: str, obj: Any) -> None:
    """Crash-consistent JSON commit (see :func:`open_atomic`)."""
    with open_atomic(path) as f:
        f.write(json.dumps(obj).encode("utf-8"))


def read_json(path: str) -> Any:
    with open_file(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))
