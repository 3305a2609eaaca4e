"""Filesystem helpers: the local-path subset of ``openembedding_tpu/utils/fs.py``.

Checkpoints of this slice live on local disk. ``scheme://`` URIs (gs://,
s3://, hdfs://, memory://), which the JAX package routes through fsspec,
raise ``NotImplementedError`` until ROADMAP.md Queue 1's "delta
checkpoints and other layouts" item.
"""

from __future__ import annotations

import os
import shutil


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
