"""Message compression for the binary planes (the port's copy of
``openembedding_tpu/utils/compress.py``): delta checkpoint payloads and
the hot-swap wire frames of ``checkpoint_delta.encode_delta``.

Codecs: ``""`` (raw), ``"zlib"`` (stdlib, always available), ``"zstd"``
(used when a zstd binding is importable — ``zstandard`` or Python 3.14's
``compression.zstd``; selecting it without one installed raises at config
time, not mid-stream). Wire format: each plane's JSON header carries a
``"compress"`` field naming the codec of the bytes that follow; absent or
empty means raw — old readers and writers interoperate.
"""

from __future__ import annotations

import zlib

KNOWN = ("", "zlib", "zstd")


def _zstd():
    try:
        import zstandard
        return zstandard
    except ImportError:
        try:  # Python >= 3.14 stdlib
            from compression import zstd
            return zstd
        except ImportError:
            return None


def check(codec: str) -> str:
    """Validate a codec name at CONFIG time; returns it normalized."""
    codec = codec or ""
    if codec not in KNOWN:
        raise ValueError(
            f"unknown message_compress codec {codec!r}; known: "
            f"{list(KNOWN)}")
    if codec == "zstd" and _zstd() is None:
        raise ValueError(
            "message_compress='zstd' needs the 'zstandard' package (or "
            "Python >= 3.14); use 'zlib' here")
    return codec


def check_persist_codec(codec: str) -> str:
    """Validate a codec for the offload persist chain: its npz container
    is deflate-only, so zstd is rejected here (loudly, at config/construct
    time) rather than silently downgraded."""
    codec = check(codec)
    if codec == "zstd":
        raise ValueError("the persist chain's npz container supports only "
                         "'' or 'zlib' (deflate); use 'zlib' here")
    return codec


def compress(codec: str, data: bytes) -> bytes:
    if not codec:
        return bytes(data)
    if codec == "zlib":
        return zlib.compress(data, level=1)  # streaming planes: favor speed
    if codec == "zstd":
        z = _zstd()
        if hasattr(z, "ZstdCompressor"):     # zstandard package
            return z.ZstdCompressor().compress(data)
        return z.compress(data)              # stdlib compression.zstd
    raise ValueError(f"unknown codec {codec!r}")


def decompress(codec: str, data: bytes) -> bytes:
    if not codec:
        return bytes(data)
    if codec == "zlib":
        return zlib.decompress(data)
    if codec == "zstd":
        z = _zstd()
        if hasattr(z, "ZstdDecompressor"):
            return z.ZstdDecompressor().decompress(data)
        return z.decompress(data)
    raise ValueError(f"unknown codec {codec!r}")
