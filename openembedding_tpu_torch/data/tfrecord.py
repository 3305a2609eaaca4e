"""Dependency-free TFRecord and ``tf.train.Example`` reader and writer
(``openembedding_tpu/data/tfrecord.py``).

* TFRecord container: ``<uint64 len><crc32c(len)><data><crc32c(data)>``
  with the masked Castagnoli CRC; reads verify both CRCs and raise on a
  mismatch or a truncated record, the writer serves fixtures and
  ``data/stream.write_synthetic_shards``.
* ``parse_example`` walks the protobuf wire format of ``tf.train.Example``
  directly (Features -> map entries -> Feature{bytes|float|int64 list}),
  packed and unpacked encodings both.
* ``read_criteo_tfrecord`` yields the same batch dicts as
  ``criteo.read_criteo_csv``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

# --- crc32c (Castagnoli) ------------------------------------------------------
#
# Native (google-crc32c: hardware CRC instructions, GB/s) when importable,
# with a table-driven Python loop as the fallback. The pure loop runs a
# few MB/s: fine for fixtures, CPU-bound on Criteo-scale files.

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _crc32c_py(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


try:
    import google_crc32c as _gcrc

    def crc32c(data: bytes) -> int:
        return _gcrc.value(data)
except ImportError:
    crc32c = _crc32c_py


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- TFRecord container ------------------------------------------------------

def read_records(path: str, *, verify: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) != 12:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", head[:8])
            (len_crc,) = struct.unpack("<I", head[8:])
            if verify and masked_crc(head[:8]) != len_crc:
                raise IOError(f"TFRecord length CRC mismatch in {path}")
            data = f.read(length)
            tail = f.read(4)
            if len(data) != length or len(tail) != 4:
                raise IOError(f"truncated TFRecord data in {path}")
            if verify and masked_crc(data) != struct.unpack("<I", tail)[0]:
                raise IOError(f"TFRecord data CRC mismatch in {path}")
            yield data


def write_record(f, data: bytes) -> None:
    head = struct.pack("<Q", len(data))
    f.write(head)
    f.write(struct.pack("<I", masked_crc(head)))
    f.write(data)
    f.write(struct.pack("<I", masked_crc(data)))


# --- protobuf wire format ----------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                     # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:                   # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                   # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:                   # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _to_signed64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _parse_feature(buf: bytes):
    """Feature{1: BytesList, 2: FloatList, 3: Int64List} -> python list."""
    for field, _wt, val in _fields(buf):
        if field == 1:        # BytesList: repeated bytes field 1
            return [v for f, _w, v in _fields(val) if f == 1]
        if field == 2:        # FloatList: repeated float field 1 (packed
            out: List[float] = []     # or unpacked)
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:    # packed
                    out.extend(np.frombuffer(v, "<f4").tolist())
                else:         # unpacked 32-bit
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:        # Int64List: repeated int64 field 1
            iout: List[int] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:    # packed varints
                    p = 0
                    while p < len(v):
                        u, p = _read_varint(v, p)
                        iout.append(_to_signed64(u))
                else:
                    iout.append(_to_signed64(v))
            return iout
    return []


def parse_example(buf: bytes) -> Dict[str, list]:
    """tf.train.Example bytes -> {feature name: list of values}."""
    out: Dict[str, list] = {}
    for field, _wt, val in _fields(buf):
        if field != 1:        # Example.features
            continue
        for f2, _w2, entry in _fields(val):
            if f2 != 1:       # Features.feature map entry
                continue
            key = b""
            feature = b""
            for f3, _w3, v3 in _fields(entry):
                if f3 == 1:
                    key = v3
                elif f3 == 2:
                    feature = v3
            out[key.decode("utf-8")] = _parse_feature(feature)
    return out


# --- Example writer (fixtures / CSV conversion) ------------------------------

def _varint(u: int) -> bytes:
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def make_example(features: Dict[str, list]) -> bytes:
    """Serialize {name: [ints] | [floats] | [bytes]} as tf.train.Example
    (float detection by value type; matches the reference's fixture
    writer: label/C* int64, I* float)."""
    entries = b""
    for name, values in features.items():
        if values and isinstance(values[0], bytes):
            fl = b"".join(_field_bytes(1, v) for v in values)
            feature = _field_bytes(1, fl)
        elif values and isinstance(values[0], float):
            fl = _field_bytes(
                1, b"".join(struct.pack("<f", v) for v in values))
            feature = _field_bytes(2, fl)
        else:
            fl = _field_bytes(
                1, b"".join(_varint(v & ((1 << 64) - 1)) for v in values))
            feature = _field_bytes(3, fl)
        entry = _field_bytes(1, name.encode()) + _field_bytes(2, feature)
        entries += _field_bytes(1, entry)
    return _field_bytes(1, entries)


# --- Criteo layout -----------------------------------------------------------

def read_criteo_tfrecord(path: str, batch_size: int,
                         *, limit: int = 0,
                         verify: bool = True) -> Iterator[Dict]:
    """Batches from Criteo TFRecord file(s) in the pipeline's dict shape.

    ``path`` may be one file or a directory of ``tf-part.*`` files (the
    reference's sharded layout). Yields
    ``{"label": [B], "dense": [B, 13], "sparse": {C1..C26: [B]}}`` —
    drop-in for ``criteo.read_criteo_csv``.
    """
    from . import criteo
    files = [path]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("tf-part."))
        if not files:
            raise FileNotFoundError(f"no tf-part.* files under {path}")
    labels: List[float] = []
    dense: List[List[float]] = []
    sparse: Dict[str, List[int]] = {n: [] for n in criteo.SPARSE_NAMES}
    seen = 0

    def flush():
        batch = {
            "label": np.asarray(labels, np.float32),
            "dense": np.asarray(dense, np.float32),
            "sparse": {n: np.asarray(v, np.int64)
                       for n, v in sparse.items()},
        }
        labels.clear()
        dense.clear()
        for v in sparse.values():
            v.clear()
        return batch

    for fp in files:
        for rec in read_records(fp, verify=verify):
            ex = parse_example(rec)
            labels.append(float(ex["label"][0]))
            dense.append([float(ex.get(f"I{i}", [0.0])[0] or 0.0)
                          for i in range(1, 14)])
            for n in criteo.SPARSE_NAMES:
                sparse[n].append(int(ex.get(n, [0])[0]))
            seen += 1
            if limit and seen >= limit:
                if labels:
                    yield flush()
                return
            if len(labels) == batch_size:
                yield flush()
    if labels:
        yield flush()
