"""Compact binary wire codec for stats records.

Fills the role of the reference's SBE stats codecs
(deeplearning4j-ui-parent/deeplearning4j-ui-model/.../stats/sbe/ —
UpdateEncoder/StaticInfoEncoder): training-stats records travel and
persist as a compact type-tagged binary format instead of JSON.
Numeric arrays ride the SAME self-describing frame
format as the streaming module (streaming/serde.py serialize_ndarray),
so histograms/param summaries serialize at raw little-endian width —
the dominant payload — while scalars/keys use a minimal tag+payload
scheme. No pickle anywhere: decoding is bounds-checked and safe on
untrusted bytes; unknown tags raise.

JSON remains the dashboard-facing representation (the HTTP GET API) —
this codec covers listener → storage → remote-router transport.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from deeplearning4j_tpu_torch.streaming.serde import (
    deserialize_ndarray,
    serialize_ndarray,
)

MAGIC = b"DL4JSTA1"

_T_NONE = 0
_T_FALSE = 1
_T_TRUE = 2
_T_INT = 3          # int64 LE
_T_FLOAT = 4        # float64 LE
_T_STR = 5          # u32 len + utf-8
_T_LIST = 6         # u32 count + items
_T_DICT = 7         # u32 count + (str key, value) pairs
_T_NDARRAY = 8      # u32 len + streaming/serde frame

_MAX_ITEMS = 1 << 24        # sanity caps for untrusted input
_MAX_STR = 1 << 26


def _enc(value: Any, out: list):
    if value is None:
        out.append(bytes([_T_NONE]))
    elif value is True:
        out.append(bytes([_T_TRUE]))
    elif value is False:
        out.append(bytes([_T_FALSE]))
    elif isinstance(value, (int, np.integer)):
        out.append(struct.pack("<Bq", _T_INT, int(value)))
    elif isinstance(value, (float, np.floating)):
        out.append(struct.pack("<Bd", _T_FLOAT, float(value)))
    elif isinstance(value, str):
        b = value.encode("utf-8")
        out.append(struct.pack("<BI", _T_STR, len(b)))
        out.append(b)
    elif isinstance(value, np.ndarray):
        # stats payloads travel at f32 width, like the reference's SBE
        # UpdateEncoder (histogram/summary floats are 32-bit on its
        # wire too); integer arrays keep their exact dtype. Note:
        # f64 arrays — and numeric lists of >=8 items via
        # the fast path below — are quantized to f32 on this wire;
        # tuples decode as lists. Callers needing exact f64 round-trips
        # should keep values as scalars or short (<8) lists.
        if value.dtype == np.float64:
            value = value.astype(np.float32)
        frame = serialize_ndarray(value)
        out.append(struct.pack("<BI", _T_NDARRAY, len(frame)))
        out.append(frame)
    elif isinstance(value, dict):
        out.append(struct.pack("<BI", _T_DICT, len(value)))
        for k, v in value.items():
            kb = str(k).encode("utf-8")
            out.append(struct.pack("<I", len(kb)))
            out.append(kb)
            _enc(v, out)
    elif isinstance(value, (list, tuple)):
        # homogeneous numeric lists (histograms, norms) ride the array
        # frame — that is where the bytes are
        if len(value) >= 8:
            arr = np.asarray(value)
            if arr.dtype.kind in "if" and arr.ndim >= 1:
                _enc(arr, out)
                return
        out.append(struct.pack("<BI", _T_LIST, len(value)))
        for v in value:
            _enc(v, out)
    else:
        raise TypeError(f"stats codec: unsupported type {type(value)}")


def encode_stats_record(record: dict) -> bytes:
    """record dict → compact binary bytes (MAGIC + encoded dict)."""
    out = [MAGIC]
    _enc(record, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes, off: int):
        self.data = data
        self.off = off

    def take(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.data):
            raise ValueError("truncated stats record")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]


def _dec(r: _Reader) -> Any:
    tag = r.take(1)[0]
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return struct.unpack("<q", r.take(8))[0]
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        n = r.u32()
        if n > _MAX_STR:
            raise ValueError("string exceeds cap")
        return r.take(n).decode("utf-8")
    if tag == _T_NDARRAY:
        n = r.u32()
        arr, _ts = deserialize_ndarray(r.take(n))
        # lists went in, lists come out: storage/dashboard consumers
        # expect JSON-shaped records
        return arr.tolist()
    if tag == _T_LIST:
        n = r.u32()
        if n > _MAX_ITEMS:
            raise ValueError("list exceeds cap")
        return [_dec(r) for _ in range(n)]
    if tag == _T_DICT:
        n = r.u32()
        if n > _MAX_ITEMS:
            raise ValueError("dict exceeds cap")
        out = {}
        for _ in range(n):
            kn = r.u32()
            if kn > _MAX_STR:
                raise ValueError("key exceeds cap")
            k = r.take(kn).decode("utf-8")
            out[k] = _dec(r)
        return out
    raise ValueError(f"unknown tag {tag}")


def decode_stats_record(data: bytes) -> dict:
    if data[:len(MAGIC)] != MAGIC:
        raise ValueError("bad magic; not a stats record")
    r = _Reader(data, len(MAGIC))
    rec = _dec(r)
    if not isinstance(rec, dict):
        raise ValueError("stats record root must be a dict")
    return rec


def is_stats_record(data: bytes) -> bool:
    return data[:len(MAGIC)] == MAGIC
