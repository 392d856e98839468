"""NDArray wire format.

Analog of the reference's NDArray-to-Kafka serialization
(``dl4j-streaming/.../streaming/serde/`` + the Aeron ``NDArrayMessage``
format in nd4j): a compact self-describing binary frame —
magic, dtype, rank, shape, raw little-endian data — plus optional
metadata (timestamp, origin id). No pickle: frames are safe to parse
from untrusted peers (bounded rank/size checks)."""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

_MAGIC = b"DL4JTPU1"
_MAX_RANK = 16
_MAX_BYTES = 1 << 33  # 8 GiB sanity cap

_DTYPES = ["float32", "float64", "float16", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "bool"]


def serialize_ndarray(arr: np.ndarray, timestamp_ns: Optional[int] = None
                      ) -> bytes:
    """array → frame bytes."""
    arr = np.ascontiguousarray(arr)
    name = str(arr.dtype)
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name}")
    ts = time.time_ns() if timestamp_ns is None else timestamp_ns
    header = struct.pack(
        "<8sBBq", _MAGIC, _DTYPES.index(name), arr.ndim, ts)
    shape = struct.pack(f"<{arr.ndim}q", *arr.shape)
    return header + shape + arr.tobytes()


def deserialize_ndarray(data: bytes) -> Tuple[np.ndarray, int]:
    """frame bytes → (array, timestamp_ns). Validates bounds before
    allocating; truncated/corrupt frames always raise ValueError."""
    hsize = struct.calcsize("<8sBBq")
    try:
        magic, dt_idx, rank, ts = struct.unpack_from("<8sBBq", data)
    except struct.error as e:
        raise ValueError(f"truncated frame header: {e}") from e
    if magic != _MAGIC:
        raise ValueError("bad magic; not an NDArray frame")
    if dt_idx >= len(_DTYPES) or rank > _MAX_RANK:
        raise ValueError("corrupt frame header")
    try:
        shape = struct.unpack_from(f"<{rank}q", data, hsize)
    except struct.error as e:
        raise ValueError(f"truncated shape block: {e}") from e
    if any(d < 0 for d in shape):
        raise ValueError("negative dimension")
    dtype = np.dtype(_DTYPES[dt_idx]) if _DTYPES[dt_idx] != "bfloat16" \
        else np.dtype("uint16")  # bf16 carried as raw 16-bit payload
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes > _MAX_BYTES:
        raise ValueError("frame exceeds size cap")
    off = hsize + rank * 8
    if len(data) - off < nbytes:
        raise ValueError(f"truncated payload: need {nbytes} bytes, "
                         f"have {len(data) - off}")
    arr = np.frombuffer(data, dtype, count=nbytes // dtype.itemsize,
                        offset=off).reshape(shape)
    return arr, ts


@dataclass
class NDArrayMessage:
    """A keyed array record on a topic (reference: NDArrayMessage)."""

    array: np.ndarray
    key: str = ""
    timestamp_ns: int = field(default_factory=time.time_ns)

    def to_bytes(self) -> bytes:
        kb = self.key.encode("utf-8")
        return (struct.pack("<I", len(kb)) + kb +
                serialize_ndarray(self.array, self.timestamp_ns))

    @classmethod
    def from_bytes(cls, data: bytes) -> "NDArrayMessage":
        try:
            (klen,) = struct.unpack_from("<I", data)
        except struct.error as e:
            raise ValueError(f"truncated message: {e}") from e
        if len(data) < 4 + klen:
            raise ValueError("truncated message key")
        key = data[4:4 + klen].decode("utf-8")
        arr, ts = deserialize_ndarray(data[4 + klen:])
        return cls(arr, key, ts)
