"""ctypes loader for the native host runtime (``native/dl4j_native.cpp``).

The port's own copy of the JAX package's ``utils/native.py``: the same
entry points (the threshold codec, the CSV and IDX readers, and the
fused pair generator of ``nlp/pairgen.py``) over the same C++ source,
with the same numpy fallbacks and the same ``DL4J_NATIVE=0`` switch.

The library is built by ``g++`` at first use into
``build/native/<hash>/`` at the checkout's root (git-ignored); the hash
covers the source and the flags, so a changed source is rebuilt and a
stale library is never loaded. Nothing is written into ``native/``. A
build goes to a temporary name first and is renamed into place, so
processes that build at once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "dl4j_native.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
BUILD_DIR = os.path.join(_ROOT, "build", "native")

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


def library_path() -> Optional[str]:
    """Where the library for this source and these flags lives (None
    without the source)."""
    try:
        with open(SOURCE, "rb") as f:
            text = f.read()
    except OSError:
        return None
    h = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, h, "libdl4j_native.so")


def _build(path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        _log.warning("native build failed, using numpy fallback: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _disabled() -> bool:
    """DL4J_NATIVE=0 is the kill switch: every wrapper reports the
    library unavailable, so callers take their mandatory numpy
    fallback. Checked on every call (not cached) so tests and
    operators can flip it mid-process."""
    return os.environ.get("DL4J_NATIVE", "").strip() == "0"


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable
    or killed via DL4J_NATIVE=0."""
    global _lib, _load_failed
    if _disabled():
        return None
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        path = library_path()
        if path is None or (not os.path.exists(path)
                            and not _build(path)):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            _log.warning("could not load %s: %s", path, e)
            _load_failed = True
            return None
        i64, i32p, i8p, f32p, u8p, cp = (
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p)
        lib.dl4j_encode.argtypes = [i8p, i64, i32p]
        lib.dl4j_encode.restype = i64
        lib.dl4j_encode_flexible.argtypes = [i8p, i64, i32p]
        lib.dl4j_encode_flexible.restype = i64
        lib.dl4j_encode_bitmap.argtypes = [i8p, i64, i32p]
        lib.dl4j_encode_bitmap.restype = i64
        lib.dl4j_decode.argtypes = [i32p, i64, i8p, i64]
        lib.dl4j_decode.restype = i64
        lib.dl4j_decode_axpy.argtypes = [i32p, i64, ctypes.c_float, f32p,
                                         i64]
        lib.dl4j_decode_axpy.restype = i64
        lib.dl4j_csv_dims.argtypes = [cp, i64, ctypes.c_char,
                                      ctypes.POINTER(i64)]
        lib.dl4j_csv_dims.restype = i64
        lib.dl4j_csv_parse.argtypes = [cp, i64, ctypes.c_char, f32p, i64,
                                       i64]
        lib.dl4j_csv_parse.restype = i64
        lib.dl4j_idx_decode.argtypes = [u8p, i64, f32p, i64,
                                        ctypes.POINTER(i64),
                                        ctypes.POINTER(i64)]
        lib.dl4j_idx_decode.restype = i64
        if hasattr(lib, "dl4j_pairgen_walk"):
            u64, u8pp, i32 = (ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_uint8),
                              ctypes.c_int32)
            u64p = ctypes.POINTER(u64)
            lib.dl4j_sm64_fill.argtypes = [u64, i64, i64, u64p]
            lib.dl4j_sm64_fill.restype = None
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.dl4j_pairgen_subsample.argtypes = [i32p, i64, f64p, u64,
                                                   u8pp]
            lib.dl4j_pairgen_subsample.restype = i64
            lib.dl4j_pairgen_negatives.argtypes = [
                i32p, i64, i32p, i64, i32, i32, u64, u64, i64, i32p]
            lib.dl4j_pairgen_negatives.restype = None
            lib.dl4j_pairgen_walk.argtypes = [
                i32p, i32p, i32p, i64, i64, i32, u64, i32p, i64, i32,
                i32, u64, u64, i64, i32p, i32p, i32p]
            lib.dl4j_pairgen_walk.restype = i64
            lib.dl4j_pairgen_walk_cbow.argtypes = [
                i32p, i32p, i32p, i64, i64, i64, i32, u64, i32p, i64,
                i32, i32, u64, u64, i64, i32p, f32p, i32p, i32p]
            lib.dl4j_pairgen_walk_cbow.restype = i64
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# -------------------------------------------------------------------------
# Threshold codec
# -------------------------------------------------------------------------

def encode(signs: np.ndarray) -> Optional[np.ndarray]:
    """Native auto-codec encode; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    signs = np.ascontiguousarray(signs.reshape(-1), np.int8)
    out = np.empty(3 + signs.size, np.int32)
    n = lib.dl4j_encode(_i8p(signs), signs.size, _i32p(out))
    return out[:n].copy()


def decode(message: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    msg = np.ascontiguousarray(message, np.int32)
    length = int(msg[1])
    out = np.zeros(length, np.int8)
    n = lib.dl4j_decode(_i32p(msg), msg.size, _i8p(out), length)
    if n < 0:
        raise ValueError("malformed threshold-codec message")
    return out


def decode_axpy(message: np.ndarray, threshold: float,
                acc: np.ndarray) -> bool:
    """acc += decode(message) * threshold, fused. False if no native lib."""
    lib = get_lib()
    if lib is None:
        return False
    msg = np.ascontiguousarray(message, np.int32)
    assert acc.dtype == np.float32 and acc.flags.c_contiguous
    n = lib.dl4j_decode_axpy(_i32p(msg), msg.size,
                             ctypes.c_float(threshold), _f32p(acc),
                             acc.size)
    if n < 0:
        raise ValueError("malformed threshold-codec message")
    return True


# -------------------------------------------------------------------------
# Record readers
# -------------------------------------------------------------------------

def parse_csv(text: bytes | str, delimiter: str = ",") \
        -> Optional[np.ndarray]:
    """Numeric CSV -> float32 matrix via the native parser; None if the
    library is unavailable (caller falls back to numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    data = text.encode() if isinstance(text, str) else bytes(text)
    ncols = ctypes.c_int64(0)
    rows = lib.dl4j_csv_dims(data, len(data), delimiter.encode(),
                             ctypes.byref(ncols))
    if rows <= 0 or ncols.value <= 0:
        return np.zeros((0, 0), np.float32)
    out = np.empty((rows, ncols.value), np.float32)
    got = lib.dl4j_csv_parse(data, len(data), delimiter.encode(),
                             _f32p(out), rows, ncols.value)
    if got < 0:
        raise ValueError("ragged or non-numeric CSV")
    return out[:got]


def decode_idx(raw: bytes) -> Optional[Tuple[np.ndarray, Tuple[int, ...]]]:
    """IDX (MNIST) u8 container -> (float32 array scaled to [0,1], dims)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < 4:
        raise ValueError("truncated IDX file")
    # payload bound: total elements <= len(raw)
    out = np.empty(buf.size, np.float32)
    dims = np.zeros(4, np.int64)
    ndims = ctypes.c_int64(0)
    n = lib.dl4j_idx_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        _f32p(out), out.size, dims.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64)), ctypes.byref(ndims))
    if n < 0:
        raise ValueError("malformed IDX file")
    shape = tuple(int(d) for d in dims[:ndims.value])
    return out[:n].reshape(shape), shape


# -------------------------------------------------------------------------
# Fused pair generation (the Word2Vec/ParagraphVectors host producer).
# Thin ctypes shims — the walk semantics and the bitwise-identical numpy
# fallback live in nlp/pairgen.py.
# -------------------------------------------------------------------------

def pairgen_available() -> bool:
    """True when the loaded library carries the pairgen entry points."""
    lib = get_lib()
    return lib is not None and hasattr(lib, "dl4j_pairgen_walk")


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sm64_fill(seed: int, start: int, n: int) -> Optional[np.ndarray]:
    """Raw counter-based splitmix64 draws (parity probe)."""
    if not pairgen_available():
        return None
    out = np.empty(n, np.uint64)
    get_lib().dl4j_sm64_fill(
        ctypes.c_uint64(seed), start, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def pairgen_subsample(ids: np.ndarray, keep_p: np.ndarray,
                      seed: int) -> Optional[np.ndarray]:
    """Boolean keep mask for the flat corpus; None without the lib."""
    if not pairgen_available():
        return None
    ids = np.ascontiguousarray(ids, np.int32)
    keep_p = np.ascontiguousarray(keep_p, np.float64)
    out = np.empty(len(ids), np.uint8)
    get_lib().dl4j_pairgen_subsample(
        _i32p(ids), len(ids),
        keep_p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_uint64(seed), _u8p(out))
    return out.view(bool)


def pairgen_negatives(table: np.ndarray, positive: np.ndarray,
                      n_neg: int, n_words: int, nseed: int, n2seed: int,
                      pair_base: int) -> Optional[np.ndarray]:
    """(n, n_neg) fused negative-table draws; None without the lib."""
    if not pairgen_available() or n_neg <= 0:
        return None
    positive = np.ascontiguousarray(positive, np.int32)
    out = np.empty((len(positive), n_neg), np.int32)
    get_lib().dl4j_pairgen_negatives(
        _i32p(table), len(table), _i32p(positive), len(positive),
        n_neg, n_words, ctypes.c_uint64(nseed), ctypes.c_uint64(n2seed),
        pair_base, _i32p(out))
    return out


def pairgen_walk(ids: np.ndarray, pos: np.ndarray, length: np.ndarray,
                 lo: int, hi: int, window: int, wseed: int,
                 table: Optional[np.ndarray], n_neg: int, n_words: int,
                 nseed: int, n2seed: int, pair_base: int,
                 out_center: np.ndarray, out_context: np.ndarray,
                 out_negs: Optional[np.ndarray]) -> Optional[int]:
    """Fused SGNS/HS/DBOW window walk into caller-owned slab buffers;
    returns the pair count, or None without the lib."""
    if not pairgen_available():
        return None
    tbl = table if table is not None else np.empty(1, np.int32)
    return get_lib().dl4j_pairgen_walk(
        _i32p(ids), _i32p(pos), _i32p(length), lo, hi, window,
        ctypes.c_uint64(wseed), _i32p(tbl), len(tbl), n_neg, n_words,
        ctypes.c_uint64(nseed), ctypes.c_uint64(n2seed), pair_base,
        _i32p(out_center), _i32p(out_context),
        _i32p(out_negs if out_negs is not None else out_center))


def pairgen_walk_cbow(ids: np.ndarray, pos: np.ndarray,
                      length: np.ndarray, lo: int, hi: int, window: int,
                      wseed: int, table: Optional[np.ndarray],
                      n_neg: int, n_words: int, nseed: int, n2seed: int,
                      row_base: int, out_ctx: np.ndarray,
                      out_cmask: np.ndarray, out_center: np.ndarray,
                      out_negs: Optional[np.ndarray]) -> Optional[int]:
    """Fused CBOW row walk into caller-owned slab buffers; returns the
    row count, or None without the lib."""
    if not pairgen_available():
        return None
    tbl = table if table is not None else np.empty(1, np.int32)
    return get_lib().dl4j_pairgen_walk_cbow(
        _i32p(ids), _i32p(pos), _i32p(length), len(ids), lo, hi, window,
        ctypes.c_uint64(wseed), _i32p(tbl), len(tbl), n_neg, n_words,
        ctypes.c_uint64(nseed), ctypes.c_uint64(n2seed), row_base,
        _i32p(out_ctx), _f32p(out_cmask), _i32p(out_center),
        _i32p(out_negs if out_negs is not None else out_center))
