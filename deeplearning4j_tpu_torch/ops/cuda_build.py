"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into ``build/``
at the checkout's root (git-ignored), and loaded with ``ctypes``. A
library may hold several kernels' entry points (``fused_c3_bwd.cu`` holds
the merged 3×3 backward and its two split halves, ``flash_bwd.cu`` the
two attention backward passes) and helpers that size
a kernel's scratch (``dl4j_tile_m``, ``dl4j_split_count``), each bound
where its library has it. The file name carries a hash of every source and
of the flags, so a changed source is rebuilt and a stale library is never
loaded. ``build()`` starts one
``nvcc`` per source, all at once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and only
a machine with a card and ``nvcc`` ever builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signature of every kernel entry point (ctypes would otherwise pass each
# argument as a 32-bit int and cut the pointers)
SIGNATURES = {
    "fused_mm": ("dl4j_fused_mm", [_P] * 7 + [_I] * 12 + [_P]),
    "fused_c3": ("dl4j_fused_c3", [_P] * 7 + [_I] * 9 + [_P]),
    "fused_mm_bwd": ("dl4j_fused_mm_bwd", [_P] * 13 + [_I] * 12 + [_P]),
    "fused_c3_bwd": ("dl4j_fused_c3_bwd", [_P] * 14 + [_I] * 12 + [_P]),
    "fused_c3_bwd_in": ("dl4j_fused_c3_bwd_in", [_P] * 12 + [_I] * 11 + [_P]),
    "fused_c3_bwd_w": ("dl4j_fused_c3_bwd_w", [_P] * 9 + [_I] * 9 + [_P]),
    "lstm_fwd": ("dl4j_lstm_fwd", [_P] * 12 + [_I] * 12 + [_P]),
    "lstm_bwd": ("dl4j_lstm_bwd", [_P] * 15 + [_I] * 9 + [_P]),
    # the flash kernels take each strided input's (n, t, h) strides
    "flash_fwd": ("dl4j_flash_fwd", [_P] * 6 + [_I] * 8 + [_L] * 9 + [_P]),
    "flash_bwd_dkv": ("dl4j_flash_bwd_dkv",
                      [_P] * 9 + [_I] * 8 + [_L] * 12 + [_P]),
    "flash_bwd_dq": ("dl4j_flash_bwd_dq",
                     [_P] * 8 + [_I] * 8 + [_L] * 12 + [_P]),
}
# kernel -> the csrc/<source>.cu whose library holds its entry point
SOURCE_OF = {name: name for name in SIGNATURES}
SOURCE_OF.update(fused_c3_bwd_in="fused_c3_bwd", fused_c3_bwd_w="fused_c3_bwd",
                 flash_bwd_dkv="flash_bwd", flash_bwd_dq="flash_bwd")
SOURCES = tuple(dict.fromkeys(SOURCE_OF.values()))

# helpers a library may export: scratch sizing (int -> int), the LSTM
# barrier probe and the cluster occupancy query
_HELPERS = {"dl4j_tile_m": [], "dl4j_split_count": [_I],
            "dl4j_lstm_barrier_probe": [_I] * 5 + [_P],
            "dl4j_lstm_max_clusters": [_I] * 3}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the build this process ran
build_log: Dict[str, tuple] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or put the CUDA toolkit's bin on PATH); "
        "the port's CUDA kernels are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{source}_{_digest()}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library of the sources ``names`` (default:
    all), one ``nvcc`` per source in parallel; raises with the compiler's
    output on any failure. Returns source -> library path."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[n] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded on first
    use; its argtypes are set and it returns ``cudaGetLastError()``."""
    source = SOURCE_OF[name]
    lib = _libs.get(source)
    if lib is None:
        with _lock:
            lib = _libs.get(source)
            if lib is None:
                path = build([source])[source]
                lib = ctypes.CDLL(str(path))
                for sym, argtypes in (SIGNATURES[k] for k, src
                                      in SOURCE_OF.items() if src == source):
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                for sym, argtypes in _HELPERS.items():
                    if hasattr(lib, sym):
                        fn = getattr(lib, sym)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                _libs[source] = lib
    return getattr(lib, SIGNATURES[name][0])


def current_stream(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``
    (a CUDA ``torch.device`` with its index), as an int: what a launch
    takes, without building a ``torch.cuda.Stream`` object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def helper(name: str, sym: str):
    """The helper ``sym`` of kernel ``name``'s library (built and loaded
    on first use)."""
    kernel(name)
    return getattr(_libs[SOURCE_OF[name]], sym)


@functools.lru_cache(maxsize=None)
def tile_m(name: str) -> int:
    """Rows per output tile of kernel ``name`` (its partial-stats count);
    fixed once its library is loaded, so asked once a process."""
    return int(helper(name, "dl4j_tile_m")())


@functools.lru_cache(maxsize=4096)
def split_count(name: str, k: int) -> int:
    """K slices kernel ``name`` runs for a reduction depth ``k`` (its
    workspace holds that many f32 output planes when it is above 1); a
    function of its arguments, asked once a process for each."""
    return int(helper(name, "dl4j_split_count")(int(k)))

