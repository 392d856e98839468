"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into ``build/``
at the checkout's root (git-ignored), and loaded with ``ctypes``. The file
name carries a hash of every source and of the flags, so a changed source
is rebuilt and a stale library is never loaded. ``build()`` starts one
``nvcc`` per source, all at once, and waits for all of them.

Nothing here runs at import: the CPU tests import every module, and only
a machine with a card and ``nvcc`` ever builds.
"""

from __future__ import annotations

import ctypes
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of every kernel entry point (ctypes would otherwise pass each
# argument as a 32-bit int and cut the pointers)
SIGNATURES = {
    "fused_mm": ("dl4j_fused_mm", [_P] * 7 + [_I] * 10 + [_P]),
    "fused_c3": ("dl4j_fused_c3", [_P] * 7 + [_I] * 9 + [_P]),
}

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


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` per source in parallel; raises with the compiler's output
    on any failure. Returns name -> library path."""
    names = list(SIGNATURES if names is None else names)
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
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = build([name])[name]
                lib = ctypes.CDLL(str(path))
                sym, argtypes = SIGNATURES[name]
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                lib.dl4j_tile_m.restype = ctypes.c_int
                lib.dl4j_split_count.argtypes = [ctypes.c_int]
                lib.dl4j_split_count.restype = ctypes.c_int
                _libs[name] = lib
    return getattr(lib, SIGNATURES[name][0])


def tile_m(name: str) -> int:
    """Rows per output tile of kernel ``name`` (its partial-stats count)."""
    kernel(name)
    return int(_libs[name].dl4j_tile_m())


def split_count(name: str, k: int) -> int:
    """K slices kernel ``name`` runs for a reduction depth ``k`` (its
    workspace holds that many f32 output planes when it is above 1)."""
    kernel(name)
    return int(_libs[name].dl4j_split_count(int(k)))
