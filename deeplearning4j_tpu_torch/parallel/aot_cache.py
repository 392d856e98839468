"""Persisted kernel cache for the serving engine, and the artifact store.

The JAX package persists, per ladder bucket, a StableHLO export and the
XLA executable compiled from it, so that a fresh process skips tracing
and compiling. The eager port traces nothing and compiles no executable:
the one compile a cold port process pays is ``nvcc`` building the
hand-written kernel libraries (ops/cuda_build.py,
``build/kernels/lib<source>_<digest>.so``). So ``AOTExecutableCache``
persists the built libraries of the sources the engine's forward
reaches, with the JAX cache's discipline kept whole:

- **Manifest.** ``manifest.json`` holds one entry per precision, each
  with its fingerprint (``fingerprint``): model version and weights
  digest, the params and state spec, the serving contract (feature
  shape, dtype, ladder, precision, calibration) and, in place of jax,
  jaxlib and the backend, the torch version, the CUDA version, the
  device name and compute capability, and ``cuda_build._digest()`` (the
  kernel sources and the ``nvcc`` flags). ``try_load`` compares the
  fields one by one; any mismatch falls through to a live build and
  records the field that diverged.
- **Blobs.** Each library is a blob named as ``library_path`` names it,
  checksummed (sha256) in the manifest. A blob that fails its checksum
  is quarantined (renamed ``.quarantine``) and its source built live.
- **Atomic save.** Blobs first, the manifest last, written to a
  temporary file and renamed.
- **One loading path.** A hit puts the library where
  ``cuda_build.library_path`` expects it (``cuda_build.install``) and
  ``cuda_build.kernel`` loads it as it loads one it built. The kernels
  digest in the fingerprint and in the file name means a warm node
  launches the library a build of its own tree would make, never one
  built from other sources.

An entry whose forward reaches no library (a model served on the CPU,
where the kernel wrappers run their plain versions) is saved and
matched like any other, with no blobs.

There is no counterpart of the JAX module's ``enable_xla_cache``: the
port has no XLA compilation cache to point anywhere.

``ArtifactStore`` is the shared store over the same layout (a copy of
the JAX package's): one root directory holding one object directory per
key; the generation engine's ``SessionStore``, the retrieval index, the
corpus shards and ``optimize/autotune.py``'s tuned configs write through
it too.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.models.serialization import flatten_paths
from deeplearning4j_tpu_torch.ops import cuda_build

MANIFEST = "manifest.json"
# the port's own manifest format (per-precision entries of libraries); a
# JAX package's cache dir (format 2) reads as a format_version mismatch
FORMAT_VERSION = "torch-1"


def _sorted_leaves(tree):
    """The leaves of nested dicts in sorted-key order at every level (the
    order ``jax.tree_util.tree_leaves`` gives a dict tree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    elif tree is not None:
        yield tree


def _leaf_dtype(t) -> str:
    return str(t.dtype).replace("torch.", "") if isinstance(
        t, torch.Tensor) else str(np.asarray(t).dtype)


def _leaf_bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)          # the raw bits, as JAX's
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def weights_digest(params) -> str:
    """sha256 over every leaf's shape, dtype name and bytes, leaves in
    sorted-key order: the JAX package's digest of the same values. A
    one-time device-to-host read at engine start, not a hot path."""
    h = hashlib.sha256()
    for leaf in _sorted_leaves(params):
        h.update(str(tuple(leaf.shape)).encode())
        h.update(_leaf_dtype(leaf).encode())
        h.update(_leaf_bytes(leaf))
    return h.hexdigest()


def _tree_spec(tree) -> list:
    """The tree's leaf paths with each leaf's shape and dtype (metadata
    only, no device reads)."""
    flat = flatten_paths(tree)
    return [sorted(flat), [[list(flat[k].shape), _leaf_dtype(flat[k])]
                           for k in sorted(flat)]]


def backend_of(device) -> Dict[str, Any]:
    """What a persisted artifact's validity depends on about the device:
    its kind (``cuda`` or ``cpu``), its name and, on the card, its
    compute capability."""
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return {"platform": "cuda",
                "device_kind": torch.cuda.get_device_name(idx),
                "capability": list(torch.cuda.get_device_capability(idx))}
    return {"platform": "cpu", "device_kind": platform.machine() or "cpu",
            "capability": None}


def fingerprint(params, mstate, *, feature_shape, dtype, ladder,
                precision: str = "f32",
                calibration: Optional[str] = None,
                model_version: Optional[str] = None,
                device="cuda") -> Dict:
    """Everything a persisted library's use by an engine depends on.

    ``precision`` is the PrecisionPolicy tag (f32/bf16/int8) and
    ``calibration`` the int8 calibration hash: a quantized entry never
    satisfies an f32 lookup, and a re-calibrated model is never served
    from a stale entry. ``kernels`` is the digest of the kernel sources
    and flags the libraries were built from."""
    return {
        "format_version": FORMAT_VERSION,
        "model_version": model_version,
        "weights_sha256": weights_digest(params),
        "params_spec": _tree_spec(params),
        "model_state_spec": _tree_spec(mstate),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": backend_of(device),
        "kernels": cuda_build._digest(),
        "serving": {"feature_shape": list(feature_shape),
                    "dtype": str(np.dtype(dtype)),
                    "ladder": list(ladder),
                    "precision": str(precision),
                    "calibration": calibration},
    }


def _first_mismatch(want: Dict, got: Dict, prefix: str = "") -> Optional[str]:
    for k in want:
        w, g = want[k], got.get(k)
        if isinstance(w, dict) and isinstance(g, dict):
            sub = _first_mismatch(w, g, f"{prefix}{k}.")
            if sub:
                return sub
        elif w != g:
            return f"{prefix}{k}"
    return None


def _dig(d: Dict, dotted: str):
    for part in dotted.split("."):
        if not isinstance(d, dict):
            return None
        d = d.get(part)
    return d


def _mismatch_reason(fp: Dict, got_fp: Dict, diff: str) -> str:
    """Names the diverged field; for a scalar field it also shows both
    values, so a rejected entry states what it held."""
    want_v, got_v = _dig(fp, diff), _dig(got_fp, diff)
    if all(isinstance(v, (str, int, float, bool, type(None)))
           for v in (want_v, got_v)):
        def short(v):
            s = repr(v)
            return s[:20] + "..." if len(s) > 23 else s
        return (f"fingerprint field {diff!r} diverged "
                f"(want {short(want_v)}, got {short(got_v)})")
    return f"fingerprint field {diff!r} diverged"


def _quarantined_counter(registry=None):
    if registry is None:
        from deeplearning4j_tpu_torch.observe.registry import (
            default_registry)
        registry = default_registry()
    return registry.counter(
        "dl4j_aot_quarantined_total",
        "corrupt persisted-cache blobs moved aside (content checksum); "
        "each falls through to a live build")


class AOTExecutableCache:
    """One serving engine's view of a persisted table of kernel libraries.

    ``state`` after ``try_load``:

    - ``"warm"``      the entry matched and every library was restored
    - ``"cold"``      no manifest, or no entry for this precision yet
      (``save`` fills it)
    - ``"mismatch"``  an entry was found but its fingerprint diverged
      (``reason`` names the first differing field), or a blob failed its
      checksum and was quarantined; the libraries are built live and
      ``save`` rewrites the entry
    """

    def __init__(self, cache_dir: str, registry=None):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.state = "cold"
        self.reason: Optional[str] = None
        self.hits = 0            # libraries restored from a blob
        self.misses = 0          # libraries the cache could not supply
        self.quarantined = 0     # blobs failing their content checksum
        self.saved = 0           # libraries written by save()
        self.restored: List[str] = []
        self._registry = registry
        self._chaos_save = chaos_site("store.save")

    @staticmethod
    def _precision_of(fp: Dict) -> str:
        return str(fp.get("serving", {}).get("precision", "f32"))

    @staticmethod
    def _blob_name(source: str) -> str:
        return cuda_build.library_path(source).name

    # ---- load ------------------------------------------------------------
    def try_load(self, fp: Dict) -> List[str]:
        """Restore every library of the entry FOR THIS PRECISION when its
        fingerprint matches ``fp``; returns the sources restored (state
        and reason record why not). Other precisions' entries can
        neither satisfy nor invalidate the lookup."""
        path = self.dir / MANIFEST
        if not path.exists():
            self.state = "cold"
            return []
        try:
            manifest = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            self.state = "mismatch"
            self.reason = f"unreadable manifest: {type(e).__name__}"
            return []
        precision = self._precision_of(fp)
        entries = manifest.get("entries")
        if not isinstance(entries, dict):
            # a single-fingerprint manifest: diff against it so the
            # reason names the real divergence; save() rewrites it
            entry = {"fingerprint": manifest.get("fingerprint", {})}
        else:
            entry = entries.get(precision)
            if entry is None:
                self.state = "cold"
                self.reason = (f"no {precision!r} entry (cache holds "
                               f"{sorted(entries)})")
                return []
        got_fp = entry.get("fingerprint", {})
        diff = _first_mismatch(fp, got_fp)
        if diff is not None:
            self.state = "mismatch"
            self.reason = _mismatch_reason(fp, got_fp, diff)
            return []
        checksums = entry.get("checksums") or {}
        complete = True
        for source in entry.get("libraries", []):
            blob = self.dir / self._blob_name(source)
            try:
                raw = blob.read_bytes()
            except OSError as e:
                self.misses += 1
                complete = False
                self.reason = f"library {source}: {type(e).__name__}"
                continue
            if hashlib.sha256(raw).hexdigest() != checksums.get(source):
                # a torn or bit-rotted blob: moved aside, its source
                # built live; a warming node never loads it
                self._quarantine(blob, source)
                complete = False
                continue
            cuda_build.install(source, raw)
            self.hits += 1
            self.restored.append(source)
        self.state = "warm" if complete else "mismatch"
        return list(self.restored)

    def _quarantine(self, blob: Path, source: str) -> None:
        """Move a corrupt blob aside (``.quarantine``) so later loads do
        not pay the checksum failure again and the next ``save``
        republishes a clean blob under the original name."""
        self.misses += 1
        self.quarantined += 1
        self.reason = f"library {source}: quarantined (checksum)"
        try:
            os.replace(blob, str(blob) + ".quarantine")
        except OSError:
            pass
        _quarantined_counter(self._registry).inc(1.0, library=source,
                                                 reason="checksum")

    # ---- save ------------------------------------------------------------
    def save(self, fp: Dict, sources) -> int:
        """Persist the built library of each of ``sources``, then write
        this precision's manifest entry (atomically, last: a crash
        mid-save leaves a cache that simply misses). Sibling precisions
        keep their entries. Returns the number of libraries saved."""
        precision = self._precision_of(fp)
        saved: List[str] = []
        checksums: Dict[str, str] = {}
        for source in sorted(sources):
            try:
                blob = cuda_build.library_path(source).read_bytes()
            except OSError:
                continue             # not built here: the next node builds
            # the checksum of the TRUE bytes, so that corruption between
            # save and load (or an armed chaos plan below) is caught
            checksums[source] = hashlib.sha256(blob).hexdigest()
            if self._chaos_save is not None:
                blob, _ = self._chaos_save.mangle(blob, arg="blob")
            (self.dir / self._blob_name(source)).write_bytes(blob)
            saved.append(source)
        entries: Dict[str, Any] = {}
        try:
            old = json.loads((self.dir / MANIFEST).read_text())
            if old.get("format_version") == FORMAT_VERSION:
                entries = dict(old.get("entries") or {})
        except (OSError, ValueError, AttributeError):
            pass
        entries[precision] = {"fingerprint": fp, "libraries": saved,
                              "checksums": checksums}
        data = json.dumps({"format_version": FORMAT_VERSION,
                           "entries": entries}, indent=2).encode("utf-8")
        if self._chaos_save is not None:
            data, _ = self._chaos_save.mangle(data, arg="manifest")
        tmp = self.dir / (MANIFEST + f".{os.getpid()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, self.dir / MANIFEST)
        self.saved += len(saved)
        return len(saved)

    def stats(self) -> Dict[str, Any]:
        return {"state": self.state, "reason": self.reason,
                "hits": self.hits, "misses": self.misses,
                "quarantined": self.quarantined, "saved": self.saved,
                "libraries": list(self.restored), "dir": str(self.dir)}


class ArtifactStore:
    """Object-store bucket layout over the manifest format: one shared
    root holding one cache dir per model key, so N serving nodes warm
    from ONE saved sweep with no live build.

    Layout (local filesystem today, the key/object split maps 1:1 onto
    a GCS/S3 bucket later)::

        <root>/objects/<key>/manifest.json
        <root>/objects/<key>/lib<source>_<digest>.so

    Concurrency relies on the cache's own discipline: the manifest is
    written atomically and LAST (a reader mid-save just misses), and
    every entry is self-fingerprinted (a stale or foreign entry can never
    be served) — so the first node to finish its sweep publishes, and
    every later node (or rejoiner) gets a warm start. No locks, no
    coordinator."""

    def __init__(self, root: str):
        self.root = Path(root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)

    @staticmethod
    def _safe_key(key: str) -> str:
        import re
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(key))
        if not safe or safe in (".", ".."):
            raise ValueError(f"unusable artifact key {key!r}")
        return safe

    def cache_dir(self, key: str) -> str:
        """The cache dir for ``key`` (created if absent) — pass it
        straight to a ServingEngine's ``aot_cache_dir``."""
        d = self.root / "objects" / self._safe_key(key)
        d.mkdir(parents=True, exist_ok=True)
        return str(d)

    def keys(self) -> list:
        base = self.root / "objects"
        return sorted(p.name for p in base.iterdir() if p.is_dir())

    def manifest(self, key: str) -> Optional[Dict[str, Any]]:
        path = (self.root / "objects" / self._safe_key(key) / MANIFEST)
        try:
            return json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"root": str(self.root), "keys": {}}
        for key in self.keys():
            m = self.manifest(key)
            entries = (m or {}).get("entries") or {}
            out["keys"][key] = {
                "published": m is not None,
                "precisions": {p: len(e.get("libraries",
                                            e.get("buckets", [])))
                               for p, e in entries.items()},
            }
        return out
