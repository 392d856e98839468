"""The shared artifact store.

From the JAX package's ``parallel/aot_cache.py``, ``ArtifactStore`` only
(a copy): one root directory holding one object directory per key, the
shared tier the generation engine's ``SessionStore`` writes its carry
checkpoints through. The persisted AOT executable cache itself
(``AOTCache``, fingerprints, StableHLO blobs) has no counterpart in the
port yet (ROADMAP).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

MANIFEST = "manifest.json"


class ArtifactStore:
    """Object-store bucket layout over the manifest format: one shared
    root holding one AOT cache dir per model key, so N serving nodes
    warm from ONE saved sweep with zero live compiles.

    Layout (local filesystem today, the key/object split maps 1:1 onto
    a GCS/S3 bucket later)::

        <root>/objects/<key>/manifest.json
        <root>/objects/<key>/bucket_<N>.<precision>.stablehlo
        <root>/objects/<key>/xla/...

    Concurrency relies on the cache's own discipline: the manifest is
    written atomically and LAST (a reader mid-save just misses), every
    entry is self-fingerprinted (a stale or foreign entry can never be
    served), and the sweep is bitwise-deterministic cross-process — so
    the first node to finish its sweep publishes, and every later node
    (or rejoiner) gets a warm start. No locks, no coordinator."""

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
        """The AOT cache dir for ``key`` (created if absent) — pass it
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
                "precisions": {p: len(e.get("buckets", []))
                               for p, e in entries.items()},
            }
        return out
