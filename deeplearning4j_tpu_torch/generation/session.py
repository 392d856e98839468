"""SessionStore: retired-but-resumable decode carries.

The port of the JAX package's ``generation/session.py``. Multi-turn
generation re-pays the whole prefix on every request unless the (h, c)
carry survives retirement. This store keeps retired sequences'
per-slot state in three tiers:

- **device** — rows pinned on device (LRU, ``device_capacity``): a
  same-node resume re-scatters them without a host round-trip;
- **host** — LRU overflow lands as numpy rows (``host_capacity``);
- **store** — every save is written through to the shared
  :class:`~deeplearning4j_tpu_torch.parallel.aot_cache.ArtifactStore` (when
  configured), so a session started on node A resumes on node B after
  a SIGTERM drain — or node A's SIGKILL — with nothing but the session
  token. One key per session under ``objects/``, with the JAX
  package's AOT-cache integrity discipline: the carry blob is
  sha256-checksummed, the manifest is written atomically LAST, and a
  corrupt blob quarantines aside (``.quarantine``) instead of resuming
  garbage — the ``chaos_site("store.save")`` seam mangles the bytes
  under an armed chaos plan.

Snapshots carry everything continuation needs to be **bitwise** equal
to an undrained run: the f32 carry rows, the per-slot key row (chain
mode; the port's counter-hash key as two uint32 words, see
``decode.py``), the absolute position (counter mode), the tokens still
owed to the model (``pending`` — the retired sequence's last emitted
token, or its unconsumed prompt tail), and a history tail to reseed the
speculative draft table.

``carry_dtype="int8"`` quantizes stored rows through the
``ops/quantize.py`` primitives (symmetric, one scale per row) to raise
resumable sessions per chip ~4x; it trades the bitwise-resume guarantee
for capacity, so it is opt-in and recorded in the checkpoint manifest.
The int8 rows are host numpy, a copy of the JAX package's, so they are
the same bytes in both packages.

The device tier lives on ``device`` (the engine's; ``cuda`` unless the
caller passes ``device="cpu"``).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.chaos.hook import chaos_site
from deeplearning4j_tpu_torch.observe.registry import default_registry
from deeplearning4j_tpu_torch.ops.quantize import Q_MAX, activation_scale
from deeplearning4j_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

_CARRY_BLOB = "carry.npz"
_MANIFEST = "session.json"


class CarrySnapshot:
    """One retired sequence's resumable state (host representation)."""

    __slots__ = ("h", "c", "rng", "pending", "pos", "history")

    def __init__(self, h: List[np.ndarray], c: List[np.ndarray],
                 rng: np.ndarray, pending: List[int], pos: int,
                 history: List[int]):
        self.h = h
        self.c = c
        self.rng = rng
        self.pending = pending
        self.pos = pos
        self.history = history


def _quantize_rows(rows: List[np.ndarray]):
    """f32 rows -> (int8 rows, f32 scales) via the quantize.py
    conventions: symmetric, one scale per row (amax / 127, host-side
    numpy so the bytes are deterministic cross-process)."""
    qs, scales = [], []
    for r in rows:
        r = np.asarray(r, np.float32)  # host-sync-ok: carry rows arrive as host numpy
        scale = activation_scale(float(np.abs(r).max()))  # host-sync-ok: host numpy reduction
        q = np.clip(np.rint(r / scale), -Q_MAX, Q_MAX).astype(np.int8)
        qs.append(q)
        scales.append(np.float32(scale))
    return qs, np.asarray(scales, np.float32)  # host-sync-ok: host scalars


def _dequantize_rows(qs: List[np.ndarray], scales: np.ndarray):
    return [np.asarray(q, np.float32) * np.float32(s)  # host-sync-ok: host numpy dequant
            for q, s in zip(qs, scales)]


class _Entry:
    __slots__ = ("h", "c", "h_scales", "c_scales", "rng", "pending",
                 "pos", "history", "tier")

    def __init__(self, h, c, h_scales, c_scales, rng, pending, pos,
                 history, tier):
        self.h = h
        self.c = c
        self.h_scales = h_scales
        self.c_scales = c_scales
        self.rng = rng
        self.pending = pending
        self.pos = pos
        self.history = history
        self.tier = tier


class SessionStore:
    """Tiered LRU of resumable carries, keyed by session token."""

    def __init__(self, spec, *, device_capacity: int = 32,
                 host_capacity: int = 256, store=None,
                 store_prefix: str = "gen-session",
                 carry_dtype: str = "f32", registry=None,
                 session_id: str = "generate", device=None):
        if carry_dtype not in ("f32", "int8"):
            raise ValueError(f"unknown carry_dtype {carry_dtype!r}")
        self.spec = spec
        self.device = resolve_device(device)
        self.device_capacity = int(device_capacity)
        self.host_capacity = int(host_capacity)
        self.store = store
        self.store_prefix = store_prefix
        self.carry_dtype = carry_dtype
        self.session_id = session_id
        self._chaos_save = chaos_site("store.save")
        self._lock = threading.Lock()
        # token -> _Entry; order = LRU (least recent first)
        self._device: "OrderedDict[str, _Entry]" = OrderedDict()
        self._host: "OrderedDict[str, _Entry]" = OrderedDict()
        self.hits: Dict[str, int] = {"device": 0, "host": 0, "store": 0}
        self.misses = 0
        self.evictions = 0
        self.quarantined = 0
        r = registry if registry is not None else default_registry()
        self._c_hits = r.counter(
            "dl4j_gen_session_hits_total",
            "session resumes served, by carry tier (device-pinned rows"
            " | host LRU | shared artifact store)")
        self._c_miss = r.counter(
            "dl4j_gen_session_misses_total",
            "session tokens with no resumable carry in any tier "
            "(fresh sequence started)")
        self._c_evict = r.counter(
            "dl4j_gen_session_evictions_total",
            "session carries pushed down a tier by LRU pressure; "
            "tier=host (device->host) | dropped (host->store-only)")
        self._g_resident = r.gauge(
            "dl4j_gen_session_resident",
            "resumable session carries currently held, by tier")
        for tier in ("device", "host", "store"):
            self._c_hits.inc(0.0, session=session_id, tier=tier)
        self._c_miss.inc(0.0, session=session_id)
        for tier in ("host", "dropped"):
            self._c_evict.inc(0.0, session=session_id, tier=tier)
        self._g_resident.set(0.0, session=session_id, tier="device")
        self._g_resident.set(0.0, session=session_id, tier="host")

    # ---- tiering -----------------------------------------------------

    def _gauges_locked(self):
        self._g_resident.set(float(len(self._device)),  # host-sync-ok: python dict length gauge, no device value
                             session=self.session_id, tier="device")
        self._g_resident.set(float(len(self._host)),  # host-sync-ok: python dict length gauge, no device value
                             session=self.session_id, tier="host")

    def _to_host_entry(self, e: _Entry) -> _Entry:
        """Fetch a device-tier entry's rows to host numpy."""
        e.h = [x.cpu().numpy() for x in e.h]
        e.c = [x.cpu().numpy() for x in e.c]
        e.tier = "host"
        return e

    def _to_device(self, rows: List[np.ndarray]) -> List[torch.Tensor]:
        """Rows onto the device tier; waits for the copies, so a later
        read from another thread or stream sees them (once per retired
        sequence, off the per-token path)."""
        out = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
               for x in rows]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def save(self, token: str, snap: CarrySnapshot) -> None:
        """Insert/refresh a resumable carry. Device-pins the rows (LRU
        evicting to the host tier, which LRU-drops in turn) and writes
        through to the artifact store when one is configured — the
        write-through is what makes SIGKILL survivable."""
        self._insert(token, snap, checkpoint=True)

    def _insert(self, token: str, snap: CarrySnapshot,
                checkpoint: bool) -> None:
        h, c = snap.h, snap.c
        h_scales = c_scales = None
        if self.carry_dtype == "int8":
            h, h_scales = _quantize_rows(h)
            c, c_scales = _quantize_rows(c)
        if checkpoint and self.store is not None:
            self._checkpoint(token, h, c, h_scales, c_scales, snap)
        e = _Entry(self._to_device(h), self._to_device(c),
                   h_scales, c_scales,
                   np.asarray(snap.rng, np.uint32),  # host-sync-ok: snapshot rng is host numpy
                   list(snap.pending), int(snap.pos),
                   list(snap.history), "device")
        with self._lock:
            self._device.pop(token, None)
            self._host.pop(token, None)
            self._device[token] = e
            while len(self._device) > self.device_capacity:
                old_tok, old = self._device.popitem(last=False)
                self._host[old_tok] = self._to_host_entry(old)
                self.evictions += 1
                self._c_evict.inc(1.0, session=self.session_id,
                                  tier="host")
            while len(self._host) > self.host_capacity:
                self._host.popitem(last=False)
                self.evictions += 1
                self._c_evict.inc(1.0, session=self.session_id,
                                  tier="dropped")
            self._gauges_locked()

    def load(self, token: str) -> Optional[CarrySnapshot]:
        """Resumable carry for ``token``, or None (miss). Checks tiers
        in device -> host -> store order; a store hit repopulates the
        device tier so the next resume on this node is local."""
        with self._lock:
            e = self._device.pop(token, None)
            if e is not None:
                self._device[token] = e          # refresh LRU position
                self.hits["device"] += 1
                self._c_hits.inc(1.0, session=self.session_id,
                                 tier="device")
                return self._snap_of(e)
            e = self._host.pop(token, None)
            if e is not None:
                self._host[token] = e
                self.hits["host"] += 1
                self._c_hits.inc(1.0, session=self.session_id,
                                 tier="host")
                return self._snap_of(e)
        snap = self._load_checkpoint(token)
        if snap is not None:
            with self._lock:
                self.hits["store"] += 1
                self._c_hits.inc(1.0, session=self.session_id,
                                 tier="store")
            return snap
        with self._lock:
            self.misses += 1
            self._c_miss.inc(1.0, session=self.session_id)
        return None

    def resident(self, token: str) -> Optional[str]:
        """Tier holding ``token`` locally (``"device"``/``"host"``) or
        None — the router's session-affinity signal."""
        with self._lock:
            if token in self._device:
                return "device"
            if token in self._host:
                return "host"
        return None

    def _snap_of(self, e: _Entry) -> CarrySnapshot:
        h, c = e.h, e.c
        if e.tier == "device":
            h = [x.cpu().numpy() for x in h]
            c = [x.cpu().numpy() for x in c]
        if self.carry_dtype == "int8":
            h = _dequantize_rows(h, e.h_scales)
            c = _dequantize_rows(c, e.c_scales)
        else:
            h = [np.asarray(x, np.float32) for x in h]  # host-sync-ok: host-tier rows, already numpy
            c = [np.asarray(x, np.float32) for x in c]  # host-sync-ok: host-tier rows, already numpy
        return CarrySnapshot(h, c, np.asarray(e.rng, np.uint32),  # host-sync-ok: rng row is host numpy
                             list(e.pending), e.pos, list(e.history))

    # ---- artifact-store checkpoint -----------------------------------

    def _dir(self, token: str) -> str:
        return self.store.cache_dir(f"{self.store_prefix}-{token}")

    def _checkpoint(self, token, h, c, h_scales, c_scales,
                    snap: CarrySnapshot) -> None:
        try:
            d = self._dir(token)
            buf = io.BytesIO()
            arrays: Dict[str, np.ndarray] = {
                "rng": np.asarray(snap.rng, np.uint32),  # host-sync-ok: checkpoint serialization, host numpy
                "pending": np.asarray(snap.pending, np.int32),  # host-sync-ok: checkpoint serialization, host list
                "history": np.asarray(snap.history, np.int32),  # host-sync-ok: checkpoint serialization, host list
                "pos": np.asarray([snap.pos], np.int64),  # host-sync-ok: checkpoint serialization, host int
            }
            for i, (hr, cr) in enumerate(zip(h, c)):
                arrays[f"h_{i}"] = np.asarray(hr)  # host-sync-ok: checkpoint serialization, host numpy
                arrays[f"c_{i}"] = np.asarray(cr)  # host-sync-ok: checkpoint serialization, host numpy
            if h_scales is not None:
                arrays["h_scales"] = h_scales
                arrays["c_scales"] = c_scales
            np.savez(buf, **arrays)
            blob = buf.getvalue()
            checksum = hashlib.sha256(blob).hexdigest()
            if self._chaos_save is not None:
                blob, _ = self._chaos_save.mangle(blob, arg="blob")
            with open(os.path.join(d, _CARRY_BLOB), "wb") as f:  # graftlint: disable=atomic-write: blob bytes are sha256-checksummed and only become visible through the manifest's atomic os.replace below; a torn blob quarantines at load
                f.write(blob)
            data = json.dumps({
                "checksum": checksum,
                "carry_dtype": self.carry_dtype,
                "hidden_sizes": list(self.spec.hidden_sizes),
                "pos": int(snap.pos),
            }).encode("utf-8")
            if self._chaos_save is not None:
                data, _ = self._chaos_save.mangle(data, arg="manifest")
            tmp = os.path.join(d, _MANIFEST + ".tmp")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(d, _MANIFEST))
        except OSError:
            log.exception("session checkpoint failed for %s", token)

    def _load_checkpoint(self, token: str) -> Optional[CarrySnapshot]:
        if self.store is None:
            return None
        try:
            d = self._dir(token)
            with open(os.path.join(d, _MANIFEST)) as f:
                meta = json.load(f)
            blob_path = os.path.join(d, _CARRY_BLOB)
            with open(blob_path, "rb") as f:
                raw = f.read()
        except (OSError, json.JSONDecodeError):
            return None
        want = meta.get("checksum")
        if want is not None and \
                hashlib.sha256(raw).hexdigest() != want:
            # torn or bit-rotted carry: quarantine it and report a miss
            # — a resume must NEVER continue from corrupt state
            self.quarantined += 1
            try:
                os.replace(blob_path, blob_path + ".quarantine")
            except OSError:
                pass
            log.warning("session %s: carry checksum mismatch, "
                        "quarantined", token)
            return None
        if list(meta.get("hidden_sizes", [])) != \
                list(self.spec.hidden_sizes):
            return None                   # foreign model's carry: miss
        try:
            z = np.load(io.BytesIO(raw), allow_pickle=False)
            n = len(self.spec.hidden_sizes)
            h = [z[f"h_{i}"] for i in range(n)]
            c = [z[f"c_{i}"] for i in range(n)]
            if meta.get("carry_dtype") == "int8":
                h = _dequantize_rows(h, z["h_scales"])
                c = _dequantize_rows(c, z["c_scales"])
            else:
                h = [np.asarray(x, np.float32) for x in h]  # host-sync-ok: npz load, host numpy
                c = [np.asarray(x, np.float32) for x in c]  # host-sync-ok: npz load, host numpy
            snap = CarrySnapshot(
                h, c, np.asarray(z["rng"], np.uint32),  # host-sync-ok: npz load, host numpy
                [int(t) for t in z["pending"]],
                int(z["pos"][0]),
                [int(t) for t in z["history"]])
        except Exception:
            log.exception("session %s: unreadable carry blob", token)
            return None
        # repopulate the local tiers (no re-checkpoint: the store copy
        # is already the bytes we just verified) so the next resume on
        # this node skips the store round-trip
        self._insert(token, snap, checkpoint=False)
        return snap

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "carry_dtype": self.carry_dtype,
                "resident": {"device": len(self._device),
                             "host": len(self._host)},
                "capacity": {"device": self.device_capacity,
                             "host": self.host_capacity},
                "hits": dict(self.hits),
                "misses": self.misses,
                "evictions": self.evictions,
                "quarantined": self.quarantined,
                "store": (str(getattr(self.store, "root", None))
                          if self.store is not None else None),
            }
