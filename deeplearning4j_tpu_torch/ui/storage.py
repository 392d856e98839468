"""Stats storage: persistence for training-stats records.

Analog of the reference's StatsStorage SPI
(deeplearning4j-core/.../api/storage/StatsStorage.java) and its
implementations (ui-model mapdb/sqlite/in-memory). Records are
JSON dicts (the SBE wire format's role is served by compact JSON):
  {"session_id", "type_id", "worker_id", "timestamp", ...payload}

``RemoteUIStatsStorageRouter`` posts records to a remote UI server
(reference: RemoteUIStatsStorageRouter HTTP POST → RemoteReceiverModule),
which is how distributed workers report to one dashboard.
"""

from __future__ import annotations

import contextlib
import json
import logging
import queue
import sqlite3
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional


class StatsStorageRouter:
    """Write-side SPI (reference: api/storage/StatsStorageRouter.java)."""

    def put_static_info(self, record: dict):
        raise NotImplementedError

    def put_update(self, record: dict):
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read side (reference: StatsStorage.java): list sessions/workers,
    fetch updates; listeners fire on new records."""

    def __init__(self):
        self._listeners: List[Callable[[dict], None]] = []

    def register_stats_storage_listener(self, fn: Callable[[dict], None]):
        self._listeners.append(fn)

    def _notify(self, record: dict):
        for fn in self._listeners:
            fn(record)

    # read API
    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def list_workers(self, session_id: str) -> List[str]:
        raise NotImplementedError

    def get_all_updates(self, session_id: str,
                        worker_id: Optional[str] = None) -> List[dict]:
        raise NotImplementedError

    def get_static_info(self, session_id: str) -> Optional[dict]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[dict]:
        ups = self.get_all_updates(session_id)
        return ups[-1] if ups else None


class InMemoryStatsStorage(StatsStorage):
    """reference: ui-model/.../storage/impl/ InMemoryStatsStorage."""

    def __init__(self):
        super().__init__()
        self._static: Dict[str, dict] = {}
        self._updates: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, record: dict):
        with self._lock:
            self._static[record["session_id"]] = record
        self._notify(record)

    def put_update(self, record: dict):
        with self._lock:
            self._updates.setdefault(record["session_id"], []).append(record)
        self._notify(record)

    def list_session_ids(self) -> List[str]:
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def list_workers(self, session_id: str) -> List[str]:
        with self._lock:
            return sorted({u.get("worker_id", "w0")
                           for u in self._updates.get(session_id, [])})

    def get_all_updates(self, session_id: str,
                        worker_id: Optional[str] = None) -> List[dict]:
        with self._lock:
            ups = list(self._updates.get(session_id, []))
        if worker_id is not None:
            ups = [u for u in ups if u.get("worker_id") == worker_id]
        return ups

    def get_static_info(self, session_id: str) -> Optional[dict]:
        with self._lock:
            return self._static.get(session_id)


class SqliteStatsStorage(StatsStorage):
    """File-backed storage (reference: J7FileStatsStorage over MapDB /
    sqlite). One table of records; safe across processes.
    Records persist in the compact binary stats codec
    (ui/codec.py — the SBE-codec role), cutting blob size ~2-4× on
    histogram-bearing updates; pre-existing JSON rows still read.
    The codec carries float arrays (and numeric lists of >=8 items) at
    f32 width, matching the reference's 32-bit SBE floats — f64 stats
    values lose precision on round-trip."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._lock = threading.Lock()
        with self._conn() as c:
            c.execute("CREATE TABLE IF NOT EXISTS records ("
                      "session_id TEXT, kind TEXT, ts REAL, blob TEXT)")
            c.execute("CREATE INDEX IF NOT EXISTS idx_sess ON records "
                      "(session_id, kind, ts)")

    @contextlib.contextmanager
    def _conn(self):
        # sqlite3's context manager only commits; close explicitly so a
        # per-iteration put doesn't leak a file descriptor
        conn = sqlite3.connect(self.path)
        try:
            with conn:
                yield conn
        finally:
            conn.close()

    def put_static_info(self, record: dict):
        self._put(record, "static")

    def put_update(self, record: dict):
        self._put(record, "update")

    def _put(self, record: dict, kind: str):
        from deeplearning4j_tpu_torch.ui.codec import encode_stats_record
        with self._lock, self._conn() as c:
            c.execute("INSERT INTO records VALUES (?,?,?,?)",
                      (record["session_id"], kind,
                       record.get("timestamp", 0.0),
                       encode_stats_record(record)))
        self._notify(record)

    @staticmethod
    def _load(blob) -> dict:
        """Binary codec rows (current) or JSON rows (pre-round-4)."""
        from deeplearning4j_tpu_torch.ui.codec import (
            decode_stats_record, is_stats_record)
        if isinstance(blob, (bytes, bytearray)) and is_stats_record(
                bytes(blob)):
            return decode_stats_record(bytes(blob))
        if isinstance(blob, (bytes, bytearray)):
            blob = blob.decode("utf-8")
        return json.loads(blob)

    def list_session_ids(self) -> List[str]:
        with self._lock, self._conn() as c:
            rows = c.execute(
                "SELECT DISTINCT session_id FROM records").fetchall()
        return sorted(r[0] for r in rows)

    def list_workers(self, session_id: str) -> List[str]:
        return sorted({u.get("worker_id", "w0")
                       for u in self.get_all_updates(session_id)})

    def get_all_updates(self, session_id: str,
                        worker_id: Optional[str] = None) -> List[dict]:
        with self._lock, self._conn() as c:
            rows = c.execute(
                "SELECT blob FROM records WHERE session_id=? AND kind="
                "'update' ORDER BY ts, rowid", (session_id,)).fetchall()
        ups = [self._load(r[0]) for r in rows]
        if worker_id is not None:
            ups = [u for u in ups if u.get("worker_id") == worker_id]
        return ups

    def get_static_info(self, session_id: str) -> Optional[dict]:
        with self._lock, self._conn() as c:
            rows = c.execute(
                "SELECT blob FROM records WHERE session_id=? AND kind="
                "'static' ORDER BY ts DESC LIMIT 1",
                (session_id,)).fetchall()
        return self._load(rows[0][0]) if rows else None


class RemoteUIStatsStorageRouter(StatsStorageRouter):
    """POST records to a remote UI server (reference:
    api/storage/impl/RemoteUIStatsStorageRouter.java → received by
    RemoteReceiverModule).

    Posts happen on a background thread (``async_mode=True``, the
    default, matching the reference's async queue): a dead dashboard
    slows nothing and, after retries, records are logged-and-dropped
    rather than crashing the training loop. ``async_mode=False`` posts
    synchronously and raises — for tests and one-shot scripts.

    The binary wire format (ui/codec.py) carries float arrays and
    numeric lists of >=8 items at f32 width (like the reference's SBE
    encoders) — f64 values in posted records are quantized in transit.
    """

    def __init__(self, url: str, timeout: float = 5.0,
                 retry_count: int = 3, async_mode: bool = True,
                 queue_limit: int = 1000):
        self.url = url.rstrip("/") + "/remote"
        self.timeout = timeout
        self.retry_count = retry_count
        self.async_mode = async_mode
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=queue_limit)
        self._worker: Optional[threading.Thread] = None
        if async_mode:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def put_static_info(self, record: dict):
        self._submit({"kind": "static", "record": record})

    def put_update(self, record: dict):
        self._submit({"kind": "update", "record": record})

    def _submit(self, payload: dict):
        if not self.async_mode:
            self._post(payload)
            return
        try:
            self._queue.put_nowait(payload)
        except queue.Full:    # monitoring never stalls training
            logging.getLogger(__name__).warning(
                "stats queue full; dropping record")

    def _run(self):
        while True:
            payload = self._queue.get()
            try:
                self._post(payload)
            except Exception as e:   # noqa: BLE001 — log-and-drop
                logging.getLogger(__name__).warning(
                    "dropping stats record after %d retries: %s",
                    self.retry_count, e)
            finally:
                self._queue.task_done()

    def flush(self, timeout: float = 10.0):
        """Block until queued records are posted (best effort). Polls the
        queue's unfinished count with a deadline — no helper thread, so a
        never-draining queue (remote down) can't leak blocked threads."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._queue.all_tasks_done:
                if self._queue.unfinished_tasks == 0:
                    return
            time.sleep(0.05)

    def _post(self, payload: dict):
        # binary stats codec on the wire (ui/codec.py — the SBE role);
        # the receiver also accepts JSON from third-party posters
        from deeplearning4j_tpu_torch.ui.codec import encode_stats_record
        data = encode_stats_record(payload)
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/octet-stream"})
        last = None
        for _ in range(self.retry_count):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout):
                    return
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    # client error: retrying the same payload can't help
                    raise ConnectionError(
                        f"stats POST rejected by {self.url}: {e}") from e
                last = e          # transient server error: retry
            except Exception as e:    # noqa: BLE001 — network layer
                last = e
        raise ConnectionError(
            f"failed to post stats to {self.url}: {last}")
