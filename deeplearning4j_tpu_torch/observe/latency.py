"""Streaming latency quantiles for the serving path.

A serving engine needs p50/p95/p99 over recent requests without keeping
an unbounded history or adding per-request allocation. ``LatencyRing``
is a fixed-capacity ring of the last N observations (seconds) with a
lock cheap enough to take per request; ``quantiles()`` sorts a snapshot
on demand (the scrape path, not the hot path). Nearest-rank quantiles —
the convention Prometheus summaries use — so p99 of 100 samples is the
99th ordered sample, not an interpolation.

Two read modes:

- ``quantiles()`` — the full live window (up to ``capacity`` samples),
  the dashboard/scrape view.
- ``delta_quantiles()`` — only observations recorded since the previous
  ``delta_quantiles()`` call (or ``mark()``). This is what a feedback
  controller wants: it reacts to the last tick's traffic, not to a
  4096-sample history that takes minutes to forget a spike.

A copy of the JAX package's ``observe/latency.py``; the port imports
nothing of that package.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

DEFAULT_QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


def _validate_quantiles(qs: Sequence[float]):
    """Range-check BEFORE any sorting work: a bad q must raise even on
    an empty window, and must not waste the sort on a doomed call."""
    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile out of range: {q}")


def _nearest_rank(window: List[float], qs: Sequence[float]
                  ) -> Dict[float, float]:
    window.sort()
    n = len(window)
    out = {}
    for q in qs:
        rank = min(n - 1, max(0, int(q * n + 0.5) - 1))
        out[q] = window[rank]
    return out


class LatencyRing:
    """Last-``capacity`` latency observations, in seconds."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf = [0.0] * self.capacity
        self._n = 0            # writes into the current window
        self._total = 0        # total ever recorded (survives reset)
        self._delta_mark = 0   # _total at the last delta scrape / mark
        self._lock = threading.Lock()

    def record(self, seconds: float):
        with self._lock:
            self._buf[self._n % self.capacity] = float(seconds)
            self._n += 1
            self._total += 1

    @property
    def count(self) -> int:
        """Total observations ever recorded (monotonic; ``reset()``
        empties the window but does not rewind this)."""
        return self._total

    def reset(self):
        """Drop the stored window (e.g. after a version swap, so stale
        latencies don't poison the new version's quantiles). The
        cumulative ``count`` and the delta mark are preserved — a delta
        scrape after reset only sees post-reset observations."""
        with self._lock:
            self._n = 0
            # observations recorded before the reset are gone; the next
            # delta window must not claim them
            self._delta_mark = self._total

    def mark(self):
        """Start a fresh delta window without reading quantiles."""
        with self._lock:
            self._delta_mark = self._total

    def snapshot(self) -> list:
        """The live window (unordered), at most ``capacity`` samples."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> list:
        if self._n >= self.capacity:
            return list(self._buf)
        return self._buf[:self._n]

    def quantiles(self, qs: Sequence[float] = DEFAULT_QUANTILES
                  ) -> Dict[float, float]:
        """Nearest-rank quantiles of the window; empty ring -> {}."""
        _validate_quantiles(qs)
        window = self.snapshot()
        if not window:
            return {}
        return _nearest_rank(window, qs)

    def delta_quantiles(self, qs: Sequence[float] = DEFAULT_QUANTILES
                        ) -> Dict[float, float]:
        """Nearest-rank quantiles over observations since the last
        ``delta_quantiles()``/``mark()`` call; advances the mark. No new
        observations (or more new observations than the ring can hold:
        clamped to the window) -> {} / the newest ``capacity``."""
        _validate_quantiles(qs)
        with self._lock:
            fresh = self._total - self._delta_mark
            self._delta_mark = self._total
            if fresh <= 0:
                return {}
            k = min(fresh, self._n, self.capacity)
            if k <= 0:
                return {}
            if k >= self.capacity and self._n >= self.capacity:
                window = list(self._buf)
            else:
                # the k most recent entries, ending at write position
                end = self._n % self.capacity \
                    if self._n >= self.capacity else self._n
                start = end - k
                if start >= 0:
                    window = self._buf[start:end]
                else:
                    window = self._buf[start:] + self._buf[:end]
        return _nearest_rank(window, qs)
