"""End-to-end request deadlines.

A :class:`Deadline` is the caller's remaining time budget, carried
from ui ingress (``X-Deadline-Ms`` header / ``deadline_ms`` body
field) through FleetRouter admission, batch forming, remote
dispatch, and the device tier. Every tier's contract is the same:
an expired request is shed *synchronously* — :class:`DeadlineExceeded`
(or ``ShedError(reason="deadline")`` at admission) maps to HTTP 504
upstream and the work never reaches the device.

This module sits below both ``parallel/serving.py`` and
``parallel/fleet.py`` (which must not import each other), so every
tier shares one exception type and one clock discipline: deadlines
are absolute points on a monotonic clock, converted from wall-budget
milliseconds exactly once at ingress.
"""

from __future__ import annotations

import math
import time
from typing import Optional


class DeadlineExceeded(RuntimeError):
    """A request's time budget was spent before (or while) serving it.
    Maps to HTTP 504 at the ui tier; reason string rides in
    ``detail``."""

    def __init__(self, detail: str = "deadline exceeded"):
        super().__init__(detail)
        self.detail = detail


class Deadline:
    """An absolute give-up point on a monotonic clock.

    The clock is injectable (the remote dispatcher's chaos-skewed
    clock, test doubles); ``time.monotonic`` otherwise.
    """

    __slots__ = ("t_end", "clock")

    def __init__(self, t_end: float, clock=time.monotonic):
        self.t_end = float(t_end)  # host-sync-ok: clock scalar, host time arithmetic
        self.clock = clock

    @classmethod
    def after_ms(cls, ms: float, clock=time.monotonic) -> "Deadline":
        return cls(clock() + float(ms) / 1e3, clock=clock)  # host-sync-ok: clock scalar, host time arithmetic

    @classmethod
    def from_ingress(cls, headers=None, body=None,
                     clock=time.monotonic) -> Optional["Deadline"]:
        """Parse a deadline out of a request: an explicit
        ``deadline_ms`` body field wins over the ``X-Deadline-Ms``
        header. Defensive: garbage, non-finite, or non-positive
        budgets yield None (no deadline) rather than a 500 — a broken
        client should degrade to the undeadlined behavior it had
        before this header existed."""
        raw = None
        if isinstance(body, dict):
            raw = body.get("deadline_ms")
        if raw is None and headers is not None:
            getter = getattr(headers, "get", None)
            if getter is not None:
                raw = getter("X-Deadline-Ms")
        if raw is None:
            return None
        try:
            ms = float(raw)  # host-sync-ok: parsing a request header/body scalar
        except (TypeError, ValueError):
            return None
        if not math.isfinite(ms) or ms <= 0:
            return None
        return cls.after_ms(ms, clock=clock)

    def remaining_s(self) -> float:
        return self.t_end - self.clock()

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def check(self, detail: str = "deadline exceeded") -> None:
        """Raise :class:`DeadlineExceeded` when the budget is spent —
        the synchronous shed every tier performs before doing work."""
        if self.expired:
            raise DeadlineExceeded(detail)

    def cap_timeout(self, configured: Optional[float]) -> float:
        """Per-attempt timeout = min(configured, remaining budget),
        floored at 0 — what the remote dispatcher hands its
        transport."""
        rem = max(self.remaining_s(), 0.0)
        if configured is None:
            return rem
        return min(float(configured), rem)  # host-sync-ok: config scalar, host time arithmetic

    def __repr__(self):
        return f"Deadline(remaining={self.remaining_s() * 1e3:.1f}ms)"
