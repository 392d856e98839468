"""The heartbeat staleness boundary.

From the JAX package's ``parallel/cluster.py``, ``classify_heartbeat_age``
only (a copy): the one statement of "alive / slow / dead" that the
serving ``NodeRegistry`` (parallel/node.py) reads gossip through. The
rest of that file, the ``CollectiveWatchdog`` around collectives and the
cluster training masters, is multi-device work and waits for ROADMAP.md
queue 1 item 15.
"""

from __future__ import annotations

from typing import Optional


def classify_heartbeat_age(age: Optional[float], dead_after_s: float,
                           slow_after_s: Optional[float] = None) -> str:
    """Classify a heartbeat's age: ``"alive"`` | ``"slow"`` | ``"dead"``.

    - ``age is None`` (file never appeared / unreadable) -> ``"dead"``;
    - ``age``  > ``dead_after_s``  (strictly past)        -> ``"dead"``;
    - ``age`` >= ``slow_after_s``  (at or past)           -> ``"slow"``;
    - otherwise                                           -> ``"alive"``.

    A heartbeat EXACTLY at a threshold is always given the less severe
    class: exactly at ``dead_after_s`` is slow, not dead — a beat is a
    point-in-time sample, so "age == horizon" means the peer beat
    exactly one horizon ago and may be about to beat again; only
    strictly-past evidence may kill it. ``slow_after_s`` defaults to
    ``dead_after_s`` (the single-threshold watchdog case).
    """
    if age is None or age > dead_after_s:
        return "dead"
    if age >= (dead_after_s if slow_after_s is None else slow_after_s):
        return "slow"
    return "alive"
