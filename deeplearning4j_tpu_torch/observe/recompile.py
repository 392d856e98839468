"""Recompile watchdog: catch silent signature drift.

The port of the JAX package's ``observe/recompile.py``. There, every
distinct (shape, dtype) signature a jitted step sees costs an XLA
compile. The port's eager paths compile nothing, but a new signature
still means a first dispatch: cuBLAS picks an algorithm for the new
shape and the caching allocator grows. The watchdog fingerprints each
dispatch's arguments (nested lists, tuples and dicts of tensors and
arrays; shapes, dtypes and devices only, a few µs on the host) and
records every NEW signature after the first per step key. New
signatures increment the ``dl4j_recompiles_total`` Prometheus counter
and log a warning naming the offending shapes.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from deeplearning4j_tpu_torch.observe.registry import (
    MetricsRegistry,
    default_registry,
)

log = logging.getLogger(__name__)


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` and return its structure
    (the pytree treedef's role)."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=str)
        return "{" + ",".join(f"{k!r}:{_flatten(tree[k], leaves)}"
                              for k in keys) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(t, leaves) for t in tree)
        return ("[" + inner + "]") if isinstance(tree, list) \
            else ("(" + inner + ")")
    leaves.append(tree)
    return "*"


def signature_of(*trees) -> Tuple:
    """Hashable dispatch signature of nested arguments: structure +
    (shape, dtype, device) per tensor or array leaf; Python scalars
    contribute their type and value, anything else its type (None vs a
    tensor flips a branch, e.g. an optional mask)."""
    leaves: list = []
    struct = _flatten(trees, leaves)
    sig = []
    for l in leaves:
        if hasattr(l, "shape") and hasattr(l, "dtype"):
            sig.append((tuple(l.shape), str(l.dtype),
                        str(getattr(l, "device", "cpu"))))
        elif isinstance(l, (bool, int, float, np.number)):
            sig.append((type(l).__name__, l))
        else:
            sig.append(type(l).__name__)
    return (struct, tuple(sig))


class RecompileWatchdog:
    """Tracks signatures per step key (``train_step``, ``gen_tick_f32_s8``,
    ...). ``observe`` returns True when the signature is new — i.e. the
    next dispatch is a first dispatch of that shape."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 session_id: str = "train"):
        self.registry = registry if registry is not None else \
            default_registry()
        self.session_id = session_id
        self._sigs: Dict[str, Set[Tuple]] = {}
        self.events: List[dict] = []
        # register the series up front so /metrics shows a 0 count
        # instead of an absent metric on healthy runs
        self._counter = self.registry.counter(
            "dl4j_recompiles_total", "new (shape, dtype) signatures seen "
            "by compiled steps after their first compile")
        self._counter.inc(0.0, session=self.session_id)

    def observe(self, step_key: str, *trees) -> bool:
        sig = signature_of(*trees)
        seen = self._sigs.setdefault(step_key, set())
        if sig in seen:
            return False
        first = not seen
        seen.add(sig)
        if first:
            return True     # the initial dispatch is expected, not counted
        self.events.append({"step": step_key, "signature": sig})
        self._counter.inc(1.0, session=self.session_id)
        log.warning(
            "recompile: step %r saw new signature #%d %s — check the "
            "data pipeline for ragged shapes/dtype drift",
            step_key, len(seen) - 1, sig[1])
        return True

    def count(self, step_key: Optional[str] = None) -> int:
        """New signatures beyond the first (0 on a healthy run)."""
        if step_key is not None:
            return max(0, len(self._sigs.get(step_key, ())) - 1)
        return sum(max(0, len(s) - 1) for s in self._sigs.values())
