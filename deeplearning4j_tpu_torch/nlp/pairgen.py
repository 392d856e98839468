"""The splitmix64 constants and mixer of the host pair generator.

From the JAX package's ``nlp/pairgen.py``, ``GOLDEN``, ``M1``, ``M2`` and
the vectorized numpy ``_mix_np`` only (copies): the generation engine's
counter-mode sampling keys (``generation/speculative.py:counter_keys``)
are built from them and must equal the JAX package's bit for bit. The
pair generator itself (the fused draw streams, ``native/dl4j_native``)
is not ported yet (ROADMAP).
"""

from __future__ import annotations

import numpy as np

GOLDEN = 0x9E3779B97F4A7C15
M1 = 0xBF58476D1CE4E5B9
M2 = 0x94D049BB133111EB


def _mix_np(z: np.ndarray) -> np.ndarray:
    z ^= z >> np.uint64(30)
    z *= np.uint64(M1)
    z ^= z >> np.uint64(27)
    z *= np.uint64(M2)
    z ^= z >> np.uint64(31)
    return z
