"""The one chaos import allowed in hot paths.

Instrumented modules bind their injection sites ONCE at construction::

    from deeplearning4j_tpu_torch.chaos.hook import chaos_site
    ...
    self._chaos = chaos_site("remote.send")     # None when disarmed

and their hot loops pay a single ``if self._chaos is not None`` test.
``chaos_site`` itself never loads the plan machinery unless chaos is
armed — via ``DL4J_CHAOS`` in the environment, or programmatically
(``chaos.arm(...)``, which imports ``chaos.plan`` and so flips the
``sys.modules`` probe below). Disarmed processes therefore never pay
an import, a parse, or a per-call draw: the zero-overhead contract the
``chaos-hygiene`` graftlint rule polices.
"""

from __future__ import annotations

import os
import sys


def chaos_site(name: str):
    """Resolve a fault-injection site handle, or ``None`` when chaos
    is disarmed. Call at construction time, not per operation."""
    if ("DL4J_CHAOS" not in os.environ
            and "deeplearning4j_tpu_torch.chaos.plan" not in sys.modules):
        return None
    from deeplearning4j_tpu_torch.chaos import plan as _plan
    return _plan.site(name)
