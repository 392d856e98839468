"""Observability over HTTP: stats storage, the dashboard server and its
module routes (serving, fleet, generation).

The port of the JAX package's ``ui/``. Ported: ``storage.py``,
``codec.py``, ``modules.py``, ``i18n.py``, ``server.py`` (``UIServer``:
``/metrics``, ``/healthz``, the dashboard, module routes with SSE
streaming, drain), ``serving_module.py`` and ``generation_module.py``.
The training listeners are not: ``StatsListener`` (``ui/stats.py``,
which needs ``optimize/listeners.py``; ROADMAP.md, queue 1 item 10) and
``TsneListener`` (it needs ``manifold/tsne.py``; item 9) raise on
import.
"""

from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.storage import (
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    SqliteStatsStorage,
)

__all__ = ["InMemoryStatsStorage", "SqliteStatsStorage",
           "RemoteUIStatsStorageRouter", "UIServer"]

_NOT_PORTED = {"StatsListener": ("ui/stats.py and optimize/listeners.py",
                                 10),
               "TsneListener": ("ui/tsne_listener.py and manifold/tsne.py",
                                9)}


def __getattr__(name):
    if name in _NOT_PORTED:
        what, item = _NOT_PORTED[name]
        raise NotImplementedError(
            f"{name} is not ported yet ({what}; ROADMAP.md, queue 1 item "
            f"{item})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
