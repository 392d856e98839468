"""Observability over HTTP: stats collection and storage, the dashboard
server and its module routes (serving, fleet, generation).

The port of the JAX package's ``ui/``: ``stats.py`` (``StatsListener``,
which feeds the training dashboard's ``/train`` pages, ``/api/sessions``
and the stats receiver), ``storage.py``, ``codec.py``, ``modules.py``,
``i18n.py``, ``server.py`` (``UIServer``: ``/metrics``, ``/healthz``,
the dashboard, module routes with SSE streaming, drain),
``serving_module.py`` and ``generation_module.py``. ``TsneListener``
needs ``manifold/tsne.py`` and is not ported (ROADMAP.md, queue 1 item
9): importing it raises.
"""

from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.storage import (
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    SqliteStatsStorage,
)

__all__ = ["StatsListener", "InMemoryStatsStorage", "SqliteStatsStorage",
           "RemoteUIStatsStorageRouter", "UIServer"]

_NOT_PORTED = {"TsneListener": ("ui/tsne_listener.py and manifold/tsne.py",
                                9)}


def __getattr__(name):
    if name in _NOT_PORTED:
        what, item = _NOT_PORTED[name]
        raise NotImplementedError(
            f"{name} is not ported yet ({what}; ROADMAP.md, queue 1 item "
            f"{item})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
