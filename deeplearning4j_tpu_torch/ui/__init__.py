"""Observability over HTTP: stats collection and storage, the dashboard
server and its module routes (serving, fleet, generation).

The port of the JAX package's ``ui/``: ``stats.py`` (``StatsListener``,
which feeds the training dashboard's ``/train`` pages, ``/api/sessions``
and the stats receiver), ``storage.py``, ``codec.py``, ``modules.py``,
``i18n.py``, ``server.py`` (``UIServer``: ``/metrics``, ``/healthz``,
the dashboard, module routes with SSE streaming, drain),
``serving_module.py``, ``generation_module.py`` and ``tsne_listener.py``
(``TsneListener``, which pushes t-SNE coordinates of a layer's
activations to the dashboard's t-SNE tab).
"""

from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.stats import StatsListener
from deeplearning4j_tpu_torch.ui.storage import (
    InMemoryStatsStorage,
    RemoteUIStatsStorageRouter,
    SqliteStatsStorage,
)
from deeplearning4j_tpu_torch.ui.tsne_listener import TsneListener

__all__ = ["StatsListener", "InMemoryStatsStorage", "SqliteStatsStorage",
           "RemoteUIStatsStorageRouter", "UIServer", "TsneListener"]
