"""Nearest-neighbor retrieval serving.

The port of the JAX package's ``retrieval/``: the corpus lives on the
card as a sharded matrix (``device="cpu"`` only when asked for), and one
distance matmul plus a top-k per (query batch, shard) answers a query,
so only (k ids, k distances) cross back to the host.

- :mod:`kernels` — distance + top-k (f32 / int8 brute force, IVF-routed
  variants), plain torch, with ``lax.top_k``'s order among ties.
- :mod:`index` — ShardedCorpusIndex: build / quantize / IVF-cluster /
  save / load over the ArtifactStore layout, the same bytes as the JAX
  package's.
- :mod:`engine` — RetrievalEngine: warmup sweep, bucket and k ladders,
  host-side k-way merge, recompile watchdog, hot index promotion.
- :mod:`cluster` — RetrievalNode (gossiped shard ownership) and
  NeighborsDispatcher (scatter-gather fan-out with partial-result
  degradation).
"""

from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex


def __getattr__(name):
    # cluster pulls in the ui/http stack; keep `import retrieval` light
    if name in ("RetrievalNode", "NeighborsDispatcher",
                "PartialResultError"):
        from deeplearning4j_tpu_torch.retrieval import cluster
        return getattr(cluster, name)
    raise AttributeError(name)


__all__ = ["RetrievalEngine", "ShardedCorpusIndex", "RetrievalNode",
           "NeighborsDispatcher", "PartialResultError"]
