"""Node2Vec: biased-walk graph embeddings.

Analog of the reference's ``models/node2vec/`` (SURVEY §2.7): DeepWalk's
SkipGram training over second-order p/q-biased walks. The training hot
loop is the same batched SkipGram device steps (nlp/skipgram.py); only
the walk distribution differs.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.walks import Node2VecWalkIterator


class Node2Vec(DeepWalk):
    """DeepWalk with p/q-biased walk generation (return parameter ``p``,
    in-out parameter ``q``)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 1,
                 p: float = 1.0, q: float = 1.0, **kwargs):
        super().__init__(vector_size=vector_size, window_size=window_size,
                         walk_length=walk_length,
                         walks_per_vertex=walks_per_vertex, **kwargs)
        self.p = p
        self.q = q

    def fit(self, graph_or_walks):
        if isinstance(graph_or_walks, Graph):
            if self.graph is not graph_or_walks:
                self.initialize(graph_or_walks)
            walks = Node2VecWalkIterator(
                graph_or_walks, self.walk_length, p=self.p, q=self.q,
                seed=self.seed, walks_per_vertex=self.walks_per_vertex)
            sequences = [[str(v) for v in walk] for walk in walks]
            return super(DeepWalk, self).fit(sequences)
        return super().fit(graph_or_walks)
