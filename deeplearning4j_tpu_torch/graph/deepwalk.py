"""DeepWalk: graph vertex embeddings via SkipGram over random walks.

Analog of the reference's graph/models/deepwalk/DeepWalk.java:33
(``fit():96``; hierarchical softmax via GraphHuffman — SURVEY §2.8).
Walk generation is the host-side producer; the training hot loop is the
same batched SkipGram device steps as Word2Vec (nlp/skipgram.py), with
vertex indices as "words". Degree-based frequencies replace corpus counts
for the Huffman tree/negative table.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.graph.api import Graph
from deeplearning4j_tpu_torch.graph.walks import RandomWalkIterator
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors


class DeepWalk(SequenceVectors):
    """reference: DeepWalk.Builder — vectorSize, windowSize, walkLength,
    learningRate; fit(GraphWalkIterator)."""

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 walk_length: int = 40, walks_per_vertex: int = 1,
                 use_hierarchic_softmax: bool = True, **kwargs):
        kwargs.setdefault("layer_size", vector_size)
        kwargs.setdefault("window_size", window_size)
        kwargs.setdefault("min_word_frequency", 1)
        kwargs.setdefault("use_hierarchic_softmax", use_hierarchic_softmax)
        super().__init__(**kwargs)
        self.vector_size = kwargs["layer_size"]
        self.walk_length = walk_length
        self.walks_per_vertex = walks_per_vertex
        self.graph: Optional[Graph] = None

    def initialize(self, graph: Graph):
        """Pre-build vocab over all vertices (reference:
        DeepWalk.initialize(IGraph)) so embeddings exist for isolated
        vertices too; 'frequency' = degree + 1."""
        self.graph = graph
        seqs = [[str(v)] * (graph.degree(v) + 1)
                for v in range(graph.num_vertices())]
        self.build_vocab(seqs)
        self._init_tables()
        return self

    def fit(self, graph_or_walks):
        if isinstance(graph_or_walks, Graph):
            if self.graph is not graph_or_walks:
                self.initialize(graph_or_walks)
            walks = RandomWalkIterator(
                graph_or_walks, self.walk_length, seed=self.seed,
                walks_per_vertex=self.walks_per_vertex)
        else:
            walks = graph_or_walks
        sequences = [[str(v) for v in walk] for walk in walks]
        return super().fit(sequences)

    # ---- vertex-flavored lookup API -------------------------------------
    def get_vertex_vector(self, v: int) -> np.ndarray:
        return self.get_word_vector(str(v))

    def similarity_vertices(self, a: int, b: int) -> float:
        return self.similarity(str(a), str(b))

    def vertices_nearest(self, v: int, top_n: int = 10) -> List[int]:
        return [int(w) for w in self.words_nearest(str(v), top_n)]
