"""Graph embeddings — analog of deeplearning4j-graph (SURVEY §2.8)."""

from deeplearning4j_tpu_torch.graph.api import Edge, Graph, Vertex
from deeplearning4j_tpu_torch.graph.walks import (
    Node2VecWalkIterator,
    RandomWalkIterator,
    WeightedRandomWalkIterator,
)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk
from deeplearning4j_tpu_torch.graph.node2vec import Node2Vec
from deeplearning4j_tpu_torch.graph.vectors import GraphVectors

__all__ = ["Graph", "Vertex", "Edge", "RandomWalkIterator",
           "WeightedRandomWalkIterator", "Node2VecWalkIterator",
           "DeepWalk", "Node2Vec", "GraphVectors"]
