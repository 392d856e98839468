"""Manifold learning (t-SNE): the port of the JAX package's
``manifold/``."""

from deeplearning4j_tpu_torch.manifold.tsne import BarnesHutTsne, Tsne

__all__ = ["Tsne", "BarnesHutTsne"]
