"""Clustering and nearest neighbors.

The port of the JAX package's ``clustering/`` (reference:
deeplearning4j-nearestneighbors-parent): ``KMeansClustering`` seeds on the
host and runs its Lloyd steps on the device (the distance matrix one
matmul, the centroid update a one-hot matmul); the space-partitioning
trees (VPTree, KDTree, SpTree) and LSH are host-side numpy, copied. The
clustering server (``clustering/server.py``) is a shim over retrieval and
comes with it (ROADMAP.md, queue 1 item 13).
"""

from deeplearning4j_tpu_torch.clustering.kdtree import KDTree
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering
from deeplearning4j_tpu_torch.clustering.lsh import (RandomProjection,
                                                     RandomProjectionLSH)
from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.clustering.vptree import VPTree

__all__ = ["KMeansClustering", "VPTree", "KDTree", "SpTree",
           "RandomProjectionLSH", "RandomProjection"]
