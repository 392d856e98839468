"""KMeans on the device.

The port of the JAX package's ``clustering/kmeans.py`` (reference:
clustering/kmeans/KMeansClustering.java). kmeans++ seeding runs on the
host, the JAX package's numpy code with the same ``default_rng(seed)``,
so both packages start from the same centers. Each Lloyd iteration then
runs on the device: the N×K squared distances are one matmul in the
expanded-quadratic form, the assignment an argmin, and the centroid
update a one-hot matmul; an empty cluster keeps its center.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device


def _assign(x: torch.Tensor, centers: torch.Tensor):
    """argmin_k ||x_i - c_k||² and its value, by the expanded form."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)          # [N, 1]
    c2 = torch.sum(centers * centers, dim=1)[None, :]   # [1, K]
    d2 = x2 - 2.0 * (x @ centers.T) + c2                # [N, K]
    labels = torch.argmin(d2, dim=1)
    return labels, torch.gather(d2, 1, labels[:, None])[:, 0]


def _update(x: torch.Tensor, labels: torch.Tensor, centers: torch.Tensor):
    k = centers.shape[0]
    onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)   # [N, K]
    sums = onehot.T @ x                                           # [K, D]
    counts = onehot.sum(0)[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       centers)


class KMeansClustering:
    """reference API: KMeansClustering.setup(nClusters, maxIterations,
    distanceFunction); applyTo(points). Runs on ``device`` (the card
    unless ``"cpu"``)."""

    def __init__(self, n_clusters: int, max_iterations: int = 100,
                 tol: float = 1e-6, seed: int = 0,
                 device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.max_iterations = max_iterations
        self.tol = tol
        self.seed = seed
        self.device = resolve_device(device)
        self.cluster_centers_: Optional[np.ndarray] = None
        self.labels_: Optional[np.ndarray] = None
        self.inertia_: Optional[float] = None
        self.n_iter_ = 0

    @classmethod
    def setup(cls, n_clusters: int, max_iterations: int = 100,
              distance_function: str = "euclidean", seed: int = 0,
              device: DeviceLike = None) -> "KMeansClustering":
        if distance_function not in ("euclidean", "sqeuclidean"):
            raise ValueError("only euclidean distances are supported")
        return cls(n_clusters, max_iterations, seed=seed, device=device)

    def _init_centers(self, x: np.ndarray) -> np.ndarray:
        """kmeans++ seeding on the host (the JAX package's code): the
        running min-distance is updated against the newest center only."""
        rng = np.random.default_rng(self.seed)
        n = x.shape[0]
        center = x[rng.integers(n)]
        centers = [center]
        d2 = np.sum((x - center) ** 2, axis=1)
        for _ in range(1, self.n_clusters):
            p = np.maximum(d2, 0)
            s = p.sum()
            probs = p / s if s > 0 else np.full(n, 1.0 / n)
            center = x[rng.choice(n, p=probs)]
            centers.append(center)
            d2 = np.minimum(d2, np.sum((x - center) ** 2, axis=1))
        return np.stack(centers)

    def apply_to(self, points: np.ndarray) -> "KMeansClustering":
        x = np.asarray(points, np.float32)
        if x.shape[0] < self.n_clusters:
            raise ValueError(
                f"{x.shape[0]} points < {self.n_clusters} clusters")
        xd = torch.as_tensor(x, device=self.device)
        centers = torch.as_tensor(self._init_centers(x), device=self.device)
        prev_inertia = np.inf
        self.n_iter_ = 0
        for _ in range(self.max_iterations):
            labels, d2 = _assign(xd, centers)
            centers = _update(xd, labels, centers)
            self.n_iter_ += 1
            inertia = float(d2.sum())       # the host's convergence test
            if abs(prev_inertia - inertia) <= self.tol * max(
                    abs(prev_inertia), 1.0):
                break
            prev_inertia = inertia
        labels, d2 = _assign(xd, centers)
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = labels.cpu().numpy()
        self.inertia_ = float(d2.sum())
        return self

    fit = apply_to

    def predict(self, points: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(points, np.float32),
                            device=self.device)
        labels, _ = _assign(x, torch.as_tensor(self.cluster_centers_,
                                               device=self.device))
        return labels.cpu().numpy()
