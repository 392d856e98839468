"""t-SNE on the device.

The port of the JAX package's ``manifold/tsne.py`` (reference:
deeplearning4j-manifold, plot/Tsne.java and BarnesHutTsne.java). The
input affinities P (per-row perplexity search) are host numpy in
float64, a copy; the initialisation is the JAX package's
``default_rng(seed)`` normal draw. The exact O(N²) gradient then runs on
the device in float32: two dense matmuls and elementwise work a step,
with gains and momentum. ``BarnesHutTsne`` keeps the reference's knobs:
theta == 0 runs the exact device path; theta > 0 the SpTree
approximation on the host (clustering/sptree.py), copied.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device


def _hbeta(d2_row: np.ndarray, beta: float):
    p = np.exp(-d2_row * beta)
    sum_p = max(p.sum(), 1e-12)
    h = np.log(sum_p) + beta * float(d2_row @ p) / sum_p
    return h, p / sum_p


def _binary_search_perplexity(d2: np.ndarray, perplexity: float,
                              tol: float = 1e-5) -> np.ndarray:
    """Per-row beta search so each conditional P has the target entropy
    (reference: Tsne.java computeGaussianPerplexity)."""
    n = d2.shape[0]
    target = np.log(perplexity)
    p = np.zeros_like(d2)
    for i in range(n):
        row = np.delete(d2[i], i)
        beta, lo, hi = 1.0, -np.inf, np.inf
        for _ in range(50):
            h, pr = _hbeta(row, beta)
            if abs(h - target) < tol:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = beta / 2 if lo == -np.inf else (beta + lo) / 2
        p[i] = np.insert(pr, i, 0.0)
    return p


def _tsne_step(P, y, vel, gains, momentum: float, lr: float):
    """One exact gradient-descent step with gains and momentum
    (reference: Tsne.java's gradient and step); every O(N²) term is a
    device tensor op."""
    y2 = torch.sum(y * y, dim=1)
    d2 = y2[:, None] - 2.0 * (y @ y.T) + y2[None, :]
    num = 1.0 / (1.0 + d2)
    num = num * (1.0 - torch.eye(y.shape[0], dtype=y.dtype,
                                 device=y.device))
    Q = num / torch.clamp(num.sum(), min=1e-12)
    PQ = (P - torch.clamp(Q, min=1e-12)) * num
    grad = 4.0 * ((torch.diag(PQ.sum(1)) - PQ) @ y)
    gains = torch.where(torch.sign(grad) != torch.sign(vel),
                        gains + 0.2, gains * 0.8)
    gains = torch.clamp(gains, min=0.01)
    vel = momentum * vel - lr * gains * grad
    y = y + vel
    y = y - y.mean(0)
    kl = torch.sum(torch.where(
        P > 0, P * torch.log(torch.clamp(P, min=1e-12)
                             / torch.clamp(Q, min=1e-12)),
        torch.zeros_like(P)))
    return y, vel, gains, kl


class Tsne:
    """Exact t-SNE (reference: plot/Tsne.java builder knobs), on
    ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 early_exaggeration: float = 12.0,
                 exaggeration_iters: int = 100,
                 initial_momentum: float = 0.5,
                 final_momentum: float = 0.8,
                 momentum_switch: int = 250, seed: int = 0,
                 device: DeviceLike = None):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.early_exaggeration = early_exaggeration
        self.exaggeration_iters = exaggeration_iters
        self.initial_momentum = initial_momentum
        self.final_momentum = final_momentum
        self.momentum_switch = momentum_switch
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None

    def _p_matrix(self, x: np.ndarray) -> np.ndarray:
        x2 = np.sum(x * x, axis=1)
        d2 = np.maximum(x2[:, None] - 2.0 * (x @ x.T) + x2[None, :], 0.0)
        p = _binary_search_perplexity(d2, self.perplexity)
        p = (p + p.T) / (2.0 * p.shape[0])
        return np.maximum(p, 1e-12)

    def _init_y(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.normal(scale=1e-4, size=(n, self.n_components))

    def _schedule(self, it: int):
        ex = (self.early_exaggeration
              if it < self.exaggeration_iters else 1.0)
        mom = (self.initial_momentum
               if it < self.momentum_switch else self.final_momentum)
        return ex, mom

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        P = torch.as_tensor(self._p_matrix(x).astype(np.float32),
                            device=self.device)
        y = torch.as_tensor(self._init_y(x.shape[0]).astype(np.float32),
                            device=self.device)
        vel = torch.zeros_like(y)
        gains = torch.ones_like(y)
        kl = torch.tensor(float("nan"))
        for it in range(self.n_iter):
            ex, mom = self._schedule(it)
            y, vel, gains, kl = _tsne_step(P * ex if ex != 1.0 else P, y,
                                           vel, gains, mom,
                                           self.learning_rate)
        self.kl_divergence_ = float(kl)
        return y.cpu().numpy()


class BarnesHutTsne(Tsne):
    """reference: plot/BarnesHutTsne.java, theta-approximated t-SNE.
    theta == 0 runs the exact device path; theta > 0 runs the SpTree
    approximation on the host."""

    def __init__(self, theta: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.theta = theta

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        if self.theta <= 0.0:
            return super().fit_transform(x)
        return self._fit_bh(np.asarray(x, np.float64))

    def _fit_bh(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        P = self._p_matrix(x)          # dense input affinities
        rng = np.random.default_rng(self.seed)
        y = rng.normal(scale=1e-4, size=(n, self.n_components))
        vel = np.zeros_like(y)
        gains = np.ones_like(y)
        for it in range(self.n_iter):
            ex = (self.early_exaggeration
                  if it < self.exaggeration_iters else 1.0)
            mom = (self.initial_momentum
                   if it < self.momentum_switch else self.final_momentum)
            tree = SpTree(y)
            neg = np.zeros_like(y)
            sum_q = 0.0
            for i in range(n):
                f, q = tree.compute_non_edge_forces(i, self.theta)
                neg[i] = f
                sum_q += q
            sum_q = max(sum_q, 1e-12)
            # attractive forces from P (dense; sparse in the reference).
            # O(N^2) memory: pairwise distances via the norm expansion and
            # pos_i = sum_j w_ij (y_i - y_j) = rowsum(w)*y_i - (w @ y)_j —
            # never materializing the (N, N, D) difference tensor.
            sq = np.sum(y * y, axis=1)
            dist2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (y @ y.T),
                               0.0)
            w = (P * ex) / (1.0 + dist2)
            pos = w.sum(axis=1)[:, None] * y - w @ y
            # same 4x scale as the exact-path gradient (_tsne_step)
            grad = 4.0 * (pos - neg / sum_q)
            gains = np.where(np.sign(grad) != np.sign(vel),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            vel = mom * vel - self.learning_rate * gains * grad
            y = y + vel
            y = y - y.mean(0)
        self.kl_divergence_ = None
        return y
