"""Legacy full-batch convex optimizers: conjugate gradient, L-BFGS,
backtracking line search.

The port of the JAX package's ``optimize/legacy.py`` (reference:
optimize/solvers/ConjugateGradient.java, LBFGS.java,
BackTrackLineSearch.java — the non-SGD OptimizationAlgorithm values).
The reference drives these over the flattened parameter view; here the
parameter dicts are flattened into one vector on the model's device, and
each probe of the line search is one loss evaluation (``torch.no_grad``)
and each gradient one ``torch.autograd`` pass. The loops are host-driven
(data-dependent termination), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map


def ravel_params(params) -> Tuple[torch.Tensor, Callable]:
    """(one flat vector of every leaf in order, ``unravel``) — the
    analog of ``jax.flatten_util.ravel_pytree``."""
    leaves = tree_leaves(params)
    flat = torch.cat([l.reshape(-1) for l in leaves])

    def unravel(x: torch.Tensor):
        parts = iter(torch.split(x, [l.numel() for l in leaves]))
        return tree_map(lambda l: next(parts).reshape(l.shape).to(l.dtype),
                        params)
    return flat, unravel


class BackTrackLineSearch:
    """Armijo backtracking line search (reference:
    BackTrackLineSearch.java — maxIterations, stepMax, relTolx defaults)."""

    def __init__(self, max_iterations: int = 5, step_max: float = 100.0,
                 c1: float = 1e-4, backtrack: float = 0.5):
        self.max_iterations = max_iterations
        self.step_max = step_max
        self.c1 = c1
        self.backtrack = backtrack

    def search(self, f: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor, loss0: float, grad: torch.Tensor,
               direction: torch.Tensor
               ) -> Tuple[float, float, torch.Tensor]:
        """Returns (step, new_loss, direction_used); step==0.0 when no
        decrease found. ``direction_used`` is the (possibly flipped)
        direction actually probed — callers must step along it."""
        dnorm = float(torch.linalg.norm(direction))
        if dnorm == 0.0 or not np.isfinite(dnorm):
            return 0.0, loss0, direction
        step = min(1.0, self.step_max / dnorm)
        slope = float(torch.dot(grad, direction))
        if slope >= 0:  # not a descent direction: flip
            direction = -direction
            slope = -slope
        for _ in range(self.max_iterations):
            new_loss = float(f(x + step * direction))
            if np.isfinite(new_loss) and \
                    new_loss <= loss0 + self.c1 * step * slope:
                return step, new_loss, direction
            step *= self.backtrack
        return 0.0, loss0, direction


class _Result(NamedTuple):
    params: object
    loss: float
    iterations: int
    converged: bool


class BaseLegacyOptimizer:
    """Shared driver (reference: BaseOptimizer.java:54 — maxIterations +
    score-delta termination)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.max_iterations = max_iterations
        self.tolerance = tolerance
        self.line_search = line_search or BackTrackLineSearch()

    def optimize(self, loss_fn: Callable, params) -> _Result:
        """loss_fn: parameter dicts -> scalar tensor. Returns the
        optimized parameter dicts."""
        x0, unravel = ravel_params(params)

        def f(x):
            with torch.no_grad():
                return loss_fn(unravel(x))

        def vg(x):
            x = x.detach().requires_grad_(True)
            loss = loss_fn(unravel(x))
            (g,) = torch.autograd.grad(loss, x)
            return loss.detach(), g

        x, loss, it, conv = self._run(f, vg, x0.detach())
        return _Result(unravel(x), float(loss), it, conv)

    def _run(self, f, vg, x):
        raise NotImplementedError


class ConjugateGradient(BaseLegacyOptimizer):
    """Polak-Ribiere nonlinear CG (reference: ConjugateGradient.java)."""

    def _run(self, f, vg, x):
        loss, g = vg(x)
        loss = float(loss)
        d = -g
        for it in range(self.max_iterations):
            step, new_loss, d = self.line_search.search(f, x, loss, g, d)
            if step == 0.0:  # line-search breakdown, not convergence
                return x, loss, it, False
            x = x + step * d
            _, g_new = vg(x)
            # Polak-Ribiere beta, clamped at 0 (auto-restart)
            beta = float(torch.dot(g_new, g_new - g) /
                         (torch.dot(g, g) + 1e-30))
            beta = max(0.0, beta)
            d = -g_new + beta * d
            g = g_new
            if abs(loss - new_loss) < self.tolerance:
                return x, new_loss, it + 1, True
            loss = new_loss
        return x, loss, self.max_iterations, False


class LBFGS(BaseLegacyOptimizer):
    """Limited-memory BFGS, two-loop recursion (reference: LBFGS.java —
    default history m=4)."""

    def __init__(self, max_iterations: int = 100, tolerance: float = 1e-5,
                 m: int = 4, line_search: Optional[BackTrackLineSearch] = None):
        super().__init__(max_iterations, tolerance, line_search)
        self.m = m

    def _run(self, f, vg, x):
        loss, g = vg(x)
        loss = float(loss)
        s_hist, y_hist = [], []
        for it in range(self.max_iterations):
            d = -self._two_loop(g, s_hist, y_hist)
            step, new_loss, d = self.line_search.search(f, x, loss, g, d)
            if step == 0.0:  # line-search breakdown, not convergence
                return x, loss, it, False
            x_new = x + step * d
            _, g_new = vg(x_new)
            s, y = x_new - x, g_new - g
            if float(torch.dot(s, y)) > 1e-10:
                s_hist.append(s)
                y_hist.append(y)
                if len(s_hist) > self.m:
                    s_hist.pop(0)
                    y_hist.pop(0)
            x, g = x_new, g_new
            if abs(loss - new_loss) < self.tolerance:
                return x, new_loss, it + 1, True
            loss = new_loss
        return x, loss, self.max_iterations, False

    @staticmethod
    def _two_loop(g, s_hist, y_hist):
        q = g
        alphas = []
        for s, y in zip(reversed(s_hist), reversed(y_hist)):
            rho = 1.0 / (torch.dot(y, s) + 1e-30)
            a = rho * torch.dot(s, q)
            alphas.append((a, rho, s, y))
            q = q - a * y
        if s_hist:
            s, y = s_hist[-1], y_hist[-1]
            q = q * (torch.dot(s, y) / (torch.dot(y, y) + 1e-30))
        for a, rho, s, y in reversed(alphas):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q


def optimize_model(model, dataset, algo: str = "lbfgs",
                   max_iterations: int = 100, tolerance: float = 1e-5
                   ) -> _Result:
    """Full-batch optimization of a model on one DataSet, the analog of
    configuring ``OptimizationAlgorithm.LBFGS``/``CONJUGATE_GRADIENT`` on
    the reference Solver (Solver.java:43). Updates the model's parameters
    in place. The loss is the training loss without a generator, so
    dropout stays off and every probe sees the same function."""
    algos = {"lbfgs": LBFGS, "cg": ConjugateGradient,
             "conjugate_gradient": ConjugateGradient}
    opt = algos[algo.lower()](max_iterations=max_iterations,
                              tolerance=tolerance)
    if model.params is None:
        model.init()
    feats = model._as_tensor(dataset.features)
    labels = model._as_tensor(dataset.labels)
    # a ComputationGraph takes tuples of inputs/labels; an MLN tensors
    graph = getattr(model, "_multi_inputs", False)
    f_in = (feats,) if graph else feats
    l_in = (labels,) if graph else labels
    model_state, iteration = model.model_state, model.iteration

    def loss_fn(params):
        loss, _ = model._loss(params, model_state, f_in, l_in, None, None,
                              None, iteration)
        return loss

    res = opt.optimize(loss_fn, model.params)
    model.set_params(res.params)
    return res
