"""Loss functions.

The ``LossFunction`` enum with the JAX package's member names, so an
output layer's configuration round-trips through ``configuration.json``,
and the loss math of the JAX package's ``ops/losses.py`` as plain torch:
``loss(labels, output, mask) -> scalar``, the mean over (unmasked)
examples, with gradients from ``torch.autograd``. Every loss of the enum
is ported with the JAX package's clamps, plus the fused softmax and
sigmoid cross-entropies on logits that output layers take.
"""

from __future__ import annotations

import enum

import torch

from deeplearning4j_tpu_torch.utils.serde import register_enum

_EPS = 1e-7


def _masked_mean(per_example: torch.Tensor, mask) -> torch.Tensor:
    """Mean over examples, honoring an optional {0,1} mask broadcast to
    ``per_example``'s (N,) or (N, T) shape."""
    if mask is None:
        return per_example.mean()
    mask = torch.as_tensor(mask, dtype=per_example.dtype,
                           device=per_example.device)
    mask = mask.reshape(per_example.shape)
    return (per_example * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _reduce_features(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing feature axis, keeping (N,) or (N, T)."""
    return x.sum(dim=-1)


@register_enum
class LossFunction(enum.Enum):
    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    XENT = "xent"                      # binary cross-entropy (sigmoid out)
    MCXENT = "mcxent"                  # multi-class cross-entropy (softmax out)
    SPARSE_MCXENT = "sparse_mcxent"    # integer labels
    NEGATIVELOGLIKELIHOOD = "nll"
    KL_DIVERGENCE = "kld"
    COSINE_PROXIMITY = "cosine"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    POISSON = "poisson"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"

    def __call__(self, labels, output, mask=None):
        return _FNS[self](labels, output, mask)


def mse(labels, output, mask=None):
    # Mean over features (reference: LossMSE = LossL2 / nOut).
    return _masked_mean(torch.mean(torch.square(output - labels), dim=-1),
                        mask)


def l1(labels, output, mask=None):
    return _masked_mean(_reduce_features(torch.abs(output - labels)), mask)


def l2(labels, output, mask=None):
    # L2 in the reference is the un-averaged-over-features squared error sum.
    return _masked_mean(_reduce_features(torch.square(output - labels)),
                        mask)


def mae(labels, output, mask=None):
    return _masked_mean(torch.mean(torch.abs(output - labels), dim=-1), mask)


def xent(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0 - _EPS)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _masked_mean(_reduce_features(per), mask)


def mcxent(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0)
    return _masked_mean(-_reduce_features(labels * torch.log(p)), mask)


def sparse_mcxent(labels, output, mask=None):
    idx = labels.to(torch.int64)
    logp = torch.log(torch.clamp(output, _EPS, 1.0))
    per = -torch.gather(logp, -1, idx[..., None])[..., 0]
    return _masked_mean(per, mask)


def kl_divergence(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0)
    t = torch.clamp(labels, _EPS, 1.0)
    return _masked_mean(
        _reduce_features(labels * (torch.log(t) - torch.log(p))), mask)


def _unit(x):
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + _EPS)


def cosine_proximity(labels, output, mask=None):
    return _masked_mean(-_reduce_features(_unit(labels) * _unit(output)),
                        mask)


def hinge(labels, output, mask=None):
    # labels in {-1, +1}
    return _masked_mean(
        _reduce_features(torch.clamp(1.0 - labels * output, min=0.0)), mask)


def squared_hinge(labels, output, mask=None):
    return _masked_mean(_reduce_features(
        torch.square(torch.clamp(1.0 - labels * output, min=0.0))), mask)


def poisson(labels, output, mask=None):
    p = torch.clamp(output, min=_EPS)
    return _masked_mean(_reduce_features(p - labels * torch.log(p)), mask)


def msle(labels, output, mask=None):
    per = torch.square(torch.log1p(torch.clamp(output, min=0.0))
                       - torch.log1p(torch.clamp(labels, min=0.0)))
    return _masked_mean(_reduce_features(per), mask)


def mape(labels, output, mask=None):
    per = 100.0 * torch.abs((labels - output)
                            / torch.clamp(torch.abs(labels), min=_EPS))
    return _masked_mean(torch.mean(per, dim=-1), mask)


_FNS = {
    LossFunction.MSE: mse,
    LossFunction.L1: l1,
    LossFunction.L2: l2,
    LossFunction.MAE: mae,
    LossFunction.XENT: xent,
    LossFunction.MCXENT: mcxent,
    LossFunction.SPARSE_MCXENT: sparse_mcxent,
    LossFunction.NEGATIVELOGLIKELIHOOD: mcxent,  # same math as reference
    LossFunction.KL_DIVERGENCE: kl_divergence,
    LossFunction.COSINE_PROXIMITY: cosine_proximity,
    LossFunction.HINGE: hinge,
    LossFunction.SQUARED_HINGE: squared_hinge,
    LossFunction.POISSON: poisson,
    LossFunction.MEAN_SQUARED_LOGARITHMIC_ERROR: msle,
    LossFunction.MEAN_ABSOLUTE_PERCENTAGE_ERROR: mape,
}


def stable_mcxent_from_logits(labels, logits, mask=None):
    """Fused softmax+CE on logits: the numerically stable path output
    layers take when their activation is SOFTMAX (no softmax is
    materialized)."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    return _masked_mean(_reduce_features(labels * (logz - logits)), mask)


def stable_xent_from_logits(labels, logits, mask=None):
    """Fused sigmoid+BCE on logits: the path output layers take when
    their activation is SIGMOID and their loss XENT."""
    per = (torch.clamp(logits, min=0.0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return _masked_mean(_reduce_features(per), mask)
