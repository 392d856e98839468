"""Loss functions.

The ``LossFunction`` enum with the JAX package's member names, so an
output layer's configuration round-trips through ``configuration.json``,
and the loss math of the JAX package's ``ops/losses.py`` as plain torch:
``loss(labels, output, mask) -> scalar``, the mean over (unmasked)
examples, with gradients from ``torch.autograd``. MCXENT and the fused
softmax+cross-entropy on logits are ported; the other losses wait.
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
        fn = _FNS.get(self)
        if fn is None:
            raise NotImplementedError(f"LossFunction.{self.name}: not "
                                      "ported yet")
        return fn(labels, output, mask)


def mcxent(labels, output, mask=None):
    p = torch.clamp(output, _EPS, 1.0)
    return _masked_mean(-_reduce_features(labels * torch.log(p)), mask)


_FNS = {
    LossFunction.MCXENT: mcxent,
    LossFunction.NEGATIVELOGLIKELIHOOD: mcxent,  # same math as reference
}


def stable_mcxent_from_logits(labels, logits, mask=None):
    """Fused softmax+CE on logits: the numerically stable path output
    layers take when their activation is SOFTMAX (no softmax is
    materialized)."""
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    return _masked_mean(_reduce_features(labels * (logz - logits)), mask)
