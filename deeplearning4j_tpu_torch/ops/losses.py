"""Loss-function names.

The ``LossFunction`` enum with the JAX package's member names, so an
output layer's configuration round-trips through ``configuration.json``.
Only the names are here: the loss math comes with the training slice.
"""

from __future__ import annotations

import enum

from deeplearning4j_tpu_torch.utils.serde import register_enum


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
