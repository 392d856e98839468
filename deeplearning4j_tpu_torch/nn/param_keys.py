"""Shared parameter-key classification.

The framework's parameter dicts use short conventional leaf names; code
that must treat bias-like parameters differently from weights (L1/L2
regularization, constraints) asks here — the single source of truth for
that classification (the reference's analog: ParamInitializer.isBiasParam
/ isWeightParam, nn/api/ParamInitializer.java). A copy of the JAX
package's table, keyed by the leaf name rather than a pytree path.
"""

BIAS_KEYS = ("b", "vb", "beta", "mean", "var", "pI", "pF", "pO",
             "bmu", "blv", "bout")

# Neither weight nor bias: statistics-like parameters that must never be
# regularized or constrained (CenterLossOutputLayer's per-class centers —
# the reference updates them by EMA, never through weight decay).
EXCLUDED_KEYS = ("centers",)


def is_bias_key(key: str) -> bool:
    """True for a bias-like leaf name (bias, BN shift/statistics,
    peephole weights...)."""
    return key in BIAS_KEYS


def is_weight_key(key: str) -> bool:
    """True for parameters eligible for L1/L2 and constraints."""
    return key not in BIAS_KEYS and key not in EXCLUDED_KEYS
