"""Finite-difference gradient checking (reference: GradientCheckUtil)."""

from deeplearning4j_tpu_torch.gradientcheck.gradient_check_util import (
    check_gradients, check_model_gradients)

__all__ = ["check_gradients", "check_model_gradients"]
