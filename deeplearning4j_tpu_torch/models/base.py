"""Precision policy shared by the models.

The JAX package's ``compute_cast`` and ``cast_params``: with
``compute_dtype="bfloat16"`` the graph input and every floating
**parameter** are rounded to bf16 for the forward, while the layer
**state** (BatchNorm running statistics) stays float32 and the master
parameters stay as stored.
"""

from __future__ import annotations

from typing import Dict

import torch


def compute_cast(x: torch.Tensor, dt: str) -> torch.Tensor:
    """Cast an activation to the configured compute dtype (bf16 policy)."""
    if dt == "bfloat16" and x.is_floating_point():
        return x.to(torch.bfloat16)
    return x


def cast_params(lp: Dict[str, torch.Tensor], dt: str
                ) -> Dict[str, torch.Tensor]:
    """A layer's float params in the compute dtype (a no-op for params
    already held in it, e.g. a serving engine's committed bf16 copy)."""
    if dt != "bfloat16":
        return lp
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
            for k, v in lp.items()}
