"""The device rule of the port's entry points.

Every entry point (``ComputationGraph(conf, device=...)``,
``ResNet50(...).init(device=...)``, ``restore_model(path, device=...)``,
``ServingEngine``) runs on the card unless the caller asks for the CPU.
Without a card and without an explicit ``"cpu"`` they raise: a model
that silently carried on on the CPU would make every number it reports
a CPU number.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device needs a card to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def float_dtype(name: Optional[str]) -> torch.dtype:
    """Config dtype string -> torch dtype (``None`` = float32)."""
    if name in (None, "float32"):
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported dtype {name!r}")
