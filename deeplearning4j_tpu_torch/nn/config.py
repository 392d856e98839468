"""Network configuration: the builder and the global config.

Analog of the reference's config system (nn/conf/
NeuralNetConfiguration.java:82, Builder at :584) with the JAX package's
builder API:

    conf = (NeuralNetConfiguration.Builder()
            .seed(123)
            .updater(Nesterovs(1e-2, 0.9))
            .compute_dtype("bfloat16")
            .graph_builder()
            .add_inputs("in")
            ...
            .build())

Only the DAG builder (``graph_builder``) is ported; the sequential
``list()`` builder comes with ``MultiLayerNetwork``.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.optimize.updaters import (
    GradientNormalizationConfig,
    Sgd,
    Updater,
)
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class GlobalConfig:
    """Cross-layer hyperparameters set on NeuralNetConfiguration.Builder."""
    seed: int = 12345
    updater: Updater = dataclasses.field(default_factory=lambda: Sgd(1e-3))
    gradient_normalization: GradientNormalizationConfig = dataclasses.field(
        default_factory=GradientNormalizationConfig)
    l1: float = 0.0
    l2: float = 0.0
    dtype: str = "float32"          # param dtype
    compute_dtype: str = "float32"  # activation dtype ("bfloat16" on the card)
    mini_batch: bool = True


class NeuralNetConfiguration:
    """Entry point; only hosts the Builder, matching reference ergonomics."""

    class Builder:
        def __init__(self):
            self._cfg = GlobalConfig()

        def _replace(self, **kw):
            self._cfg = dataclasses.replace(self._cfg, **kw)
            return self

        def seed(self, s: int):
            return self._replace(seed=int(s))

        def updater(self, u: Updater):
            return self._replace(updater=u)

        def l1(self, v: float):
            return self._replace(l1=v)

        def l2(self, v: float):
            return self._replace(l2=v)

        def gradient_normalization(self, kind: str, threshold: float = 1.0):
            return self._replace(gradient_normalization=
                                 GradientNormalizationConfig(kind, threshold))

        def dtype(self, dt: str):
            return self._replace(dtype=dt)

        def compute_dtype(self, dt: str):
            return self._replace(compute_dtype=dt)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.graph.config import GraphBuilder
            return GraphBuilder(self._cfg)
