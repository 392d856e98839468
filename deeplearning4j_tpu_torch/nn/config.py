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

``list()`` starts the sequential builder (``ListBuilder`` →
``MultiLayerConfiguration``, the config of ``MultiLayerNetwork``);
``graph_builder()`` the DAG builder (nn/graph/config.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.preprocessors import (Preprocessor,
                                                       infer_preprocessor)
from deeplearning4j_tpu_torch.utils import serde

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

        def list(self) -> "ListBuilder":
            return ListBuilder(self._cfg)

        def graph_builder(self):
            from deeplearning4j_tpu_torch.nn.graph.config import GraphBuilder
            return GraphBuilder(self._cfg)


class ListBuilder:
    """Sequential-model builder (reference: NeuralNetConfiguration.Builder
    .list() → MultiLayerConfiguration.Builder)."""

    def __init__(self, cfg: GlobalConfig):
        self._cfg = cfg
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[int, Preprocessor] = {}
        self._backprop_type: str = "standard"
        self._tbptt_fwd_length: int = 20
        self._tbptt_back_length: int = 20

    def backprop_type(self, kind: str) -> "ListBuilder":
        """'standard' or 'tbptt' (reference: BackpropType.TruncatedBPTT).
        A tbptt configuration builds and round-trips; its fit is not
        ported yet."""
        kind = kind.lower()
        if kind not in ("standard", "tbptt", "truncated_bptt"):
            raise ValueError(f"unknown backprop type {kind!r}")
        self._backprop_type = "tbptt" if kind != "standard" else "standard"
        return self

    def tbptt_fwd_length(self, k: int) -> "ListBuilder":
        self._tbptt_fwd_length = int(k)
        return self

    def tbptt_back_length(self, k: int) -> "ListBuilder":
        self._tbptt_back_length = int(k)
        return self

    def layer(self, layer: Layer) -> "ListBuilder":
        self._layers.append(layer)
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_pre_processor(self, idx: int, pp: Preprocessor
                            ) -> "ListBuilder":
        self._preprocessors[idx] = pp
        return self

    def build(self) -> "MultiLayerConfiguration":
        """Layers named ``layer_<i>`` unless named, the global L1/L2 pushed
        into layers that set none, shapes resolved (as the JAX package's
        builder does)."""
        if not self._layers:
            raise ValueError("no layers configured")
        layers = []
        for i, l in enumerate(self._layers):
            updates = {}
            if l.name is None:
                updates["name"] = f"layer_{i}"
            if l.l1 == 0.0 and self._cfg.l1:
                updates["l1"] = self._cfg.l1
            if l.l2 == 0.0 and self._cfg.l2:
                updates["l2"] = self._cfg.l2
            layers.append(dataclasses.replace(l, **updates) if updates
                          else l)
        conf = MultiLayerConfiguration(
            global_config=self._cfg,
            layers=tuple(layers),
            input_type=self._input_type,
            manual_preprocessors=dict(self._preprocessors),
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd_length,
            tbptt_back_length=self._tbptt_back_length,
        )
        conf.resolve_shapes()
        return conf


@register_serializable
@dataclasses.dataclass
class MultiLayerConfiguration:
    """Sequential stack config (reference: MultiLayerConfiguration.java:55),
    field for field the JAX package's, so ``configuration.json`` reads and
    writes the same."""
    global_config: GlobalConfig
    layers: Tuple[Layer, ...]
    input_type: Optional[InputType] = None
    manual_preprocessors: Dict[int, Preprocessor] = dataclasses.field(
        default_factory=dict)
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def resolve_shapes(self):
        """Per-layer input types (post-preprocessor) and the automatic
        preprocessors; fills each layer's ``n_in`` where it is None."""
        if self.input_type is None:
            raise ValueError(
                "set_input_type(...) is required for shape inference")
        input_types: List[InputType] = []
        preprocessors: Dict[int, Preprocessor] = {}
        cur = self.input_type
        resolved = list(self.layers)
        for i, layer in enumerate(resolved):
            pp = self.manual_preprocessors.get(i)
            if pp is None:
                pp = infer_preprocessor(cur, layer)
            if pp is not None:
                preprocessors[i] = pp
                cur = pp.output_type(cur)
            if getattr(layer, "n_in", 0) is None and hasattr(
                    layer, "resolved_n_in"):
                layer = dataclasses.replace(layer,
                                            n_in=layer.resolved_n_in(cur))
                resolved[i] = layer
            input_types.append(cur)
            cur = layer.output_type(cur)
        self.layers = tuple(resolved)
        self._input_types = input_types
        self._auto_preprocessors = preprocessors
        self._output_type = cur
        return input_types, preprocessors

    @property
    def output_type(self) -> InputType:
        if not hasattr(self, "_output_type"):
            self.resolve_shapes()
        return self._output_type

    def layer_input_types(self) -> List[InputType]:
        if not hasattr(self, "_input_types"):
            self.resolve_shapes()
        return self._input_types

    def preprocessors(self) -> Dict[int, Preprocessor]:
        if not hasattr(self, "_auto_preprocessors"):
            self.resolve_shapes()
        return self._auto_preprocessors

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        conf = serde.from_json(s)
        if not isinstance(conf, MultiLayerConfiguration):
            raise TypeError("JSON did not decode to MultiLayerConfiguration")
        # dict keys arrive as strings from JSON
        conf.manual_preprocessors = {int(k): v for k, v in
                                     conf.manual_preprocessors.items()}
        conf.layers = tuple(conf.layers)
        conf.resolve_shapes()
        return conf
