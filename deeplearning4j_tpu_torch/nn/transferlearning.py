"""Transfer learning: fine-tune overrides, freezing, surgery.

The JAX package's ``nn/transferlearning.py`` (reference:
nn/transferlearning/TransferLearning.java:34 — the Builder with
fineTuneConfiguration:73, setFeatureExtractor:84, nOutReplace:98-160, the
add/remove operations and the GraphBuilder variant;
FineTuneConfiguration.java; TransferLearningHelper.java).

Parameters are dicts keyed by layer name, so surgery is: edit the layer
tuple (or the node list), build the new model on the original's device,
then copy every layer whose parameter shapes still match (clones, so
training either model leaves the other as it was). A frozen layer gets
the no-op updater (optimize/solver.py): no update and no weight decay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.config import (GlobalConfig,
                                                MultiLayerConfiguration)
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.optimize.updaters import tree_leaves, tree_map


class FineTuneConfiguration:
    """Global-hyperparameter overrides applied to every retained layer
    (reference: transferlearning/FineTuneConfiguration.java)."""

    def __init__(self, **overrides):
        # recognized keys: updater, seed, l1, l2, dropout, compute_dtype
        self.overrides = overrides

    class Builder:
        def __init__(self):
            self._o = {}

        def updater(self, u):
            self._o["updater"] = u
            return self

        def seed(self, s: int):
            self._o["seed"] = int(s)
            return self

        def l1(self, v: float):
            self._o["l1"] = float(v)
            return self

        def l2(self, v: float):
            self._o["l2"] = float(v)
            return self

        def dropout(self, v: float):
            self._o["dropout"] = float(v)
            return self

        def compute_dtype(self, dt: str):
            """Activation dtype of the fine-tuned model (``"bfloat16"`` on
            the card); the parameters stay as they are."""
            self._o["compute_dtype"] = str(dt)
            return self

        def build(self) -> "FineTuneConfiguration":
            return FineTuneConfiguration(**self._o)

    def apply_to_global(self, g: GlobalConfig) -> GlobalConfig:
        kw = {k: v for k, v in self.overrides.items()
              if k in ("updater", "seed", "l1", "l2", "compute_dtype")}
        return dataclasses.replace(g, **kw) if kw else g

    def apply_to_layer(self, layer: Layer) -> Layer:
        kw = {k: self.overrides[k] for k in ("dropout", "l1", "l2")
              if k in self.overrides}
        # a per-layer updater yields to a new global one
        if "updater" in self.overrides and layer.updater is not None:
            kw["updater"] = None
        return dataclasses.replace(layer, **kw) if kw else layer


def _shapes(tree) -> List[tuple]:
    return [tuple(t.shape) for t in tree_leaves(tree)]


def _copy_matching_params(old_model, new_model) -> None:
    """Copy the parameters and state of every layer whose parameter
    shapes match (clones); the new model's optimizer state stays as its
    ``init`` made it and its iteration count starts at 0."""
    clone = lambda t: tree_map(
        lambda v: v.detach().clone().to(new_model.device), t)
    new_p, new_s = dict(new_model.params), dict(new_model.model_state)
    for name in new_p:
        if name in old_model.params and _shapes(
                old_model.params[name]) == _shapes(new_p[name]):
            new_p[name] = clone(old_model.params[name])
            old_s = old_model.model_state.get(name)
            if old_s is not None and _shapes(old_s) == _shapes(
                    new_s.get(name, {})):
                new_s[name] = clone(old_s)
    new_model.params, new_model.model_state = new_p, new_s
    new_model.iteration = 0


def _has_field(layer, field: str) -> bool:
    """True when ``field`` is a real dataclass field, possibly of the
    layer a wrapper (``FrozenLayer``) holds; its ``__getattr__`` would
    fool ``hasattr``."""
    if field in {f.name for f in dataclasses.fields(layer)}:
        return True
    under = getattr(layer, "underlying", None)
    return under is not None and _has_field(under, field)


def _replace_fields(layer, **kw):
    """``dataclasses.replace`` that reaches through wrapper layers to the
    layer that owns the fields."""
    names = {f.name for f in dataclasses.fields(layer)}
    if all(k in names for k in kw):
        return dataclasses.replace(layer, **kw)
    under = getattr(layer, "underlying", None)
    if under is None:
        raise TypeError(f"{type(layer).__name__} has no fields {kw}")
    return dataclasses.replace(layer, underlying=_replace_fields(under, **kw))


def _n_out_fields(n_out: int, weight_init) -> Dict[str, Any]:
    kw: Dict[str, Any] = {"n_out": int(n_out)}
    if weight_init is not None:
        kw["weight_init"] = weight_init
    return kw


class TransferLearning:
    """``TransferLearning.Builder`` for a ``MultiLayerNetwork``,
    ``TransferLearning.GraphBuilder`` for a ``ComputationGraph``."""

    class Builder:
        def __init__(self, orig_model):
            if orig_model.params is None:
                orig_model.init()
            self._orig = orig_model
            self._layers: List[Layer] = list(orig_model.conf.layers)
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._input_type = orig_model.conf.input_type

        def _index_of(self, layer: Union[int, str]) -> int:
            if isinstance(layer, int):
                return layer
            for i, l in enumerate(self._layers):
                if l.name == layer:
                    return i
            raise KeyError(f"no layer named {layer!r}")

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer: Union[int, str]):
            """Freeze every layer up to and including ``layer``."""
            self._freeze_until = self._index_of(layer)
            return self

        def n_out_replace(self, layer: Union[int, str], n_out: int,
                          weight_init=None):
            """A new ``n_out`` for ``layer`` (re-initialized), and the
            next layer with an ``n_in`` re-inferred."""
            i = self._index_of(layer)
            self._layers[i] = _replace_fields(
                self._layers[i], **_n_out_fields(n_out, weight_init))
            for j in range(i + 1, len(self._layers)):
                if _has_field(self._layers[j], "n_in"):
                    self._layers[j] = _replace_fields(self._layers[j],
                                                      n_in=None)
                    break
            return self

        def remove_output_layer(self):
            self._layers.pop()
            return self

        def remove_layers_from_output(self, n: int):
            for _ in range(n):
                self._layers.pop()
            return self

        def add_layer(self, layer: Layer):
            if layer.name is None:
                layer = dataclasses.replace(
                    layer, name=f"layer_{len(self._layers)}")
            self._layers.append(layer)
            return self

        def set_input_type(self, it):
            self._input_type = it
            return self

        def build(self):
            from deeplearning4j_tpu_torch.models.multi_layer_network import \
                MultiLayerNetwork
            orig = self._orig.conf
            g = orig.global_config
            if self._fine_tune is not None:
                g = self._fine_tune.apply_to_global(g)
            layers = []
            for i, l in enumerate(self._layers):
                if self._fine_tune is not None:
                    l = self._fine_tune.apply_to_layer(l)
                if self._freeze_until is not None:
                    l = dataclasses.replace(l,
                                            frozen=i <= self._freeze_until)
                layers.append(l)
            conf = MultiLayerConfiguration(
                global_config=g, layers=tuple(layers),
                input_type=self._input_type,
                manual_preprocessors=dict(orig.manual_preprocessors),
                backprop_type=orig.backprop_type,
                tbptt_fwd_length=orig.tbptt_fwd_length,
                tbptt_back_length=orig.tbptt_back_length)
            conf.resolve_shapes()
            model = MultiLayerNetwork(conf, device=self._orig.device).init()
            _copy_matching_params(self._orig, model)
            return model

    class GraphBuilder:
        def __init__(self, orig_model):
            if orig_model.params is None:
                orig_model.init()
            self._orig = orig_model
            conf = orig_model.conf
            self._nodes = {n.name: n for n in conf.nodes}
            self._order = [n.name for n in conf.nodes]
            self._inputs = list(conf.network_inputs)
            self._input_types = list(conf.network_input_types)
            self._outputs = list(conf.network_outputs)
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._frozen: set = set()

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *names: str):
            """Freeze the named vertices and everything upstream."""
            frontier = set(names)
            while frontier:
                n = frontier.pop()
                if n in self._frozen or n in self._inputs:
                    continue
                self._frozen.add(n)
                frontier.update(self._nodes[n].inputs)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Remove ``name`` and every node downstream of it."""
            self._nodes.pop(name)
            self._order.remove(name)
            for n in [n for n, node in self._nodes.items()
                      if name in node.inputs]:
                if n in self._nodes:
                    self.remove_vertex_and_connections(n)
            self._outputs = [o for o in self._outputs if o in self._nodes]
            return self

        def remove_vertex(self, name: str):
            return self.remove_vertex_and_connections(name)

        def add_layer(self, name: str, layer: Layer, *inputs: str):
            from deeplearning4j_tpu_torch.nn.graph.config import NodeDef
            self._nodes[name] = NodeDef(
                name=name, inputs=tuple(inputs),
                layer=dataclasses.replace(layer, name=name))
            self._order.append(name)
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            from deeplearning4j_tpu_torch.nn.graph.config import NodeDef
            self._nodes[name] = NodeDef(name=name, inputs=tuple(inputs),
                                        vertex=vertex)
            self._order.append(name)
            return self

        def n_out_replace(self, name: str, n_out: int, weight_init=None):
            node = self._nodes[name]
            self._nodes[name] = dataclasses.replace(
                node, layer=_replace_fields(
                    node.layer, **_n_out_fields(n_out, weight_init)))
            # downstream n_in re-inferred
            for n, other in self._nodes.items():
                if name in other.inputs and other.layer is not None and \
                        _has_field(other.layer, "n_in"):
                    self._nodes[n] = dataclasses.replace(
                        other, layer=_replace_fields(other.layer,
                                                     n_in=None))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def build(self):
            from deeplearning4j_tpu_torch.models.computation_graph import \
                ComputationGraph
            from deeplearning4j_tpu_torch.nn.graph.config import \
                ComputationGraphConfiguration
            orig = self._orig.conf
            g = orig.global_config
            if self._fine_tune is not None:
                g = self._fine_tune.apply_to_global(g)
            nodes = []
            for name in self._order:
                node = self._nodes[name]
                layer = node.layer
                if layer is not None:
                    if self._fine_tune is not None:
                        layer = self._fine_tune.apply_to_layer(layer)
                    # extend, never clear: a layer frozen in the original
                    # configuration stays frozen
                    if name in self._frozen and not layer.frozen:
                        layer = dataclasses.replace(layer, frozen=True)
                    node = dataclasses.replace(node, layer=layer)
                nodes.append(node)
            conf = ComputationGraphConfiguration(
                global_config=g, network_inputs=tuple(self._inputs),
                network_input_types=tuple(self._input_types),
                nodes=tuple(nodes), network_outputs=tuple(self._outputs),
                backprop_type=orig.backprop_type,
                tbptt_fwd_length=orig.tbptt_fwd_length)
            conf.resolve()
            model = ComputationGraph(conf, device=self._orig.device).init()
            _copy_matching_params(self._orig, model)
            return model


class TransferLearningHelper:
    """Featurize-once training (reference: TransferLearningHelper.java):
    the inputs go through the frozen front once, and only the unfrozen
    tail trains, on the cached activations."""

    def __init__(self, model, frozen_boundary: Union[int, str, None] = None):
        from deeplearning4j_tpu_torch.models.multi_layer_network import \
            MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise TypeError("TransferLearningHelper supports "
                            "MultiLayerNetwork")
        self._orig = model
        layers = model.conf.layers
        if frozen_boundary is None:
            idx = max((i for i, l in enumerate(layers) if l.frozen),
                      default=-1)
        elif isinstance(frozen_boundary, str):
            idx = [l.name for l in layers].index(frozen_boundary)
        else:
            idx = frozen_boundary
        if idx < 0:
            raise ValueError("model has no frozen layers and no boundary "
                             "was given")
        self._boundary = idx
        # the tail's input type is layer idx's OUTPUT type (featurize
        # returns the raw activation), so the tail re-infers any
        # preprocessor at the boundary itself
        tail_input = layers[idx].output_type(
            model.conf.layer_input_types()[idx])
        conf = MultiLayerConfiguration(
            global_config=model.conf.global_config,
            layers=tuple(dataclasses.replace(l, frozen=False)
                         for l in layers[idx + 1:]),
            input_type=tail_input)
        conf.resolve_shapes()
        self._tail = MultiLayerNetwork(conf, device=model.device).init()
        _copy_matching_params(model, self._tail)

    def unfrozen_mln(self):
        return self._tail

    def featurize(self, dataset: DataSet) -> DataSet:
        acts = self._orig.feed_forward(dataset.features, train=False)
        return DataSet(acts[self._boundary].float().cpu().numpy(),
                       dataset.labels, dataset.features_mask,
                       dataset.labels_mask)

    def fit_featurized(self, dataset: DataSet):
        """Fit the tail on featurized data and copy its parameters (and
        state) back into the original model."""
        self._tail.fit(dataset)
        clone = lambda t: tree_map(lambda v: v.detach().clone(), t)
        params, state = dict(self._orig.params), dict(
            self._orig.model_state)
        for name in self._tail.params:
            params[name] = clone(self._tail.params[name])
            if name in self._tail.model_state:
                state[name] = clone(self._tail.model_state[name])
        self._orig.params, self._orig.model_state = params, state
        return self

    def output_from_featurized(self, featurized) -> torch.Tensor:
        return self._tail.output(featurized)
