"""ComputationGraph configuration — arbitrary DAGs.

Analog of the reference's ``ComputationGraphConfiguration`` +
``GraphBuilder`` (deeplearning4j-nn/.../nn/conf/ComputationGraphConfiguration
.java; topological sort in nn/graph/ComputationGraph.java:1216 via Kahn's
algorithm). Multi-input/multi-output, layer nodes + combinator vertices.

    conf = (NeuralNetConfiguration.Builder().updater(Adam(1e-3))
            .graph_builder()
            .add_inputs("in")
            .add_layer("conv1", ConvolutionLayer(...), "in")
            .add_vertex("add", ElementWiseVertex(op="add"), "conv1", "conv2")
            .add_layer("out", OutputLayer(...), "add")
            .set_outputs("out")
            .set_input_types(InputType.convolutional(32, 32, 3))
            .build())
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.nn.config import GlobalConfig
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.layers.base import Layer
from deeplearning4j_tpu_torch.nn.graph.vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.preprocessors import infer_preprocessor, Preprocessor
from deeplearning4j_tpu_torch.utils import serde
from deeplearning4j_tpu_torch.utils.serde import register_serializable


@register_serializable
@dataclasses.dataclass(frozen=True)
class NodeDef:
    """One DAG node: exactly one of ``layer`` / ``vertex`` is set."""
    name: str
    inputs: Tuple[str, ...]
    layer: Optional[Layer] = None
    vertex: Optional[GraphVertex] = None
    preprocessor: Optional[Preprocessor] = None  # applied to single input


class GraphBuilder:
    def __init__(self, cfg: GlobalConfig):
        self._cfg = cfg
        self._inputs: List[str] = []
        self._input_types: List[InputType] = []
        self._nodes: List[NodeDef] = []
        self._outputs: List[str] = []

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str,
                  preprocessor: Optional[Preprocessor] = None) -> "GraphBuilder":
        if len(inputs) != 1:
            raise ValueError(
                f"layer node '{name}' needs exactly 1 input; wire multi-input"
                " through a MergeVertex/ElementWiseVertex first")
        layer = dataclasses.replace(layer, name=name)
        self._nodes.append(NodeDef(name, tuple(inputs), layer=layer,
                                   preprocessor=preprocessor))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._nodes.append(NodeDef(name, tuple(inputs), vertex=vertex))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop_type(self, kind: str) -> "GraphBuilder":
        """'standard' or 'tbptt', with ListBuilder.backprop_type's alias
        set (reference: GraphBuilder.backpropType)."""
        kind = kind.lower()
        if kind not in ("standard", "tbptt", "truncated_bptt"):
            raise ValueError(f"unknown backprop type {kind!r}")
        self._backprop_type = "tbptt" if kind != "standard" else "standard"
        return self

    def tbptt_fwd_length(self, k: int) -> "GraphBuilder":
        self._tbptt_fwd_length = int(k)
        return self

    def tbptt_back_length(self, k: int) -> "GraphBuilder":
        """Accepted for API parity: gradients are cut at the segment
        boundary, so the back length is the forward length (build()
        warns when they differ)."""
        self._tbptt_back_length = int(k)
        return self

    def build(self) -> "ComputationGraphConfiguration":
        fwd = getattr(self, "_tbptt_fwd_length", 20)
        back = getattr(self, "_tbptt_back_length", fwd)
        if back != fwd:
            warnings.warn("tbptt_back_length != tbptt_fwd_length: "
                          "gradients truncate at the fwd chunk boundary "
                          f"({fwd}), not at {back}")
        conf = ComputationGraphConfiguration(
            global_config=self._cfg,
            network_inputs=tuple(self._inputs),
            network_input_types=tuple(self._input_types),
            nodes=tuple(self._nodes),
            network_outputs=tuple(self._outputs),
            backprop_type=getattr(self, "_backprop_type", "standard"),
            tbptt_fwd_length=fwd,
        )
        conf.resolve()
        return conf


@register_serializable
@dataclasses.dataclass
class ComputationGraphConfiguration:
    global_config: GlobalConfig
    network_inputs: Tuple[str, ...]
    network_input_types: Tuple[InputType, ...]
    nodes: Tuple[NodeDef, ...]
    network_outputs: Tuple[str, ...]
    backprop_type: str = "standard"
    tbptt_fwd_length: int = 20

    # ---- validation + shape inference -----------------------------------
    def resolve(self):
        by_name = {n.name: n for n in self.nodes}
        for inp in self.network_inputs:
            if inp in by_name:
                raise ValueError(f"node name collides with input: {inp}")
        for n in self.nodes:
            for src in n.inputs:
                if src not in by_name and src not in self.network_inputs:
                    raise ValueError(f"node '{n.name}' references unknown"
                                     f" input '{src}'")
        for out in self.network_outputs:
            if out not in by_name:
                raise ValueError(f"unknown output node: {out}")
        self._topo = self._topological_sort()
        if self.network_input_types:
            self._infer_types()
        return self

    def _topological_sort(self) -> List[str]:
        """Kahn's algorithm, same as the reference's topologicalSortOrder
        (ComputationGraph.java:1216)."""
        indeg: Dict[str, int] = {n.name: 0 for n in self.nodes}
        consumers: Dict[str, List[str]] = {}
        for n in self.nodes:
            for src in n.inputs:
                if src in indeg or src in self.network_inputs:
                    consumers.setdefault(src, []).append(n.name)
            indeg[n.name] = sum(1 for s in n.inputs
                                if s not in self.network_inputs)
        queue = [n.name for n in self.nodes if indeg[n.name] == 0]
        order: List[str] = []
        while queue:
            cur = queue.pop()
            order.append(cur)
            for c in consumers.get(cur, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    queue.append(c)
        if len(order) != len(self.nodes):
            cyc = [k for k, v in indeg.items() if v > 0]
            raise ValueError(f"graph has a cycle involving: {cyc}")
        return order

    def _infer_types(self):
        if len(self.network_input_types) != len(self.network_inputs):
            raise ValueError("set_input_types arity != add_inputs arity")
        types: Dict[str, InputType] = dict(zip(self.network_inputs,
                                               self.network_input_types))
        new_nodes = {n.name: n for n in self.nodes}
        node_input_types: Dict[str, List[InputType]] = {}
        for name in self._topo:
            node = new_nodes[name]
            in_types = [types[s] for s in node.inputs]
            if node.layer is not None:
                it = in_types[0]
                pp = node.preprocessor or infer_preprocessor(it, node.layer)
                if pp is not None:
                    it = pp.output_type(it)
                layer = node.layer
                if hasattr(layer, "n_in") and layer.n_in is None and hasattr(
                        layer, "resolved_n_in"):
                    try:
                        layer = dataclasses.replace(
                            layer, n_in=layer.resolved_n_in(it))
                    except Exception:
                        pass
                node = dataclasses.replace(node, layer=layer, preprocessor=pp)
                new_nodes[name] = node
                types[name] = layer.output_type(it)
                node_in_types = [it]
            else:
                types[name] = node.vertex.output_type(*in_types)
                node_in_types = in_types
            node_input_types[name] = node_in_types
        self.nodes = tuple(new_nodes[n.name] for n in self.nodes)
        self._types = types
        self._node_input_types = node_input_types

    # ---- accessors ------------------------------------------------------
    def topological_order(self) -> List[str]:
        if not hasattr(self, "_topo"):
            self.resolve()
        return self._topo

    def node(self, name: str) -> NodeDef:
        return {n.name: n for n in self.nodes}[name]

    def activation_type(self, name: str) -> InputType:
        if not hasattr(self, "_types"):
            self.resolve()
        return self._types[name]

    def layer_input_type(self, name: str) -> InputType:
        if not hasattr(self, "_node_input_types"):
            self.resolve()
        return self._node_input_types[name][0]

    # ---- serde ----------------------------------------------------------
    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        conf = serde.from_json(s)
        conf.network_inputs = tuple(conf.network_inputs)
        conf.network_input_types = tuple(conf.network_input_types)
        conf.nodes = tuple(conf.nodes)
        conf.network_outputs = tuple(conf.network_outputs)
        conf.resolve()
        return conf
