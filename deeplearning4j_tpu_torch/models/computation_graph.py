"""ComputationGraph — arbitrary-DAG model (inference).

Analog of the reference's ``ComputationGraph``
(nn/graph/ComputationGraph.java:93 — init():377, topologicalSortOrder()
:1216) in the JAX package's form: parameters and layer state are plain
dicts keyed ``params[layer][key]``, and the forward walks the
configuration's topological order, calling each layer's ``apply``. The
port serves, so the walk is the inference forward; ``fit`` comes with the
training slice.

The model lives on one device, chosen at construction: ``cuda`` unless
the caller passes ``device="cpu"`` (utils/device.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.base import cast_params, compute_cast
from deeplearning4j_tpu_torch.nn.graph.config import \
    ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.utils.device import DeviceLike, resolve_device

Tree = Dict[str, Dict[str, torch.Tensor]]

_EVAL = LayerContext(train=False)


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.conf = conf
        conf.resolve()
        self._topo = conf.topological_order()
        self._nodes = {n.name: n for n in conf.nodes}
        self._layer_nodes = [n for n in conf.nodes if n.layer is not None]
        self.layer_names = tuple(n.name for n in self._layer_nodes)
        self.params: Optional[Tree] = None
        self.model_state: Optional[Tree] = None
        self.iteration = 0
        self.epoch_count = 0

    # ---- init -----------------------------------------------------------
    def init(self, seed: Optional[int] = None) -> "ComputationGraph":
        """Random parameters from a ``torch.Generator`` seeded with the
        configuration's seed (or ``seed``); drawn on the CPU so they do
        not depend on the device, then moved to it once."""
        g = self.conf.global_config
        gen = torch.Generator().manual_seed(g.seed if seed is None else seed)
        params: Tree = {}
        state: Tree = {}
        for node in self._layer_nodes:
            it = self.conf.layer_input_type(node.name)
            layer = node.layer
            lp = layer.initialize(gen, it) if layer.has_params else {}
            params[node.name] = {k: v.to(self.device) for k, v in lp.items()}
            state[node.name] = {k: v.to(self.device)
                                for k, v in layer.init_state(it).items()}
        self.params, self.model_state = params, state
        return self

    def set_params(self, params: Tree, model_state: Optional[Tree] = None):
        """Replace parameters (and state) with tensors of the same names
        and shapes as this model's; a missing, extra or mis-shaped leaf
        raises. Floating leaves keep the incoming dtype."""
        if self.params is None:
            self.init()
        self.params = _conform(self.params, params, self.device, "params")
        if model_state is not None:
            self.model_state = _conform(self.model_state, model_state,
                                        self.device, "state")

    def num_params(self) -> int:
        return sum(v.numel() for lp in (self.params or {}).values()
                   for v in lp.values())

    # ---- forward --------------------------------------------------------
    def _walk(self, params: Tree, model_state: Tree,
              inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dt = self.conf.global_config.compute_dtype
        acts = {k: compute_cast(v, dt) for k, v in inputs.items()}
        for name in self._topo:
            node = self._nodes[name]
            xs = [acts[s] for s in node.inputs]
            if node.layer is None:
                acts[name] = node.vertex.apply(*xs)
                continue
            x = xs[0]
            if node.preprocessor is not None:
                x = node.preprocessor.apply(x)
            lp = cast_params(params.get(name, {}), dt)
            acts[name], _ = node.layer.apply(lp, model_state.get(name, {}),
                                             x, _EVAL)
        return acts

    def inference_state(self, params: Tree, model_state: Tree) -> Tree:
        """``model_state`` with each layer's inference constants folded in
        (layers that define ``fold_inference_state``, e.g. the fused
        block's BN scale/shift), computed from ``params`` cast to the
        compute dtype exactly as the forward casts them — so a forward on
        the folded state gives the same bits as one on the plain state."""
        dt = self.conf.global_config.compute_dtype
        out = dict(model_state)
        with torch.inference_mode():
            for node in self._layer_nodes:
                fold = getattr(node.layer, "fold_inference_state", None)
                if fold is not None:
                    out[node.name] = fold(cast_params(params[node.name], dt),
                                          model_state[node.name])
        return out

    def build_inference_fn(self):
        """Pure inference forward ``(params, model_state, x) -> y`` for
        single-input single-output graphs — the shape the serving engine
        (parallel/serving.py) batches over."""
        if len(self.conf.network_inputs) != 1 or \
                len(self.conf.network_outputs) != 1:
            raise ValueError(
                "build_inference_fn requires a single-input single-output"
                f" graph; this one has inputs={self.conf.network_inputs}"
                f" outputs={self.conf.network_outputs}")
        if self.params is None:
            self.init()
        in_name = self.conf.network_inputs[0]
        out_name = self.conf.network_outputs[0]

        def fwd(params, model_state, x):
            with torch.inference_mode():
                return self._walk(params, model_state, {in_name: x})[out_name]
        return fwd

    def _as_input(self, f) -> torch.Tensor:
        if isinstance(f, torch.Tensor):
            return f.to(self.device)
        return torch.as_tensor(np.asarray(f), device=self.device)

    def output(self, *features):
        """Forward pass on this model's device; returns a tensor for
        single-output graphs, else a list (reference:
        ComputationGraph.output(INDArray...))."""
        if self.params is None:
            self.init()
        if len(features) == 1 and isinstance(features[0], (list, tuple)):
            features = tuple(features[0])
        inputs = {k: self._as_input(f)
                  for k, f in zip(self.conf.network_inputs, features)}
        with torch.inference_mode():
            acts = self._walk(self.params, self.model_state, inputs)
        outs = [acts[o] for o in self.conf.network_outputs]
        return outs[0] if len(outs) == 1 else outs

    def summary(self) -> str:
        lines = [f"{'name':<24}{'type':<26}{'inputs':<30}{'params':>10}"]
        for name in self._topo:
            node = self._nodes[name]
            kind = (type(node.layer).__name__ if node.layer is not None
                    else type(node.vertex).__name__)
            n = sum(v.numel() for v in (self.params or {}).get(name,
                                                                {}).values())
            lines.append(f"{name:<24}{kind:<26}"
                         f"{','.join(node.inputs):<30}{n:>10}")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)


def _conform(template: Tree, new: Tree, device: torch.device,
             what: str) -> Tree:
    """``new`` checked name for name and shape for shape against
    ``template``, moved to ``device``."""
    if set(new) != set(template):
        raise KeyError(f"{what}: layer names differ: missing "
                       f"{sorted(set(template) - set(new))}, unexpected "
                       f"{sorted(set(new) - set(template))}")
    out: Tree = {}
    for layer, tl in template.items():
        nl = new[layer]
        if set(nl) != set(tl):
            raise KeyError(f"{what}[{layer!r}]: keys differ: missing "
                           f"{sorted(set(tl) - set(nl))}, unexpected "
                           f"{sorted(set(nl) - set(tl))}")
        out[layer] = {}
        for k, t in tl.items():
            v = torch.as_tensor(nl[k])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{what}[{layer!r}][{k!r}]: shape "
                                 f"{tuple(v.shape)} != {tuple(t.shape)}")
            out[layer][k] = v.to(device)
    return out
