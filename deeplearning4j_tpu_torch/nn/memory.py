"""Pre-flight memory estimation.

The port of the JAX package's ``nn/memory.py`` (reference:
``nn/conf/memory/``: ``MemoryReport.java``, ``LayerMemoryReport.java``,
``NetworkMemoryReport.java``): a per-layer and whole-network breakdown of
parameter, gradient, updater-state and activation memory for a given
minibatch size, produced before training. The arithmetic is a copy.
Parameter counts come from each layer's own ``initialize`` on the
``meta`` device, so nothing is allocated. ``memory_report`` also takes a
``ComputationGraphConfiguration``: its layer nodes, in topological
order, each at its resolved input type (the JAX package's takes a
MultiLayerConfiguration only).

``device_memory_analysis`` is the counterpart of ``xla_memory_analysis``:
where the JAX package reads the compiled executable's buffer assignment,
the port reads the card's caching allocator around one real forward, or
one whole train step with the optimizer (on a clone, so the model is
untouched). On the CPU it returns ``{}``, as the JAX package's does for a
backend without an analysis.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.models.serialization import flatten_paths

# Per-parameter updater-state slots (Adam keeps m and v -> 2, momentum 1).
_UPDATER_STATE_SLOTS = {
    "Sgd": 0, "NoOp": 0,
    "Nesterovs": 1, "AdaGrad": 1, "RmsProp": 1,
    "Adam": 2, "AdamW": 2, "AdaMax": 2, "Nadam": 2, "AdaDelta": 2,
    "AMSGrad": 3,
}


def _nelems(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= max(int(d), 1)  # unknown time dim (-1) counted as 1 per step
    return n


@dataclass
class LayerMemoryReport:
    """Per-layer estimate (reference: LayerMemoryReport.Builder)."""

    layer_name: str
    layer_type: str
    parameter_count: int
    activation_elements_per_example: int
    updater_state_slots: int

    def total_bytes(self, batch_size: int, dtype_bytes: int = 4,
                    training: bool = True) -> int:
        fixed = self.parameter_count * dtype_bytes
        if training:
            # gradients mirror params; updater state per slot
            fixed += self.parameter_count * dtype_bytes
            fixed += (self.parameter_count * self.updater_state_slots
                      * dtype_bytes)
        var = self.activation_elements_per_example * batch_size * dtype_bytes
        if training:
            var *= 2  # activation gradients in backward
        return fixed + var


@dataclass
class NetworkMemoryReport:
    """Whole-network roll-up (reference: NetworkMemoryReport)."""

    layer_reports: List[LayerMemoryReport] = field(default_factory=list)
    model_name: str = "MultiLayerNetwork"

    @property
    def total_parameters(self) -> int:
        return sum(r.parameter_count for r in self.layer_reports)

    def total_bytes(self, batch_size: int, dtype_bytes: int = 4,
                    training: bool = True) -> int:
        return sum(r.total_bytes(batch_size, dtype_bytes, training)
                   for r in self.layer_reports)

    def to_json(self) -> str:
        return json.dumps({
            "model": self.model_name,
            "total_parameters": self.total_parameters,
            "layers": [{
                "name": r.layer_name, "type": r.layer_type,
                "parameters": r.parameter_count,
                "activation_elements_per_example":
                    r.activation_elements_per_example,
                "updater_state_slots": r.updater_state_slots,
            } for r in self.layer_reports],
        }, indent=2)

    def __str__(self) -> str:
        lines = [f"NetworkMemoryReport: {self.model_name} "
                 f"({self.total_parameters:,} params)"]
        lines.append(f"  {'layer':<24}{'type':<26}{'params':>12}"
                     f"{'act/ex':>12}")
        for r in self.layer_reports:
            lines.append(f"  {r.layer_name:<24}{r.layer_type:<26}"
                         f"{r.parameter_count:>12,}"
                         f"{r.activation_elements_per_example:>12,}")
        for bs in (1, 32):
            mb = self.total_bytes(bs) / (1 << 20)
            lines.append(f"  train memory @ batch {bs}: {mb:,.1f} MB (fp32)")
        return "\n".join(lines)


def _layers_and_types(conf):
    """(layer, input type) in forward order: a MultiLayerConfiguration's
    layers, or a graph's layer nodes in topological order."""
    if hasattr(conf, "layers"):
        conf.resolve_shapes()
        return list(zip(conf.layers, conf.layer_input_types()))
    order = conf.topological_order()
    nodes = {n.name: n for n in conf.nodes}
    return [(nodes[name].layer, conf.layer_input_type(name))
            for name in order if nodes[name].layer is not None]


def memory_report(conf, model_name: Optional[str] = None
                  ) -> NetworkMemoryReport:
    """A NetworkMemoryReport of a MultiLayerConfiguration (or a
    ComputationGraphConfiguration): parameter counts from each layer's
    ``initialize`` on the ``meta`` device, activation sizes from its
    output type."""
    gen = torch.Generator().manual_seed(0)
    reports: List[LayerMemoryReport] = []
    for i, (layer, it) in enumerate(_layers_and_types(conf)):
        pcount = 0
        if layer.has_params:
            with torch.device("meta"):
                pcount = sum(t.numel() for t in flatten_paths(
                    layer.initialize(gen, it)).values())
        out_t = layer.output_type(it)
        name = getattr(layer, "name", None) or f"layer{i}"
        upd = getattr(layer, "updater", None) or getattr(
            conf.global_config, "updater", None)
        slots = _UPDATER_STATE_SLOTS.get(type(upd).__name__, 2) if upd else 2
        reports.append(LayerMemoryReport(
            layer_name=name, layer_type=type(layer).__name__,
            parameter_count=pcount,
            activation_elements_per_example=_nelems(out_t.shape()),
            updater_state_slots=slots))
    return NetworkMemoryReport(reports, model_name or "MultiLayerNetwork")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in flatten_paths(tree).values()
               if isinstance(t, torch.Tensor))


def _shape(it, batch_size: int) -> Tuple[int, ...]:
    return (batch_size,) + tuple(d if d > 0 else 8 for d in it.shape())


def device_memory_analysis(model, batch_size: int = 1,
                           train: bool = False) -> Dict[str, int]:
    """The card's own memory numbers for one forward (or one whole train
    step with the optimizer when ``train``) at ``batch_size`` on zero
    inputs: the resident argument bytes (params, state, the optimizer
    state when training, the batch), the output bytes (the new params of
    a train step), and the caching allocator's peak above what was
    allocated before the call (``temp_size_in_bytes``). ``{}`` on the
    CPU."""
    if model.device.type != "cuda":
        return {}
    if model.params is None:
        model.init()
    conf = model.conf
    graph = not hasattr(conf, "layers")
    in_type = conf.network_input_types[0] if graph else conf.input_type
    x = torch.zeros(_shape(in_type, batch_size), device=model.device)
    if train:
        m = model.clone()
        step = m._build_train_step()
        out_t = (conf.activation_type(conf.network_outputs[0]) if graph
                 else m.layers[-1].output_type(m._input_types[-1]))
        y = torch.zeros(_shape(out_t, batch_size), device=model.device)
        args = m._staged_step_args(x, y, None, None)
        arg_bytes = (_nbytes(m.params) + _nbytes(m.model_state)
                     + _nbytes(m.opt_state) + _nbytes(x) + _nbytes(y))

        def call():
            m.train_state, loss = step(m.train_state, *args, m._generator)
            return m.params
    else:
        fwd = model.build_inference_fn()
        arg_bytes = (_nbytes(model.params) + _nbytes(model.model_state)
                     + _nbytes(x))

        def call():
            return fwd(model.params, model.model_state, x)
    torch.cuda.synchronize(model.device)
    before = torch.cuda.memory_allocated(model.device)
    torch.cuda.reset_peak_memory_stats(model.device)
    out = call()
    torch.cuda.synchronize(model.device)
    peak = torch.cuda.max_memory_allocated(model.device)
    out_bytes = _nbytes(out)
    temp = peak - before
    return {
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(temp),
        "peak_allocated_bytes": int(peak),
        "total_bytes": int(arg_bytes + temp),
    }
