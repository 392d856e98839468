"""Megatron-style paired tensor parallelism for layer stacks.

The port of the JAX package's ``parallel/tensor_parallel.py``. The plan's
rules are the JAX package's, and its ``param_shardings`` are written as
the same partition specs (tuples: ``(None, "model")`` is the JAX
package's ``P(None, "model")``, ``()`` is replicated), so a test holds
the two plans side by side:

- consecutive dense layers alternate **column-parallel** (``W`` split by
  columns, bias split) and **row-parallel** (``W`` split by rows, bias
  replicated); between the pair the activation stays split on its last
  dimension, after the row layer one all-reduce restores it;
- ``SelfAttentionLayer`` and ``TransformerEncoderBlock``: ``Wqkv``
  column-parallel over whole heads (its packed columns are head-major),
  ``Wo`` row-parallel, the block's FFN a column/row pair: one all-reduce
  after attention and one after the FFN, per block;
- a hidden-major ``LSTM``: ``Wx``, ``Wh`` and ``b`` split by hidden unit
  (a contiguous slice of the 4H columns is all four gates of a slice of
  units); h is gathered whole each tick;
- an unpaired last output layer goes column-parallel when it divides
  (class-sharded logits), gathered whole before its loss;
- in a ``ComputationGraph``: the blocks, and bottleneck conv chains (the
  opening 1×1 and the 3×3 split by output channel, the 3×3's input
  gathered whole, the closing 1×1 split by input channel with one
  all-reduce, the BatchNorms between them split by channel, their running
  statistics too).

GSPMD places the JAX package's collectives; here the layers issue them
at their split points (``ops/tensor_split.py``), which the models open
for each layer the plan splits (``TPPlan.split_spec``). Where the JAX
plan uses its fallback column rule (a conv's output channels, the gate
columns of a gate-major LSTM), GSPMD gathers as the next layer needs; the
port keeps those layers replicated, and ``TPPlan.fallback`` names them.

``shard_train_state`` gives this rank its slices of the parameters, the
BN state and the updater state (each updater leaf mirrors its parameter's
layout); ``gather_train_state`` puts the whole tree back together on
every rank. ``shard_tree`` and ``gather_tree`` do the same for any tree
with a spec tree beside it: ``shard_tree(params_from_jax(...), specs,
mesh)`` gives each rank its slice of the JAX package's parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Optional

import torch

from deeplearning4j_tpu_torch.ops.tensor_split import SplitSpec
from deeplearning4j_tpu_torch.optimize.updaters import tree_map
from deeplearning4j_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                    Mesh, all_gather,
                                                    copy_to_axis,
                                                    gather_from_axis,
                                                    reduce_from_axis)
from deeplearning4j_tpu_torch.parallel.sharding import infer_param_shardings

# activation-layout states at layer boundaries
_REPL = "replicated"      # features replicated over the model axis
_SHARDED = "sharded"      # last (feature) dim sharded over the model axis


@dataclasses.dataclass
class TPPlan:
    """Param partition specs, per-layer activation layouts and split
    parts."""
    param_shardings: Any                 # tree of spec tuples
    act_kinds: Dict[str, str]            # layer name -> _REPL | _SHARDED
    mesh: Mesh
    model_axis: str = MODEL_AXIS
    data_axis: str = DATA_AXIS
    # per-layer model_state specs (BatchNorm running statistics of a
    # channel-split conv chain); None = all replicated
    state_shardings: Optional[Dict[str, Any]] = None
    # layer name -> the split points its apply runs (ops/tensor_split.py)
    parts: Dict[str, FrozenSet[str]] = dataclasses.field(
        default_factory=dict)
    # layers the JAX plan splits by its fallback column rule and the port
    # keeps replicated
    fallback: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._specs: Dict[str, SplitSpec] = {}

    @property
    def model_parallelism(self) -> int:
        return int(self.mesh.shape.get(self.model_axis, 1))

    def split_spec(self, name: str) -> Optional[SplitSpec]:
        """The split points of layer ``name``'s apply on this rank (None:
        the layer runs whole)."""
        parts = self.parts.get(name)
        if not parts or self.model_parallelism <= 1:
            return None
        if name not in self._specs:
            ax = self.mesh.axis(self.model_axis)
            self._specs[name] = SplitSpec(
                frozenset(parts),
                lambda x: copy_to_axis(x, ax),
                lambda y: reduce_from_axis(y, ax),
                lambda y: gather_from_axis(y, ax, -1))
        return self._specs[name]


def _repl_specs(p):
    return tree_map(lambda _: (), p)


def _attention_specs(p, m, ax):
    """Column(heads)/row pair for SelfAttentionLayer params."""
    if p["Wqkv"].shape[1] % m or p["Wo"].shape[0] % m:
        return _repl_specs(p)
    spec = {"Wqkv": (None, ax), "Wo": (ax, None)}
    if "bqkv" in p:
        spec["bqkv"] = (ax,)
    if "bo" in p:
        spec["bo"] = ()
    return spec


def _transformer_specs(p, m, ax, n_heads):
    """Megatron block: head-parallel attention + column→row FFN."""
    spec = {}
    if n_heads % m == 0:
        spec["attn"] = _attention_specs(p["attn"], m, ax)
    else:
        spec["attn"] = _repl_specs(p["attn"])
    for ln in ("ln1", "ln2"):
        if ln in p:
            spec[ln] = _repl_specs(p[ln])
    if p["W1"].shape[1] % m == 0:
        spec["W1"] = (None, ax)
        spec["W2"] = (ax, None)
        if "b1" in p:
            spec["b1"] = (ax,)
        if "b2" in p:
            spec["b2"] = ()
    else:
        for k in ("W1", "W2", "b1", "b2"):
            if k in p:
                spec[k] = ()
    return spec


def _block_parts(spec) -> FrozenSet[str]:
    parts = set()
    if spec.get("attn", {}).get("Wqkv") not in (None, ()):
        parts |= {"attn:col", "attn:row"}
    if spec.get("W1") not in (None, ()):
        parts |= {"ffn:col", "ffn:row"}
    return frozenset(parts)


def _attn_parts(spec) -> FrozenSet[str]:
    return (frozenset({"attn:col", "attn:row"})
            if spec.get("Wqkv") not in (None, ()) else frozenset())


def _lstm_specs(layer, p, m, ax):
    """Hidden-unit-split LSTM (the opt-in "hidden_major" gate packing)."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    if (type(layer) is not LSTM
            or getattr(layer, "gate_layout", "") != "hidden_major"
            or layer.n_out % m):
        return None
    spec = _repl_specs(p)
    spec["Wx"] = (None, ax)
    spec["Wh"] = (None, ax)
    if "b" in p:
        spec["b"] = (ax,)
    return spec


_LSTM_PARTS = frozenset({"lstm:col", "lstm:gather_out"})


def _fallback(name, p, mesh, ax, fallback):
    """Replicated specs for a layer without a pairing rule; ``fallback``
    names it where the JAX plan's fallback column rule splits it."""
    split = infer_param_shardings(p, mesh, ax, fallback=True)
    if any(spec != () for spec in spec_leaves(split).values()):
        fallback[name] = _REPL
    return _repl_specs(p)


def plan_tp(model, mesh: Mesh, *, model_axis: str = MODEL_AXIS,
            data_axis: str = DATA_AXIS) -> TPPlan:
    """The paired plan for a MultiLayerNetwork (pairing across the layer
    stack) or a ComputationGraph (per-node rules). ``model`` must be
    initialized: the plan reads the parameter shapes (whole ones: plan
    before ``shard_train_state``)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        ActivationLayer, AutoEncoder, DenseLayer, DropoutLayer)

    if not hasattr(model, "layers") or not hasattr(model, "_forward"):
        return _plan_tp_graph(model, mesh, model_axis=model_axis,
                              data_axis=data_axis)
    params = model.params
    layers = list(model.layers)
    m = int(mesh.shape.get(model_axis, 1))
    ax = model_axis
    spec_tree: Dict[str, Any] = {}
    act_kinds: Dict[str, str] = {}
    parts: Dict[str, FrozenSet[str]] = {}
    fallback: Dict[str, str] = {}

    if m <= 1:
        for layer in layers:
            spec_tree[layer.name] = _repl_specs(params.get(layer.name, {}))
            act_kinds[layer.name] = _REPL
        return TPPlan(spec_tree, act_kinds, mesh, model_axis, data_axis)

    def dense_w(layer):
        w = params.get(layer.name, {}).get("W")
        return w if (w is not None and w.dim() == 2) else None

    def pairable_ahead(i, width):
        """Is there a row-parallel partner after layer i (skipping
        shape-preserving no-param layers)?"""
        for j in range(i + 1, len(layers)):
            lj = layers[j]
            if isinstance(lj, (ActivationLayer, DropoutLayer)):
                continue
            if isinstance(lj, (DenseLayer, AutoEncoder)):
                w = dense_w(lj)
                return (w is not None and w.shape[0] == width
                        and w.shape[0] % m == 0)
            return False
        return False

    state = _REPL
    for i, layer in enumerate(layers):
        p = params.get(layer.name, {})
        name = layer.name
        if isinstance(layer, TransformerEncoderBlock):
            spec_tree[name] = _transformer_specs(p, m, ax, layer.n_heads)
            parts[name] = _block_parts(spec_tree[name])
            act_kinds[name] = _REPL
            state = _REPL
        elif isinstance(layer, SelfAttentionLayer):
            spec_tree[name] = (_attention_specs(p, m, ax)
                               if layer.n_heads % m == 0
                               else _repl_specs(p))
            parts[name] = _attn_parts(spec_tree[name])
            act_kinds[name] = _REPL
            state = _REPL
        elif isinstance(layer, (DenseLayer, AutoEncoder)) and \
                dense_w(layer) is not None:
            n_in, n_out = dense_w(layer).shape
            spec = _repl_specs(p)
            if state == _SHARDED and n_in % m == 0:
                # row-parallel partner: closes the pair with one all-reduce
                spec["W"] = (ax, None)
                if "b" in p:
                    spec["b"] = ()
                parts[name] = frozenset({"dense:row"})
                act_kinds[name] = _REPL
                state = _REPL
            elif state == _REPL and n_out % m == 0 and (
                    pairable_ahead(i, n_out) or i == len(layers) - 1):
                # column-parallel: open a pair, or the last layer's
                # class-sharded logits (gathered whole for the loss)
                spec["W"] = (None, ax)
                if "b" in p:
                    spec["b"] = (ax,)
                last = i == len(layers) - 1
                parts[name] = frozenset({"dense:col"} | (
                    {"dense:gather_out"} if last else set()))
                act_kinds[name] = _SHARDED
                state = _SHARDED
            else:
                act_kinds[name] = _REPL
                state = _REPL
            spec_tree[name] = spec
        elif isinstance(layer, (ActivationLayer, DropoutLayer)):
            spec_tree[name] = _repl_specs(p)
            act_kinds[name] = state
        else:
            lstm = _lstm_specs(layer, p, m, ax)
            if lstm is not None:
                spec_tree[name] = lstm
                parts[name] = _LSTM_PARTS
            else:
                spec_tree[name] = _fallback(name, p, mesh, ax, fallback)
            act_kinds[name] = _REPL
            state = _REPL
    return TPPlan(spec_tree, act_kinds, mesh, model_axis, data_axis,
                  parts=parts, fallback=fallback)


def _find_conv_chains(model, m: int):
    """Bottleneck conv chains in a ComputationGraph, by structure: a 1×1
    conv whose single-consumer chain through BatchNorm/Activation reaches
    a 3×3 conv, then another such chain to a closing 1×1 conv. Only
    chains whose widths divide the model axis are returned."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import \
        ConvolutionLayer
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        ActivationLayer
    from deeplearning4j_tpu_torch.nn.layers.normalization import \
        BatchNormalization

    nodes = {n.name: n for n in model.conf.nodes}
    consumers: Dict[str, list] = {}
    for n in model.conf.nodes:
        for src in n.inputs:
            consumers.setdefault(src, []).append(n.name)

    def kernel(layer):
        k = layer.kernel_size
        return (k, k) if isinstance(k, int) else tuple(k)

    def is_conv(name, ksize):
        n = nodes.get(name)
        return (n is not None and type(n.layer) is ConvolutionLayer
                and kernel(n.layer) == ksize)

    def follow_bn_act(name):
        cons = consumers.get(name, [])
        if len(cons) != 1:
            return None
        bn = nodes.get(cons[0])
        if bn is None or not isinstance(bn.layer, BatchNormalization):
            return None
        cons2 = consumers.get(bn.name, [])
        if len(cons2) != 1:
            return None
        nxt = nodes.get(cons2[0])
        if nxt is not None and isinstance(nxt.layer, ActivationLayer):
            cons3 = consumers.get(nxt.name, [])
            if len(cons3) != 1:
                return None
            return bn.name, nxt.name, cons3[0]
        return bn.name, None, cons2[0]

    chains = []
    for n in model.conf.nodes:
        if n.layer is None or not is_conv(n.name, (1, 1)):
            continue
        if n.layer.n_out % m:
            continue
        step_a = follow_bn_act(n.name)
        if step_a is None or not is_conv(step_a[2], (3, 3)):
            continue
        b_name = step_a[2]
        if nodes[b_name].layer.n_out % m:
            continue
        step_b = follow_bn_act(b_name)
        if step_b is None or not is_conv(step_b[2], (1, 1)):
            continue
        chains.append({"a": n.name, "a_bn": step_a[0], "a_act": step_a[1],
                       "b": b_name, "b_bn": step_b[0], "b_act": step_b[1],
                       "c": step_b[2]})
    return chains


def _plan_tp_graph(model, mesh: Mesh, *, model_axis: str = MODEL_AXIS,
                   data_axis: str = DATA_AXIS) -> TPPlan:
    """Per-node plan for a ComputationGraph: the blocks and attention
    layers keep their internal pairing (input and output replicated, so a
    fan-out is safe), bottleneck conv chains split by channel (1
    all-gather + 1 all-reduce a chain forward), everything else whole."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer, TransformerEncoderBlock)

    params = model.params
    m = int(mesh.shape.get(model_axis, 1))
    ax = model_axis
    spec_tree: Dict[str, Any] = {}
    act_kinds: Dict[str, str] = {}
    state_specs: Dict[str, Any] = {}
    parts: Dict[str, FrozenSet[str]] = {}
    fallback: Dict[str, str] = {}

    rules: Dict[str, Any] = {}
    if m > 1:
        for ch in _find_conv_chains(model, m):
            rules[ch["a"]] = ("conv", (None, None, None, ax), _SHARDED,
                              {"conv:col"})
            rules[ch["b"]] = ("conv", (None, None, None, ax), _SHARDED,
                              {"conv:gather_in", "conv:col"})
            rules[ch["c"]] = ("conv", (None, None, ax, None), _REPL,
                              {"conv:row"})
            for bn in (ch["a_bn"], ch["b_bn"]):
                rules[bn] = ("bn", (ax,), _SHARDED, set())
            for act in (ch["a_act"], ch["b_act"]):
                if act is not None:
                    rules[act] = ("pass", None, _SHARDED, set())

    for node in model._layer_nodes:
        name, layer = node.name, node.layer
        p = params.get(name, {})
        rule = rules.get(name)
        if m <= 1:
            spec_tree[name] = _repl_specs(p)
            act_kinds[name] = _REPL
        elif rule is not None:
            kind, spec, act, pts = rule
            if kind == "conv":
                s = _repl_specs(p)
                s["W"] = spec
                if "b" in p:
                    s["b"] = (ax,) if act == _SHARDED else ()
                spec_tree[name] = s
            elif kind == "bn":
                spec_tree[name] = {k: spec for k in p}
                state_specs[name] = {"mean": spec, "var": spec}
            else:
                spec_tree[name] = _repl_specs(p)
            if pts:
                parts[name] = frozenset(pts)
            act_kinds[name] = act
        elif isinstance(layer, TransformerEncoderBlock):
            spec_tree[name] = _transformer_specs(p, m, ax, layer.n_heads)
            parts[name] = _block_parts(spec_tree[name])
            act_kinds[name] = _REPL
        elif isinstance(layer, SelfAttentionLayer) and "Wqkv" in p \
                and layer.n_heads % m == 0:
            spec_tree[name] = _attention_specs(p, m, ax)
            parts[name] = _attn_parts(spec_tree[name])
            act_kinds[name] = _REPL
        else:
            lstm = _lstm_specs(layer, p, m, ax)
            if lstm is not None:
                spec_tree[name] = lstm
                parts[name] = _LSTM_PARTS
            else:
                spec_tree[name] = _fallback(name, p, mesh, ax, fallback)
            act_kinds[name] = _REPL
    state_sh = None
    if state_specs:
        mstate = model.model_state
        state_sh = {lname: {k: s for k, s in specs.items()
                            if k in mstate.get(lname, {})}
                    for lname, specs in state_specs.items()}
    return TPPlan(spec_tree, act_kinds, mesh, model_axis, data_axis,
                  state_shardings=state_sh, parts=parts, fallback=fallback)


# ---- slices of trees -------------------------------------------------------


def _local(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf under ``spec``."""
    if not isinstance(t, torch.Tensor):
        return t
    for dim, name in enumerate(spec or ()):
        if name is None:
            continue
        a = mesh.axis(name)
        if a.size == 1:
            continue
        w = t.shape[dim]
        if w % a.size:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"split over the {name!r} axis ({a.size})")
        t = t.narrow(dim, a.index * (w // a.size), w // a.size)
    return t.contiguous()


def _whole(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole leaf of this rank's slice under ``spec`` (every rank of
    each split axis calls it)."""
    if not isinstance(t, torch.Tensor):
        return t
    for dim, name in reversed(list(enumerate(spec or ()))):
        if name is not None and mesh.axis(name).size > 1:
            t = all_gather(t.detach(), dim, mesh.axis(name).group)
    return t


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and not hasattr(s, "_fields") and all(
        e is None or isinstance(e, str) for e in s)


def _paths(tree, is_leaf, prefix=()) -> Dict[tuple, Any]:
    """{path: leaf} of a tree of dicts, lists and tuples, each path a
    tuple of checkpoint keys (a dict key, a named tuple's field, an
    index)."""
    if is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        kids = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        kids = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        kids = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[tuple, Any] = {}
    for k, v in kids:
        out.update(_paths(v, is_leaf, prefix + (k,)))
    return out


def spec_leaves(specs) -> Dict[str, tuple]:
    """{checkpoint key ("layer/W"): spec} of a spec tree (spec tuples are
    leaves; any other leaf is replicated)."""
    return {"/".join(p): tuple(s) if _is_spec(s) else ()
            for p, s in _paths(specs, _is_spec).items()}


def _spec_map(fn, tree, specs, mesh):
    """``fn(leaf, spec, mesh)`` over ``tree``; ``specs`` mirrors it down
    to spec tuples (one spec may stand for a whole subtree)."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v, specs.get(k, ()) if isinstance(
            specs, dict) else specs, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        sub = (specs if _is_spec(specs) or not isinstance(
            specs, (tuple, list)) else None)
        kids = [_spec_map(fn, v, sub if sub is not None else specs[i],
                          mesh) for i, v in enumerate(tree)]
        return type(tree)(*kids) if hasattr(tree, "_fields") \
            else type(tree)(kids)
    return fn(tree, specs if _is_spec(specs) else (), mesh)


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's slices of a whole tree (``specs`` beside it: a spec
    tuple per leaf, or one for a whole subtree)."""
    return _spec_map(_local, tree, specs, mesh)


def gather_tree(tree, specs, mesh: Mesh):
    """The whole tree from every rank's slices (a collective)."""
    return _spec_map(_whole, tree, specs, mesh)


def _spec_at(specs, path: str):
    for part in path.split("/"):
        if not isinstance(specs, dict):
            break
        specs = specs.get(part, ())
    return specs if _is_spec(specs) else ()


def mirror_specs(opt_state, params, specs):
    """The spec tree of an updater state: a leaf whose path ends with a
    parameter's path, at that parameter's shape, takes its spec; every
    other leaf (step counts, scalars) is replicated."""
    by_path = {path: (tuple(getattr(leaf, "shape", ())),
                      _spec_at(specs, "/".join(path)))
               for path, leaf in _paths(params, lambda _: False).items()}

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            if hasattr(node, "_fields"):
                return type(node)(*(walk(getattr(node, f), prefix + (f,))
                                    for f in node._fields))
            return type(node)(walk(v, prefix + (str(i),))
                              for i, v in enumerate(node))
        shape = tuple(getattr(node, "shape", ()))
        if shape:
            for pkey, (pshape, spec) in by_path.items():
                if (pshape == shape and len(prefix) >= len(pkey)
                        and prefix[-len(pkey):] == pkey):
                    return spec
        return ()
    return walk(opt_state, ())


def _opt_specs(plan: TPPlan, model):
    return mirror_specs(model.opt_state, model.params,
                        plan.param_shardings)


def _state_specs(plan: TPPlan, model):
    planned = plan.state_shardings or {}
    return {k: planned.get(k, ()) for k in model.model_state}


# gradient normalizations that take the L2 norm of a leaf or of all
# leaves: on its slices a rank would scale split leaves apart from the
# whole model (GSPMD takes the norm over the whole leaves), and scale the
# replicated copies apart from each other
_NORM_KINDS = ("renormalize_l2", "clip_l2_per_layer", "clip_l2_global")


def shard_train_state(model, plan: TPPlan):
    """This rank's slices of the model's parameters, BN state and updater
    state under the plan (updater leaves that mirror a parameter take its
    layout); installs them and the plan on the model and returns the
    train state. A norm-based gradient normalization with split leaves
    raises ``ValueError``."""
    kind = model.conf.global_config.gradient_normalization.kind
    if kind in _NORM_KINDS and plan.model_parallelism > 1 and any(
            spec != () for spec in spec_leaves(
                plan.param_shardings).values()):
        raise ValueError(
            f"gradient normalization {kind!r} takes L2 norms over whole "
            "leaves, which a tensor-parallel rank holds only slices of; "
            "use 'none' or 'clip_value' with a split plan")
    opt_specs = _opt_specs(plan, model)
    state_specs = _state_specs(plan, model)
    ts = model.train_state
    model.train_state = ts._replace(
        params=shard_tree(ts.params, plan.param_shardings, plan.mesh),
        model_state=shard_tree(ts.model_state, state_specs, plan.mesh),
        opt_state=shard_tree(ts.opt_state, opt_specs, plan.mesh))
    model._tp_plan = plan
    model._tp_specs = (opt_specs, state_specs)
    model._train_step = None
    return model.train_state


def gather_train_state(model, plan: Optional[TPPlan] = None):
    """The whole train state of a model ``shard_train_state`` split (a
    collective over the model axis: every rank calls it)."""
    plan = plan or model._tp_plan
    opt_specs, state_specs = model._tp_specs
    ts = model.train_state
    return ts._replace(
        params=gather_tree(ts.params, plan.param_shardings, plan.mesh),
        model_state=gather_tree(ts.model_state, state_specs, plan.mesh),
        opt_state=gather_tree(ts.opt_state, opt_specs, plan.mesh))
