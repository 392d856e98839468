"""Model serialization — the JAX package's zip checkpoint format.

Analog of the reference's ``ModelSerializer`` (util/ModelSerializer.java
— writeModel:109), in the layout the JAX package writes and reads:

    configuration.json    — MultiLayerConfiguration or
                            ComputationGraphConfiguration JSON (serde)
    params/<layer>/<key>.npy
    state/<layer>/<key>.npy  — non-trainable state (BN running stats)
    updater/<path>.npy    — optimizer state leaves (optional, exact resume)
    meta.json             — model class, iteration/epoch counters

so a checkpoint written by either package loads in the other. Arrays are
stored as float32 (the master dtype both packages keep). An updater path
is the JAX package's pytree path of the leaf (``#0/.trace/<layer>/<key>``
for the global Nesterovs trace); the port's optimizer state nests dicts
under the same path parts (optimize/updaters.py).
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.utils.device import DeviceLike

FRAMEWORK_VERSION = "0.2.0"


def _ensure_registry():
    """Import every module that registers a serializable config type, so
    a checkpoint loads in a fresh interpreter."""
    import deeplearning4j_tpu_torch.nn.layers.attention  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.convolution  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.feedforward  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.fused  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.misc  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.normalization  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.objdetect  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.output  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.recurrent  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.variational  # noqa: F401
    import deeplearning4j_tpu_torch.nn.graph.vertices  # noqa: F401
    import deeplearning4j_tpu_torch.nn.preprocessors  # noqa: F401
    import deeplearning4j_tpu_torch.nn.config  # noqa: F401
    import deeplearning4j_tpu_torch.nn.constraints  # noqa: F401
    import deeplearning4j_tpu_torch.nn.distributions  # noqa: F401
    import deeplearning4j_tpu_torch.nn.weightnoise  # noqa: F401


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _from_numpy(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes arrays from JAX
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _write_tree(zf: zipfile.ZipFile, prefix: str, tree):
    for key, t in flatten_paths(tree).items():
        buf = io.BytesIO()
        np.save(buf, _to_numpy(t))
        zf.writestr(f"{prefix}/{key}.npy", buf.getvalue())


def _read_flat(zf: zipfile.ZipFile, prefix: str) -> Dict[str, np.ndarray]:
    """{path: array} of the ``prefix/<path>.npy`` entries."""
    out = {}
    for name in zf.namelist():
        if name.startswith(prefix + "/") and name.endswith(".npy"):
            with zf.open(name) as f:
                out[name[len(prefix) + 1:-4]] = np.load(io.BytesIO(f.read()))
    return out


def flatten_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a nested structure, with the JAX package's path
    encoding: a dict key as itself, a NamedTuple field as ``.name``, a
    tuple or list index as ``#i``, joined with '/'. Empty containers
    (optax's EmptyState, MaskedNode) have no leaves."""
    if isinstance(tree, Mapping):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, v in items:
        out.update(flatten_paths(v, f"{prefix}/{key}" if prefix else key))
    return out


def _unflatten_like(template, flat: Mapping[str, Any], device,
                    what: str):
    """``flat`` {path: array} rebuilt into ``template``'s nested dicts,
    each leaf as a tensor of the template leaf's dtype and shape on
    ``device``; a missing or extra path raises."""
    want = flatten_paths(template)
    if set(flat) != set(want):
        raise KeyError(f"{what}: paths differ: missing "
                       f"{sorted(set(want) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(want))}")

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in node.items()}
        t = _from_numpy(flat[prefix], device, node.dtype)
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{what}[{prefix!r}]: shape {tuple(t.shape)} "
                             f"!= {tuple(node.shape)}")
        return t
    return build(template, "")


def opt_state_from_jax(opt_state_np, model):
    """The JAX model's optimizer state (numpy leaves, as
    ``jax.device_get(model.train_state.opt_state)`` gives it) as the
    port model's ``opt_state``, name for name; a path or shape mismatch
    raises. Sets and returns ``model.opt_state``."""
    flat = {k: np.asarray(v) for k, v in flatten_paths(opt_state_np).items()}
    model.opt_state = _unflatten_like(model.opt_state, flat, model.device,
                                      "opt_state")
    return model.opt_state


def params_from_jax(params_np: Mapping[str, Mapping[str, Any]],
                    state_np: Mapping[str, Mapping[str, Any]],
                    device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None,
                    model=None) -> Tuple[dict, dict]:
    """The JAX package's ``train_state.params`` / ``model_state`` (nested
    dicts of numpy arrays, at any depth: a transformer block's params
    nest) as the port's dicts of tensors: a name-for-name,
    layout-preserving copy. ``dtype`` casts the floating params
    (the BN running state stays float32, as in the JAX package). With
    ``model``, every name and shape is checked against it and a mismatch
    raises."""
    def conv(tree, dt, depth=0):
        out = {}
        for k, v in tree.items():
            if isinstance(v, Mapping):
                out[str(k)] = conv(v, dt, depth + 1)
            elif depth == 0:
                raise TypeError(f"layer {k!r}: expected a dict of arrays "
                                "(params[layer][key])")
            else:
                out[str(k)] = _from_numpy(v, device, dt)
        return out
    params = conv(params_np, dtype)
    state = conv(state_np, None)
    if model is not None:
        model.set_params(params, state)
        return model.params, model.model_state
    return params, state


def _model_classes():
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    return {"ComputationGraph": (ComputationGraph,
                                 ComputationGraphConfiguration),
            "MultiLayerNetwork": (MultiLayerNetwork,
                                  MultiLayerConfiguration)}


def save_model(model, path: str, save_updater: bool = False):
    """reference: ModelSerializer.writeModel:109; ``save_updater`` writes
    the optimizer state too (for an exact resume)."""
    kind = next((name for name, (cls, _) in _model_classes().items()
                 if isinstance(model, cls)), None)
    if kind is None:
        raise TypeError(f"save_model: {type(model).__name__} is not a "
                        "ComputationGraph or MultiLayerNetwork")
    if model.params is None:
        model.init()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", model.conf.to_json())
        _write_tree(zf, "params", model.params)
        _write_tree(zf, "state", model.model_state)
        if save_updater:
            _write_tree(zf, "updater", model.opt_state)
        meta = {
            "model_class": kind,
            "iteration": int(model.iteration),
            "epoch": int(model.epoch_count),
            "has_updater": bool(save_updater),
            "framework_version": FRAMEWORK_VERSION,
            "qkv_layout": "head_major",
        }
        zf.writestr("meta.json", json.dumps(meta))


def _attention_heads(model) -> Dict[str, Tuple[int, int]]:
    """{layer name: (n_heads, n_out)} of the model's attention layers."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        SelfAttentionLayer, TransformerEncoderBlock)
    layers = (model.layers if hasattr(model, "layers")
              else [n.layer for n in model.conf.nodes
                    if getattr(n, "layer", None) is not None])
    return {l.name: (l.n_heads, l.n_out) for l in layers
            if isinstance(l, (SelfAttentionLayer, TransformerEncoderBlock))}


def _repack_qkv(path: str, leaf: np.ndarray, heads) -> np.ndarray:
    """``leaf`` re-packed from which-major ([q|k|v] column blocks) to
    head-major ((head, which, dh)) columns when its path names an
    attention layer and ends in Wqkv or bqkv; else as it was."""
    parts = path.split("/")
    layer = next((p for p in parts if p in heads), None)
    if layer is None or parts[-1] not in ("Wqkv", "bqkv"):
        return leaf
    n_heads, n_out = heads[layer]
    dh = n_out // n_heads
    if parts[-1] == "Wqkv" and leaf.ndim == 2 and leaf.shape[1] == 3 * n_out:
        f = leaf.shape[0]
        return (leaf.reshape(f, 3, n_heads, dh).transpose(0, 2, 1, 3)
                .reshape(f, 3 * n_out))
    if parts[-1] == "bqkv" and leaf.ndim == 1 and leaf.shape[0] == 3 * n_out:
        return leaf.reshape(3, n_heads, dh).transpose(1, 0, 2).reshape(-1)
    return leaf


def _migrate_qkv(model, flat: Dict[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
    """Upgrade a pre-0.2.0 checkpoint's {path: array}: every leaf whose
    path names an attention layer and ends in Wqkv/bqkv (a layer's own,
    a block's under ``attn``, and the Adam moments that mirror them)
    re-packed from which-major to head-major columns; other leaves as
    they were. The JAX package's ``_migrate_qkv_layout`` (params) and
    ``_migrate_qkv_opt_state`` (optimizer state) in one, since the port
    migrates both as flat paths."""
    heads = _attention_heads(model)
    return {k: _repack_qkv(k, a, heads) for k, a in flat.items()}


def _restore(path: str, expected: Optional[str], device: DeviceLike,
             load_updater: bool):
    """Restore a zip written by either package onto ``device`` (``cuda``
    unless ``"cpu"`` is asked for). Every stored parameter must match the
    configuration's name for name. State is read for the names the
    model's ``init`` makes, as the JAX package reads it: an LSTM's last
    carry, which a fit leaves in the state, is not restored. With
    ``load_updater`` and a checkpoint that has one, the optimizer state is
    restored too, path for path. A checkpoint without the
    ``qkv_layout: head_major`` tag (framework 0.1.0) has its attention
    layers' packed QKV columns, and their Adam moments, migrated."""
    _ensure_registry()
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        kind = meta["model_class"]
        if kind not in _model_classes() or (expected is not None
                                            and kind != expected):
            raise TypeError(f"checkpoint holds a {kind}, not a "
                            f"{expected or 'ported model class'}")
        cls, conf_cls = _model_classes()[kind]
        conf = conf_cls.from_json(zf.read("configuration.json").decode())
        model = cls(conf, device=device)
        model.init()
        params = _read_flat(zf, "params")
        state = _read_flat(zf, "state")
        updater = (_read_flat(zf, "updater")
                   if load_updater and meta.get("has_updater") else None)
    missing = sorted(set(flatten_paths(model.model_state)) - set(state))
    if missing:
        raise KeyError(f"checkpoint missing state arrays: {missing}")
    state = {k: state[k] for k in flatten_paths(model.model_state)}
    if meta.get("qkv_layout") != "head_major":
        # a pre-0.2.0 checkpoint: which-major packed QKV columns
        params = _migrate_qkv(model, params)
        if updater is not None:
            updater = _migrate_qkv(model, updater)
    model.params = _unflatten_like(model.params, params, model.device,
                                   "params")
    model.model_state = _unflatten_like(model.model_state, state,
                                        model.device, "state")
    if updater is not None:
        model.opt_state = _unflatten_like(model.opt_state, updater,
                                          model.device, "updater")
    model.iteration = int(meta.get("iteration", 0))
    model.epoch_count = int(meta.get("epoch", 0))
    return model


def restore_model(path: str, device: DeviceLike = None,
                  load_updater: bool = False):
    """Restore a ComputationGraph or MultiLayerNetwork zip, by the class
    its ``meta.json`` names (reference: ModelGuesser)."""
    return _restore(path, None, device, load_updater)


def restore_multi_layer_network(path: str, device: DeviceLike = None,
                                load_updater: bool = False):
    """reference: ModelSerializer.restoreMultiLayerNetwork."""
    return _restore(path, "MultiLayerNetwork", device, load_updater)
