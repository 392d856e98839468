"""Model serialization — the JAX package's zip checkpoint format.

Analog of the reference's ``ModelSerializer`` (util/ModelSerializer.java
— writeModel:109), in the layout the JAX package writes and reads:

    configuration.json    — ComputationGraphConfiguration JSON (serde)
    params/<layer>/<key>.npy
    state/<layer>/<key>.npy  — non-trainable state (BN running stats)
    meta.json             — model class, iteration/epoch counters

so a checkpoint written by either package loads in the other. Arrays are
stored as float32 (the master dtype both packages keep). Updater state
is not written or read yet: it comes with the training slice.
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
    import deeplearning4j_tpu_torch.nn.layers.convolution  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.feedforward  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.fused  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.normalization  # noqa: F401
    import deeplearning4j_tpu_torch.nn.layers.output  # noqa: F401
    import deeplearning4j_tpu_torch.nn.graph.vertices  # noqa: F401
    import deeplearning4j_tpu_torch.nn.preprocessors  # noqa: F401


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
    for layer, leaves in tree.items():
        for key, t in leaves.items():
            buf = io.BytesIO()
            np.save(buf, _to_numpy(t))
            zf.writestr(f"{prefix}/{layer}/{key}.npy", buf.getvalue())


def _read_tree(zf: zipfile.ZipFile, prefix: str
               ) -> Dict[str, Dict[str, np.ndarray]]:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name in zf.namelist():
        if name.startswith(prefix + "/") and name.endswith(".npy"):
            parts = name[len(prefix) + 1:-4].split("/")
            if len(parts) != 2:
                raise ValueError(f"checkpoint entry {name!r} is not "
                                 f"{prefix}/<layer>/<key>.npy")
            with zf.open(name) as f:
                out.setdefault(parts[0], {})[parts[1]] = \
                    np.load(io.BytesIO(f.read()))
    return out


def params_from_jax(params_np: Mapping[str, Mapping[str, Any]],
                    state_np: Mapping[str, Mapping[str, Any]],
                    device: DeviceLike = "cpu",
                    dtype: Optional[torch.dtype] = None,
                    model=None) -> Tuple[dict, dict]:
    """The JAX package's ``train_state.params`` / ``model_state`` (nested
    dicts of numpy arrays) as the port's dicts of tensors: a name-for-
    name, layout-preserving copy. ``dtype`` casts the floating params
    (the BN running state stays float32, as in the JAX package). With
    ``model``, every name and shape is checked against it and a mismatch
    raises."""
    def conv(tree, dt):
        out = {}
        for layer, leaves in tree.items():
            if not isinstance(leaves, Mapping):
                raise TypeError(f"layer {layer!r}: expected a dict of "
                                "arrays (params[layer][key])")
            out[str(layer)] = {str(k): _from_numpy(v, device, dt)
                               for k, v in leaves.items()}
        return out
    params = conv(params_np, dtype)
    state = conv(state_np, None)
    if model is not None:
        model.set_params(params, state)
        return model.params, model.model_state
    return params, state


def save_model(model, path: str):
    """reference: ModelSerializer.writeModel:109 (without updater)."""
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    if not isinstance(model, ComputationGraph):
        raise TypeError("save_model: only ComputationGraph is ported")
    if model.params is None:
        model.init()
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", model.conf.to_json())
        _write_tree(zf, "params", model.params)
        _write_tree(zf, "state", model.model_state)
        meta = {
            "model_class": "ComputationGraph",
            "iteration": int(model.iteration),
            "epoch": int(model.epoch_count),
            "has_updater": False,
            "framework_version": FRAMEWORK_VERSION,
            "qkv_layout": "head_major",
        }
        zf.writestr("meta.json", json.dumps(meta))


def restore_model(path: str, device: DeviceLike = None):
    """Restore a ComputationGraph zip (written by either package) onto
    ``device`` (``cuda`` unless ``"cpu"`` is asked for). Every stored
    array must match the configuration's parameters name for name."""
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph.config import \
        ComputationGraphConfiguration
    _ensure_registry()
    with zipfile.ZipFile(path, "r") as zf:
        meta = json.loads(zf.read("meta.json"))
        if meta["model_class"] != "ComputationGraph":
            raise TypeError(f"checkpoint holds a {meta['model_class']}; "
                            "only ComputationGraph is ported")
        conf = ComputationGraphConfiguration.from_json(
            zf.read("configuration.json").decode())
        model = ComputationGraph(conf, device=device)
        model.init()
        params = _read_tree(zf, "params")
        state = _read_tree(zf, "state")
    # layers without params/state have no entries in the zip
    for tree, template in ((params, model.params),
                           (state, model.model_state)):
        for layer, leaves in template.items():
            if not leaves:
                tree.setdefault(layer, {})
    model.set_params(
        {k: {kk: _from_numpy(a, "cpu", None) for kk, a in v.items()}
         for k, v in params.items()},
        {k: {kk: _from_numpy(a, "cpu", None) for kk, a in v.items()}
         for k, v in state.items()})
    model.iteration = int(meta.get("iteration", 0))
    model.epoch_count = int(meta.get("epoch", 0))
    return model
