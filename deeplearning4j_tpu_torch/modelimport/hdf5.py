"""HDF5 archive reader (legacy .h5 AND Keras-3 .keras zips).

A copy of the JAX package's ``modelimport/hdf5.py`` (numpy, json, re,
zipfile and h5py only). ``h5py`` is imported when a file is opened, not
with the module, so the importer's conversion (``keras.py``) imports and
runs on a machine without it (the card's has none): there an archive is
any object with this class's ``model_config()``, ``keras_version()``,
``read_attribute_as_json(name)`` and ``layer_weights(name)``. Opening a
file without h5py raises ``RuntimeError``.

Analog of the reference's Hdf5Archive.java (deeplearning4j-modelimport,
which binds libhdf5 via JavaCPP — SURVEY §2.5, §3.5): attribute JSON
reads + dataset traversal over a Keras .h5 file. h5py provides the same
C-library binding surface.

Beyond the reference: the Keras 3 native ``.keras`` format (a zip of
config.json + metadata.json + model.weights.h5) loads through the same
class — the constructor sniffs the zip magic, reads the config from the
zip, and rebuilds legacy-style weight names from the v3 layout
(``layers/<auto_snake_name>/vars/<i>``, sublayer dirs for MHA/RNN
cells), so every existing converter works unchanged on modern files the
reference cannot read at all.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Dict, List, Optional

import numpy as np


def _h5py():
    """The h5py module, imported at first use."""
    try:
        import h5py
    except ImportError:
        raise RuntimeError("h5py is required for Keras import") from None
    return h5py


def _as_str(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    return str(v)


def _snake(name: str) -> str:
    """Keras' to_snake_case (auto layer-path naming in .keras files)."""
    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


# .keras var index → legacy weight name, per layer class (flag-adjusted
# in _v3_var_names). Order == keras layer.weights order.
_V3_VAR_NAMES = {
    "Dense": ["kernel", "bias"],
    "Conv1D": ["kernel", "bias"],
    "Conv2D": ["kernel", "bias"],
    "Convolution2D": ["kernel", "bias"],
    "Conv2DTranspose": ["kernel", "bias"],
    "DepthwiseConv2D": ["depthwise_kernel", "bias"],
    "SeparableConv2D": ["depthwise_kernel", "pointwise_kernel", "bias"],
    "BatchNormalization": ["gamma", "beta", "moving_mean",
                           "moving_variance"],
    "LayerNormalization": ["gamma", "beta"],
    "Embedding": ["embeddings"],
    "PReLU": ["alpha"],
}

_V3_RNN = {"LSTM", "GRU", "SimpleRNN"}

# Layer classes known to carry NO variables: an empty weight dict is
# legitimate for these and only these. Anything else with a config entry
# but no resolvable weights dir is a layout mismatch — importing random
# init weights silently would violate the refuse-loudly policy.
_V3_STATELESS = {
    "InputLayer", "Dropout", "SpatialDropout1D", "SpatialDropout2D",
    "SpatialDropout3D", "GaussianDropout", "GaussianNoise", "AlphaDropout",
    "Flatten", "Reshape", "Permute", "RepeatVector", "Activation",
    "LeakyReLU", "ELU", "ThresholdedReLU", "ReLU", "Softmax", "Lambda",
    "Masking", "Add", "Subtract", "Multiply", "Average", "Maximum",
    "Minimum", "Concatenate", "Dot", "MaxPooling1D", "MaxPooling2D",
    "MaxPooling3D", "AveragePooling1D", "AveragePooling2D",
    "AveragePooling3D", "GlobalMaxPooling1D", "GlobalMaxPooling2D",
    "GlobalMaxPooling3D", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D", "ZeroPadding1D",
    "ZeroPadding2D", "ZeroPadding3D", "Cropping1D", "Cropping2D",
    "Cropping3D", "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "SpaceToDepth", "LRN", "LRN2D", "PoolHelper",
}
_V3_MHA_SUBS = (("query_dense", "query"), ("key_dense", "key"),
                ("value_dense", "value"),
                ("output_dense", "attention_output"))


def _v3_var_names(cls: str, lcfg: dict) -> Optional[List[str]]:
    names = _V3_VAR_NAMES.get(cls)
    if names is None:
        return None
    names = list(names)
    if not lcfg.get("use_bias", True) and "bias" in names:
        names.remove("bias")
    if cls == "BatchNormalization":
        if not lcfg.get("scale", True):
            names.remove("gamma")
        if not lcfg.get("center", True):
            names.remove("beta")
    return names


class Hdf5Archive:
    """Read-only view of a Keras HDF5 file or Keras-3 .keras zip."""

    def __init__(self, path: str):
        h5py = _h5py()
        self._zip_cfg = None
        self._zip_version = None
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic == b"PK\x03\x04":
            with zipfile.ZipFile(path) as z:
                self._zip_cfg = json.loads(z.read("config.json"))
                try:
                    meta = json.loads(z.read("metadata.json"))
                    self._zip_version = int(
                        str(meta.get("keras_version", "3")).split(".")[0])
                except KeyError:
                    self._zip_version = 3
                self._f = h5py.File(io.BytesIO(z.read("model.weights.h5")),
                                    "r")
            self._v3_dirs = self._build_v3_dir_map(self._zip_cfg)
        else:
            self._f = h5py.File(path, "r")

    @staticmethod
    def _build_v3_dir_map(cfg: dict) -> Dict[str, dict]:
        """config layer name → (weights dir name, layer dict). Keras
        writes weight dirs under the AUTO path (snake_case class + per-
        base counter, in config order), not the user-visible name."""
        layers = cfg.get("config", {})
        layers = layers.get("layers", []) if isinstance(layers, dict) \
            else []
        counts: Dict[str, int] = {}
        out: Dict[str, dict] = {}
        for ld in layers:
            base = _snake(ld["class_name"])
            n = counts.get(base, 0)
            counts[base] = n + 1
            dirname = base if n == 0 else f"{base}_{n}"
            name = ld.get("config", {}).get("name", dirname)
            out[name] = {"dir": dirname, "layer": ld}
        return out

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- attributes ------------------------------------------------------
    def read_attribute_as_string(self, name: str, *groups: str) -> str:
        node = self._node(*groups)
        return _as_str(node.attrs[name])

    def read_attribute_as_json(self, name: str, *groups: str):
        return json.loads(self.read_attribute_as_string(name, *groups))

    def has_attribute(self, name: str, *groups: str) -> bool:
        return name in self._node(*groups).attrs

    def read_string_list_attribute(self, name: str, *groups: str
                                   ) -> List[str]:
        return [_as_str(v) for v in self._node(*groups).attrs[name]]

    # ---- datasets --------------------------------------------------------
    def read_data_set(self, name: str, *groups: str) -> np.ndarray:
        return np.asarray(self._node(*groups)[name])

    def get_groups(self, *groups: str) -> List[str]:
        node = self._node(*groups)
        return [k for k in node.keys()
                if isinstance(node[k], _h5py().Group)]

    def get_data_sets(self, *groups: str) -> List[str]:
        node = self._node(*groups)
        return [k for k in node.keys()
                if isinstance(node[k], _h5py().Dataset)]

    def has_group(self, *groups: str) -> bool:
        try:
            self._node(*groups)
            return True
        except KeyError:
            return False

    def _node(self, *groups: str):
        node = self._f
        for g in groups:
            node = node[g]
        return node

    # ---- Keras-specific helpers -----------------------------------------
    def model_config(self) -> dict:
        if self._zip_cfg is not None:
            return self._zip_cfg
        return self.read_attribute_as_json("model_config")

    def keras_version(self) -> int:
        """Major Keras version (1, 2, or 3) from the file."""
        if self._zip_version is not None:
            return self._zip_version
        root = ("model_weights",) if self.has_group("model_weights") else ()
        try:
            v = self.read_attribute_as_string("keras_version", *root)
            return int(v.split(".")[0])
        except KeyError:
            return 1

    # ---- .keras (v3) weight translation ---------------------------------
    def _v3_vars(self, *groups: str) -> List[np.ndarray]:
        if not self.has_group(*groups, "vars"):
            return []
        node = self._node(*groups, "vars")
        return [np.asarray(node[k]) for k in
                sorted(node.keys(), key=lambda s: int(s))]

    @staticmethod
    def _custom_stateless(cls: str, lcfg: dict) -> bool:
        """True when ``cls`` is a user-registered custom layer whose
        converted form carries no params — its weights dir legitimately
        has nothing to load (e.g. a pure-function Lambda-style layer)."""
        from deeplearning4j_tpu_torch.modelimport.layers import (
            _CUSTOM, convert_layer)
        if cls not in _CUSTOM:
            return False
        try:
            conv = convert_layer(cls, lcfg, 3)
        except Exception:
            return False
        return conv.layer is None or not conv.layer.has_params

    def _v3_layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        entry = self._v3_dirs.get(layer_name)
        if entry is None:
            return {}
        cls = entry["layer"]["class_name"]
        lcfg = entry["layer"].get("config", {})
        # 3.x writes "layers/"; some 3.0-era files used
        # "_layer_checkpoint_dependencies/"
        root = ("layers" if self.has_group("layers")
                else "_layer_checkpoint_dependencies")
        if not self.has_group(root, entry["dir"]):
            if cls in _V3_STATELESS or self._custom_stateless(cls, lcfg):
                return {}
            # a weighted layer whose dir can't be found is a layout
            # mismatch (different Keras-3 naming, nested sub-model,
            # shared layer) — importing random init weights silently
            # would be wrong with no error
            raise ValueError(
                f".keras layer {layer_name!r} ({cls}) should carry "
                f"weights but no '{root}/{entry['dir']}' group exists "
                "in model.weights.h5; unsupported .keras layout "
                "(nested sub-model / shared layer / different Keras-3 "
                "naming?)")
        base = (root, entry["dir"])
        out: Dict[str, np.ndarray] = {}

        def put(names, arrs, prefix=""):
            if len(arrs) > len(names):
                # more saved vars than the known layout (LoRA adapters,
                # exotic trackables): importing a truncated subset would
                # be silently WRONG weights — refuse loudly instead
                raise ValueError(
                    f".keras layer {layer_name!r} ({cls}) has "
                    f"{len(arrs)} saved variables but only {len(names)} "
                    f"are understood ({names}); unsupported layer state")
            for n, a in zip(names, arrs):
                # prefixed (multi-sublayer) classes emit ONLY qualified
                # keys: a bare-leaf alias would resolve 'kernel' to the
                # first sublayer's array (MHA query vs key) for any
                # consumer keying by last path component
                out[prefix + n if not prefix else f"{prefix}/{n}"] = a

        if cls == "MultiHeadAttention":
            for sub, alias in _V3_MHA_SUBS:
                put(["kernel", "bias"], self._v3_vars(*base, sub),
                    prefix=alias)
        elif cls in _V3_RNN:
            put(["kernel", "recurrent_kernel", "bias"],
                self._v3_vars(*base, "cell"))
        elif cls == "Bidirectional":
            for sub in ("forward_layer", "backward_layer"):
                put(["kernel", "recurrent_kernel", "bias"],
                    self._v3_vars(*base, sub, "cell"), prefix=sub)
        else:
            arrs = self._v3_vars(*base)
            names = _v3_var_names(cls, lcfg)
            if names is None:
                if len(arrs) == 2 and arrs[1].ndim == 1:
                    names = ["kernel", "bias"]   # generic kernel+bias
                else:
                    names = [f"var_{i}" for i in range(len(arrs))]
            put(names, arrs)
        if not out and cls not in _V3_STATELESS \
                and not self._custom_stateless(cls, lcfg):
            raise ValueError(
                f".keras layer {layer_name!r} ({cls}) should carry "
                "weights but none were found under "
                f"'{root}/{entry['dir']}'; unsupported .keras layout")
        return out

    def layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        """All weights of one layer, keyed by the LAST path component of
        the Keras weight name ('dense_1/kernel:0' → 'kernel')."""
        if self._zip_cfg is not None:
            return self._v3_layer_weights(layer_name)
        root = ("model_weights",) if self.has_group("model_weights") else ()
        groups = root + (layer_name,)
        if not self.has_group(*groups):
            return {}
        out: Dict[str, np.ndarray] = {}
        try:
            names = self.read_string_list_attribute("weight_names", *groups)
        except KeyError:
            names = []
        node = self._node(*groups)
        def add_aliases(path_parts, arr):
            # leaf, parent/leaf, and the full path relative to the layer
            # group: deeper aliases disambiguate sublayer weights that
            # share a leaf name (MHA query/kernel vs key/kernel;
            # Bidirectional forward_lstm/... vs backward_lstm/...)
            out[path_parts[-1]] = arr
            if len(path_parts) >= 2:
                out["/".join(path_parts[-2:])] = arr
            if len(path_parts) > 2:
                out["/".join(path_parts)] = arr
            # Keras-1 names carry the layer as a prefix, not a path
            # ("dense_1_W", "lstm_1_W_i"): alias the bare suffix too
            leaf = path_parts[-1]
            if leaf.startswith(layer_name + "_"):
                out[leaf[len(layer_name) + 1:]] = arr

        if names:
            for wname in names:
                arr = np.asarray(node[wname])
                add_aliases(wname.split(":")[0].split("/"), arr)
        else:
            h5py = _h5py()

            def visit(prefix, n):
                for k in n.keys():
                    item = n[k]
                    if isinstance(item, h5py.Dataset):
                        rel = (prefix + "/" + k.split(":")[0]) \
                            if prefix else k.split(":")[0]
                        add_aliases(rel.split("/"), np.asarray(item))
                    else:
                        visit((prefix + "/" + k) if prefix else k, item)
            visit("", node)
        return out
