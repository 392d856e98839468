#!/usr/bin/env python3
"""Write the committed Keras resources that chip_smoke.py's keras_import
phase reads on a machine without h5py and keras.

Run from the repository root on a CPU machine that has keras and h5py:

    python3 tools/keras_card_resources.py            # everything
    python3 tools/keras_card_resources.py fixtures   # the 14 fixtures only
    python3 tools/keras_card_resources.py models     # the Keras-built ones

Writes under ``deeplearning4j_tpu_torch/modelimport/resources/``:

- for each committed fixture of ``tests/resources/keras`` (``k1_*``,
  ``k2_*`` .h5 and ``k3_*`` .keras): ``<name>.json`` (its model_config,
  Keras major version and training_config, as ``Hdf5Archive`` reads them)
  and ``<name>.npz`` (every layer's weight dict as
  ``Hdf5Archive.layer_weights`` returns it, under ``"layer::key"``);
- ``bert_small.json``, ``.npz`` and ``_golden.npz``: the small BERT
  geometry of tests/test_keras_import.py with seeded weights, as a fixture
  (for tests/test_torch_cuda.py), and Keras's hidden states on 2 id rows;
- for BERT-base (``modelimport/bert.py`` ``BERT_BASE``, seq 128) and
  InceptionV3 (``keras.applications.InceptionV3(weights=None)``, 299×299×3,
  1000 classes): ``<name>.json`` (the model_config and a manifest: each
  layer's weights in Keras order, as their legacy keys and shape) and
  ``<name>_golden.npz``: Keras's own outputs with every weight set by
  ``chip_smoke.seeded_keras_arrays`` — BERT's final hidden states at the
  first and last 16 of 128 positions of 2 seeded id rows, InceptionV3's
  1000-way output and 2048-wide ``avg_pool`` features on 2 seeded images.

The card regenerates the weights from the manifest by the same rule and
imports the configuration through ``modelimport.keras._import_archive``.
``tests/test_torch_keras_fixtures.py`` holds the committed files to what
this script writes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the weight rule and the resource reader)

FIXTURE_DIR = os.path.join(REPO, "tests", "resources", "keras")
OUT = os.path.join(REPO, chip_smoke.KERAS_RES)
GOLDEN_SEED = 3
# the small BERT geometry of tests/test_keras_import.py:254-266, committed
# whole (configuration, seeded weights, Keras's output) for the on-card
# tests of tests/test_torch_cuda.py
SMALL_BERT = dict(vocab=50, width=32, n_layers=2, n_heads=4, ffn=64,
                  max_len=16)
SMALL_SEQ = 12
BERT_SEQ, BERT_ROWS, BERT_EDGE = 128, 2, 16
IV3_SHAPE, IV3_CLASSES, IV3_ROWS = (299, 299, 3), 1000, 2


def fixture_path(name: str) -> str:
    ext = ".keras" if name.startswith("k3_") else ".h5"
    return os.path.join(FIXTURE_DIR, name + ext)


def _layer_names(model_config: dict):
    cfg = model_config["config"]
    layers = cfg if isinstance(cfg, list) else cfg["layers"]
    return [ld["config"].get("name", ld.get("name", ld["class_name"]))
            for ld in layers]


def _training_config(archive):
    try:
        return archive.read_attribute_as_json("training_config")
    except KeyError:
        return None


def fixture_resource(name: str):
    """(meta, weights) of one fixture: the json's content and the npz's
    ``"layer::key"`` arrays."""
    return archive_resource(fixture_path(name))


def archive_resource(path: str):
    """(meta, weights) of the Keras file at ``path``."""
    from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
    with Hdf5Archive(path) as a:
        meta = {"model_config": a.model_config(),
                "keras_version": a.keras_version(),
                "training_config": _training_config(a)}
        weights = {f"{layer}::{key}": np.asarray(arr)
                   for layer in _layer_names(meta["model_config"])
                   for key, arr in a.layer_weights(layer).items()}
    return meta, weights


def keras_model(name: str):
    """The Keras model behind a full-width resource (Keras's own random
    init; ``set_seeded`` replaces it), built in a fresh Keras session so
    that its automatic layer names do not depend on what the process
    built before."""
    import keras
    keras.backend.clear_session()
    if name == "bert_base":
        from deeplearning4j_tpu_torch.modelimport.bert import (
            BERT_BASE, build_keras_bert)
        return build_keras_bert(seq_len=BERT_SEQ, **BERT_BASE)
    if name == "inception_v3":
        return keras.applications.InceptionV3(
            weights=None, input_shape=IV3_SHAPE, classes=IV3_CLASSES)
    raise ValueError(name)


def set_seeded(km) -> None:
    """Every weight of ``km`` from ``chip_smoke.seeded_keras_arrays``."""
    for layer in km.layers:
        if layer.weights:
            groups = [([w.path], tuple(w.shape)) for w in layer.weights]
            layer.set_weights(chip_smoke.seeded_keras_arrays(layer.name,
                                                             groups))


def legacy_model_config(km) -> dict:
    """The model_config Keras writes into a legacy .h5 for ``km`` (its
    legacy-config scope, json round trip), without saving the weights."""
    from keras.src.legacy.saving import json_utils, saving_utils
    from keras.src.legacy.saving.legacy_h5_format import saving_options
    with saving_options.keras_option_scope(use_legacy_config=True):
        md = saving_utils.model_metadata(km, include_optimizer=False)
    return json.loads(json.dumps(md["model_config"],
                                 default=json_utils.get_json_type))


def model_resource(km):
    """The json content of a full-width model: the model_config, version
    and training_config that Hdf5Archive reads from ``km`` saved as .h5,
    and the manifest (every key of each layer's weight dict, grouped by
    the Keras weight it aliases, in Keras's weight order)."""
    from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
    fd, path = tempfile.mkstemp(suffix=".h5")
    os.close(fd)
    try:
        km.save(path)
        with Hdf5Archive(path) as a:
            meta = {"model_config": a.model_config(),
                    "keras_version": a.keras_version(),
                    "training_config": _training_config(a), "manifest": {}}
            for layer in km.layers:
                d = a.layer_weights(layer.name)
                groups = []
                for w in layer.weights:
                    arr = d[w.path]
                    keys = [k for k, v in d.items() if v is arr]
                    groups.append([keys, list(arr.shape)])
                if sum(len(k) for k, _ in groups) != len(d):
                    raise AssertionError(f"{layer.name}: weight keys not "
                                         "covered by Keras's weights")
                if groups:
                    meta["manifest"][layer.name] = groups
    finally:
        os.unlink(path)
    return meta


def check_seeded(km, meta) -> None:
    """The weights in ``km`` equal, bitwise, what the manifest
    regenerates."""
    for layer in km.layers:
        groups = meta["manifest"].get(layer.name, [])
        for got, want in zip(layer.get_weights(),
                             chip_smoke.seeded_keras_arrays(layer.name,
                                                            groups)):
            if not np.array_equal(got, want):
                raise AssertionError(f"{layer.name}: Keras holds other "
                                     "weights than the manifest gives")


def golden(name: str, km):
    """Keras's outputs on the seeded inputs."""
    import keras
    rng = np.random.default_rng(GOLDEN_SEED)
    if name == "bert_base":
        vocab = km.get_layer("tok_embed").input_dim
        ids = rng.integers(0, vocab, (BERT_ROWS, BERT_SEQ)).astype(np.int32)
        pos = np.broadcast_to(np.arange(BERT_SEQ, dtype=np.float32),
                              ids.shape).copy()
        hidden = np.asarray(km.predict([ids.astype(np.float32), pos],
                                       verbose=0))
        return {"ids": ids, "hidden_head": hidden[:, :BERT_EDGE],
                "hidden_tail": hidden[:, -BERT_EDGE:]}
    images = rng.integers(0, 256, (IV3_ROWS,) + IV3_SHAPE, dtype=np.uint8)
    both = keras.Model(km.inputs, [km.output,
                                   km.get_layer("avg_pool").output])
    preds, feats = both.predict(chip_smoke.inception_input(images),
                                verbose=0)
    return {"images_u8": images, "predictions": np.asarray(preds),
            "avg_pool": np.asarray(feats)}


def small_bert_resource():
    """(meta, weights, golden) of the small BERT with seeded weights: the
    fixture-style json and npz, and Keras's hidden states on 2 seeded id
    rows."""
    import keras

    from deeplearning4j_tpu_torch.modelimport.bert import build_keras_bert
    keras.backend.clear_session()
    km = build_keras_bert(seq_len=SMALL_SEQ, **SMALL_BERT)
    set_seeded(km)
    fd, path = tempfile.mkstemp(suffix=".h5")
    os.close(fd)
    try:
        km.save(path)
        meta, weights = archive_resource(path)
    finally:
        os.unlink(path)
    rng = np.random.default_rng(GOLDEN_SEED)
    ids = rng.integers(0, SMALL_BERT["vocab"], (2, SMALL_SEQ)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(SMALL_SEQ, dtype=np.float32),
                          ids.shape).copy()
    hidden = np.asarray(km.predict([ids.astype(np.float32), pos],
                                   verbose=0))
    return meta, weights, {"ids": ids, "hidden": hidden}


def dump_json(meta, path: str) -> None:
    with open(path, "w") as f:
        json.dump(meta, f, separators=(",", ":"))
        f.write("\n")


def write_fixtures() -> None:
    for name in chip_smoke.KERAS_FIXTURES:
        meta, weights = fixture_resource(name)
        dump_json(meta, os.path.join(OUT, name + ".json"))
        np.savez_compressed(os.path.join(OUT, name + ".npz"), **weights)
        print(f"{name}: {len(weights)} weight entries")


def write_small() -> None:
    meta, weights, gold = small_bert_resource()
    dump_json(meta, os.path.join(OUT, "bert_small.json"))
    np.savez_compressed(os.path.join(OUT, "bert_small.npz"), **weights)
    np.savez_compressed(os.path.join(OUT, "bert_small_golden.npz"), **gold)
    print(f"bert_small: {len(weights)} weight entries")


def write_models() -> None:
    for name in ("bert_base", "inception_v3"):
        km = keras_model(name)
        set_seeded(km)
        meta = model_resource(km)
        check_seeded(km, meta)
        dump_json(meta, os.path.join(OUT, name + ".json"))
        np.savez_compressed(os.path.join(OUT, name + "_golden.npz"),
                            **golden(name, km))
        print(f"{name}: {km.count_params()} params, "
              f"{len(meta['manifest'])} layers with weights")


def main(argv=None) -> int:
    what = (argv if argv is not None else sys.argv[1:]) or ["all"]
    os.makedirs(OUT, exist_ok=True)
    if what[0] in ("all", "fixtures"):
        write_fixtures()
    if what[0] in ("all", "models"):
        write_small()
        write_models()
    return 0


if __name__ == "__main__":
    sys.exit(main())
