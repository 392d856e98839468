"""BERT-base Keras construction + whole-graph import (BASELINE config 3).

The reference's headline Keras-import claim is importing real-world
transformer encoders through KerasModelImport
(deeplearning4j-modelimport/.../KerasModelImport.java:41). This module
builds the full 12-layer BERT-base encoder geometry (hidden 768, 12
heads, FFN 3072, post-LN, learned positions) as a *standard-layer* Keras
functional model — token + position Embedding, MultiHeadAttention, Add,
LayerNormalization, GELU Dense — saves it to HDF5, and imports it
whole-graph via the ordinary functional-import path
(modelimport/keras.py). Nothing here is BERT-specific in the
importer; this is the e2e proof the converter registry composes to a
real model.

Building the Keras model needs ``keras`` and saving it ``h5py``, so
``import_bert_base`` runs where both are installed; the imported model
lives on ``device`` (``cuda`` unless the caller passes ``"cpu"``), where
its attention runs through the flash kernels (SelfAttentionLayer →
ops/flash_attention.flash_attention).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

BERT_BASE = dict(vocab=30522, width=768, n_layers=12, n_heads=12,
                 ffn=3072, max_len=512)


def build_keras_bert(vocab: int = 30522, width: int = 768,
                     n_layers: int = 12, n_heads: int = 12,
                     ffn: int = 3072, max_len: int = 512,
                     seq_len: int = 128):
    """Functional Keras BERT-base-geometry encoder.

    Two integer inputs (token ids, position ids) so learned positions use
    the stock Embedding layer; output is the final hidden states.
    """
    import keras
    from keras import layers as L

    ids = keras.Input((seq_len,), name="input_ids")
    pos = keras.Input((seq_len,), name="position_ids")
    tok_e = L.Embedding(vocab, width, name="tok_embed")(ids)
    pos_e = L.Embedding(max_len, width, name="pos_embed")(pos)
    x = L.Add(name="embed_sum")([tok_e, pos_e])
    x = L.LayerNormalization(epsilon=1e-12, name="embed_ln")(x)
    for i in range(n_layers):
        att = L.MultiHeadAttention(num_heads=n_heads,
                                   key_dim=width // n_heads,
                                   name=f"l{i}_mha")(x, x)
        x = L.Add(name=f"l{i}_res1")([x, att])
        x = L.LayerNormalization(epsilon=1e-12, name=f"l{i}_ln1")(x)
        ff = L.Dense(ffn, activation="gelu", name=f"l{i}_ff1")(x)
        ff = L.Dense(width, name=f"l{i}_ff2")(ff)
        x = L.Add(name=f"l{i}_res2")([x, ff])
        x = L.LayerNormalization(epsilon=1e-12, name=f"l{i}_ln2")(x)
    return keras.Model([ids, pos], x, name="bert_base")


def import_bert_base(seq_len: int = 128, h5_path: Optional[str] = None,
                     device=None, **overrides):
    """Build BERT-base in Keras, save to HDF5, import whole-graph.

    Returns (our ComputationGraph on ``device``, the live Keras model).
    ``overrides`` shrink the geometry for tests (e.g. vocab=1000,
    n_layers=2)."""
    from deeplearning4j_tpu_torch.modelimport.keras import (
        import_keras_model_and_weights)
    from deeplearning4j_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)       # no card: raise before building
    cfg = dict(BERT_BASE, **overrides)
    km = build_keras_bert(seq_len=seq_len, **cfg)
    cleanup = h5_path is None
    if cleanup:
        fd, h5_path = tempfile.mkstemp(suffix=".h5")
        os.close(fd)
    try:
        km.save(h5_path)
        model = import_keras_model_and_weights(h5_path, device=device)
    finally:
        if cleanup:
            os.unlink(h5_path)
    return model, km


def example_inputs(batch: int, seq_len: int, vocab: int,
                   seed: int = 0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq_len)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq_len, dtype=np.float32),
                          (batch, seq_len)).copy()
    return ids, pos
