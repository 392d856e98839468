"""Greedy decoding through ``rnn_time_step``, and the char vocabulary.

From the JAX package's ``generation/decode.py``: ``Vocab`` (a copy) and
``reference_decode``, the greedy single-sequence oracle that feeds one
token per ``rnn_time_step`` call. The continuous-batched engine, chunked
prefill, speculative decode and sessions run a one-tick cell
(``LSTM.step_one``) and no TPU kernel; they are not ported yet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.zoo.models import WEIGHTS_DIR

DEFAULT_VOCAB_PATH = WEIGHTS_DIR / "textgen_vocab.json"


class Vocab:
    """char <-> id mapping for the streamed text surface.

    Index 0 is the unknown bucket (the committed textgen vocab starts
    at 1); decoding an id with no char yields U+FFFD so a stream is
    always valid UTF-8 even for an untrained model babbling id 0.
    """

    def __init__(self, stoi: Dict[str, int], size: int):
        self.stoi = dict(stoi)
        self.size = size
        self.itos = ["�"] * size
        for ch, i in self.stoi.items():
            if 0 <= i < size:
                self.itos[i] = ch

    @classmethod
    def load(cls, path=DEFAULT_VOCAB_PATH) -> "Vocab":
        with open(path) as f:
            stoi = json.load(f)
        return cls(stoi, max(stoi.values()) + 1)

    @classmethod
    def identity(cls, size: int) -> "Vocab":
        """No-text fallback for models without a committed char map."""
        return cls({}, size)

    @classmethod
    def default_for(cls, vocab_size: int) -> "Vocab":
        """The committed textgen vocab when sizes line up, else ids."""
        try:
            v = cls.load()
            if v.size == vocab_size:
                return v
        except OSError:
            pass
        return cls.identity(vocab_size)

    def encode(self, text: str) -> List[int]:
        return [self.stoi.get(ch, 0) for ch in text]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(self.itos[i] if 0 <= i < self.size else "�"
                       for i in ids)


def _vocab_size(model) -> int:
    """The dense head's width; the model must be a stack of LSTMs under a
    head with ``W`` and ``b`` (the JAX package's ``extract_decode_spec``
    check)."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        LSTM, unwrap_recurrent)
    if model.params is None:
        model.init()
    layers = model.layers
    if len(layers) < 2:
        raise ValueError("decode needs >= 1 LSTM layer + a dense head")
    for l in layers[:-1]:
        if not isinstance(unwrap_recurrent(l), LSTM):
            raise ValueError(f"decode supports stacked LSTM cores only; "
                             f"layer {l.name!r} is {type(l).__name__}")
    hp = model.params.get(layers[-1].name, {})
    if "W" not in hp or "b" not in hp:
        raise ValueError(f"head {layers[-1].name!r} params missing W/b")
    return int(hp["W"].shape[-1])


def reference_decode(model, prompt_ids: Sequence[int], max_new: int,
                     stop_id: Optional[int] = None) -> List[int]:
    """Greedy single-sequence decode through the model's own
    ``rnn_time_step``, one token per call: the prompt is consumed a token
    at a time, then each argmax is fed back until ``max_new`` tokens (or
    ``stop_id``)."""
    vocab_size = _vocab_size(model)
    if not prompt_ids:
        raise ValueError("reference_decode needs a non-empty prompt")
    carries = None
    out: List[int] = []
    feed = list(prompt_ids)
    pos = 1
    tok = feed[0]
    while len(out) < max_new:
        x = np.zeros((1, vocab_size), np.float32)
        x[0, tok] = 1.0
        probs, carries = model.rnn_time_step(x, carries)
        if pos < len(feed):       # still consuming the prompt
            tok = feed[pos]
            pos += 1
            continue
        nxt = int(probs.reshape(-1).argmax())
        out.append(nxt)
        if stop_id is not None and nxt == stop_id:
            break
        tok = nxt
    return out
