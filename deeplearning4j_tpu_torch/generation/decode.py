"""Pure decode building blocks: model → tick function.

The port of the JAX package's ``generation/decode.py``. A *tick*
advances every slot of an (S,)-shaped decode batch by exactly one
token: embed the input tokens, run each stacked LSTM cell, project
through the dense head, sample. Everything that crosses ticks — the
(h, c) carries and the per-slot sampling keys — stays on the device;
the per-tick host traffic is the small control arrays in (tokens, reset
flags, seeds, sampling knobs) and the sampled tokens out (which *are*
the streamed response payload).

Join/leave mid-flight rides the masked-neutral trick: a joining slot's
``reset`` flag zeroes its carry rows and reseeds its key inside the
tick; an inactive slot's rows pass through untouched, so co-resident
sequences are independent of who else occupies the batch.

**A row's bits do not depend on the bucket.** Chunked prefill equals
tick-at-a-time prefill, speculative output equals plain decode, and a
resumed session continues bitwise only while each slot's row is
computed independently of S and of its co-residents. Elementwise ops
are; a library product is not: torch's CPU build takes a gemv at one
row and a gemm above it, and a row of ``(1, K) @ (K, N)`` differs in
its last bits from the same row of ``(2, K) @ (K, N)``; cuBLAS may pick
another algorithm for every row count (chip_smoke.py's ``generate``
phase logs whether it does at the tick's shapes). So every product of
the tick, the prefill and the verify runs at a fixed row count per
call: the rows are padded to a multiple of ``ROW_BLOCK`` and multiplied
``ROW_BLOCK`` rows at a time (``_mm``), one shape for every bucket,
which holds on any library. The first layer's product with a one-hot
row is the row of ``Wx`` itself, taken by index: exact, and equal to
the product (TF32 off).

**Sampling keys.** The JAX tick carries threefry keys; torch has no
splittable, vectorized key, and its random numbers never match JAX's.
The port keeps the *contract* on (S, 2) keys held on the device (two
32-bit words in int64): a reset key is ``(0, seed)`` (as
``PRNGKey(seed)``), a consumed token advances it by one split, a split
gives a (carry, sample) pair, and a slot samples by a keyed Gumbel-max
over its top-k-masked, temperature-scaled logits. Every draw is integer
counter-hash arithmetic on 32-bit words held in int64 (``_hash2``):
a 32-bit product is formed from the constant's 16-bit halves
(``_mul32``) so no intermediate passes 2^49, and every step is masked
back to 32 bits — the same bits on the CPU and the card. Counter mode
(``speculative.counter_keys``) feeds its host keys to the same sampler.
Sampled streams are therefore checked inside the port only; greedy
streams equal the JAX package's.

The head has three precision arms (f32 / bf16 / int8 via
``ops/quantize.py``); the LSTM stack is always f32. Its cores are
``LSTM`` or ``GravesLSTM``: a Graves core's peepholes are elementwise
(``i`` and ``f`` see ``c_prev``, ``o`` the new ``c``), so they add no
product and a row still does not depend on its bucket. The tick, the
prefill and the verify
are plain torch: the JAX package runs them through ``LSTM.step_one``,
which reaches no TPU kernel. ``reference_decode`` and ``probe_head`` go
through the model's own ``rnn_time_step`` (on the card, the ``lstm_fwd``
kernel).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.zoo.models import WEIGHTS_DIR

DEFAULT_VOCAB_PATH = WEIGHTS_DIR / "textgen_vocab.json"

# rows per product call of the tick, the prefill and the verify
ROW_BLOCK = 8


# ---- vocab ------------------------------------------------------------


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


# ---- model -> decode spec --------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeSpec:
    """Static decode structure extracted (and validated) once."""
    lstm_names: Tuple[str, ...]
    hidden_sizes: Tuple[int, ...]
    head_name: str
    vocab_size: int

    @property
    def n_layers(self) -> int:
        return len(self.lstm_names)


def extract_decode_spec(model) -> DecodeSpec:
    """Validate the network shape the tick supports: a stack of LSTM
    cells (``GravesLSTM`` peepholes included: the tick calls each core's
    own ``gate_update``) over one-hot token inputs under a dense softmax
    head. Anything
    else fails here, at engine construction, not inside the first
    tick."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        LSTM, unwrap_recurrent)
    if model.params is None:
        model.init()
    layers = model.layers
    if len(layers) < 2:
        raise ValueError("decode needs >= 1 LSTM layer + a dense head")
    if getattr(model, "_preprocessors", None):
        raise ValueError(
            "decode tick does not support input preprocessors; got "
            f"{sorted(model._preprocessors)}")
    names, sizes = [], []
    for l in layers[:-1]:
        core = unwrap_recurrent(l)
        if not isinstance(core, LSTM):
            raise ValueError(
                f"decode supports stacked LSTM cores only; layer "
                f"{l.name!r} is {type(core).__name__}")
        names.append(l.name)
        sizes.append(core.n_out)
    head = layers[-1]
    if not hasattr(head, "pre_output"):
        raise ValueError(
            f"last layer {head.name!r} ({type(head).__name__}) has no "
            "dense pre_output; decode needs a projection head")
    hp = model.params.get(head.name, {})
    if "W" not in hp or "b" not in hp:
        raise ValueError(f"head {head.name!r} params missing W/b")
    vocab = int(hp["W"].shape[-1])
    if model.params[names[0]]["Wx"].shape[0] != vocab:
        raise ValueError("decode feeds one-hot tokens: the first LSTM's "
                         "input width must equal the head's vocab")
    return DecodeSpec(tuple(names), tuple(sizes), head.name, vocab)


def _lstm_cores(model, spec: DecodeSpec):
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        unwrap_recurrent)
    by_name = {l.name: l for l in model.layers}
    return [unwrap_recurrent(by_name[n]) for n in spec.lstm_names]


# ---- decode params (per-precision head) ------------------------------


def commit_decode_params(model, spec: DecodeSpec, precision: str,
                         x_scale: Optional[float] = None):
    """Decode param tree on the model's device: f32 LSTM stack + the
    head in the requested precision arm. int8 rides ops/quantize
    (per-output-channel weight scales, one calibrated activation
    scale)."""
    from deeplearning4j_tpu_torch.ops.quantize import quantize_weight
    p = model.params
    dev = model.device

    def f32(t):
        return t.detach().to(dev, torch.float32).clone()

    lstm = [{k: f32(v) for k, v in p[name].items()}
            for name in spec.lstm_names]
    W = f32(p[spec.head_name]["W"])
    b = f32(p[spec.head_name]["b"])
    if precision == "f32":
        head = {"W": W, "b": b}
    elif precision == "bf16":
        head = {"W": W.to(torch.bfloat16), "b": b.to(torch.bfloat16)}
    elif precision == "int8":
        if x_scale is None:
            raise ValueError("int8 head needs a calibrated x_scale")
        w_q, w_scale = quantize_weight(W.cpu().numpy(), reduce_axes=(0,))
        head = {"Wq": torch.from_numpy(w_q).to(dev),
                "w_scale": torch.from_numpy(w_scale).to(dev),
                "x_scale": torch.tensor(np.float32(x_scale), device=dev),
                "b": b}
    else:
        raise ValueError(f"unknown decode precision {precision!r}")
    return {"lstm": lstm, "head": head}


def head_bytes_per_token(spec: DecodeSpec, hidden: int,
                         precision: str) -> int:
    """Bytes the head moves per decode tick per slot: the weight matrix
    is re-read every tick (decode is memory-bound), plus bias/scales.
    The $/token A/B's 'bytes moved' column."""
    V = spec.vocab_size
    if precision == "f32":
        return hidden * V * 4 + V * 4
    if precision == "bf16":
        return hidden * V * 2 + V * 2
    if precision == "int8":
        # int8 weights + f32 per-channel scales + f32 bias + one x_scale
        return hidden * V * 1 + V * 4 + V * 4 + 4
    raise ValueError(precision)


# ---- sampling keys: counter-hash arithmetic on 32-bit words -----------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for words x in [0, 2^32) held in int64 and a
    32-bit constant c, from c's 16-bit halves: each partial product
    stays below 2^48 (int64 has no unsigned wrap)."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (x * (c & 0xFFFF) + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mixer (xor-shift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash2(k0: torch.Tensor, k1: torch.Tensor, ctr) -> Tuple[torch.Tensor,
                                                              torch.Tensor]:
    """Two fresh 32-bit words from the key (k0, k1) and a counter."""
    a = _mix32((k0 + _mul32(ctr + 1, 0x9E3779B9)) & _M32)
    b = _mix32(k1 ^ a ^ 0x632BE5AB)
    a = _mix32(a ^ ((b + 0x85EBCA6B) & _M32))
    return a, b


def _derive(keys: torch.Tensor, ctr: int) -> torch.Tensor:
    """(S, 2) keys -> the (S, 2) keys of branch ``ctr``."""
    a, b = _hash2(keys[:, 0], keys[:, 1], ctr)
    return torch.stack([a, b], dim=1)


def _split(keys: torch.Tensor):
    """(carry, sample) keys: one split, as ``jax.random.split(k, 2)``;
    both branches in one pass (equal to ``_derive(keys, 0)`` and
    ``_derive(keys, 1)``)."""
    ctr = torch.arange(2, device=keys.device)[None, :]
    a, b = _hash2(keys[:, :1], keys[:, 1:], ctr)           # (S, 2) each
    return torch.stack([a[:, 0], b[:, 0]], 1), torch.stack([a[:, 1],
                                                            b[:, 1]], 1)


def _fresh_keys(seeds: torch.Tensor) -> torch.Tensor:
    """The reset key of each seed: (0, seed), as ``PRNGKey(seed)``."""
    return torch.stack([torch.zeros_like(seeds), seeds & _M32], dim=1)


def _gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """(S, V) f32 Gumbel noise from each row's key: a 23-bit uniform in
    (0, 1) from one hashed word per vocab index."""
    ctr = torch.arange(V, device=keys.device)[None, :]
    a, _ = _hash2(keys[:, :1], keys[:, 1:], ctr)
    u = ((a >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


# ---- the tick ---------------------------------------------------------


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at ``ROW_BLOCK`` rows per product call (module
    docstring): a row's bits do not depend on the row count."""
    s = x.shape[0]
    pad = -s % ROW_BLOCK
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
    if s + pad == ROW_BLOCK:
        out = x @ w
    else:
        out = torch.cat([x[i:i + ROW_BLOCK] @ w
                         for i in range(0, s + pad, ROW_BLOCK)])
    return out[:s]


def _stack_step(cores, dp, tokens, hs, cs):
    """One position through the stacked LSTM cells. Shared verbatim by
    the tick, the chunked prefill and the speculative verify so every
    path computes bitwise-identical carries and head inputs — the parity
    guarantees all hang off this one function."""
    h_new, c_new = [], []
    x = None
    for i, core in enumerate(cores):
        p = dp["lstm"][i]
        if i == 0:      # one-hot input: the product is a row of Wx
            zx = p["Wx"][tokens] + p["b"]
        else:
            zx = _mm(x, p["Wx"]) + p["b"]
        hy, cy = core.gate_update(zx + _mm(hs[i], p["Wh"]), cs[i], p)
        h_new.append(hy)
        c_new.append(cy)
        x = hy
    return h_new, c_new, x


def _head_logits(head, h):
    if "Wq" in head:
        from deeplearning4j_tpu_torch.ops.quantize import int8_dot
        return int8_dot(h, head["Wq"], head["w_scale"],
                        head["x_scale"]) + head["b"]
    W = head["W"]
    if W.dtype == torch.bfloat16:
        return (_mm(h.to(torch.bfloat16), W) + head["b"]).to(
            torch.float32)
    return _mm(h, W) + head["b"]


def _sample(keys, logits, temp, top_k, greedy):
    """Per-row sampling: greedy argmax, or temperature + top-k by a
    keyed Gumbel-max. ``top_k <= 0`` means no truncation. argmax is
    taken on raw logits — identical to argmax of the model's softmax
    output, so greedy decode is comparable to the reference path."""
    V = logits.shape[-1]
    greedy_tok = logits.argmax(-1)
    scaled = logits / temp.clamp_min(1e-3)[:, None]
    k = torch.where(top_k <= 0, V, top_k).clamp(1, V)
    kth = scaled.sort(-1, descending=True).values.gather(1, k[:, None] - 1)
    masked = torch.where(scaled >= kth, scaled, float("-inf"))
    tok = (masked + _gumbel(keys, V)).argmax(-1)
    return torch.where(greedy, greedy_tok, tok)


def _reset_state(h, c, rng, reset, seeds):
    rmask = reset[:, None]
    rng0 = torch.where(rmask, _fresh_keys(seeds), rng)
    h0 = [torch.where(rmask, 0.0, hl) for hl in h]
    c0 = [torch.where(rmask, 0.0, cl) for cl in c]
    return h0, c0, rng0


def build_tick(model, spec: DecodeSpec):
    """The single-tick decode step.

    tick(dp, h, c, rng, tokens, reset, seeds, active, temp, top_k,
    greedy, ext_key, use_ext) -> (h', c', rng', next_tokens)

    All arguments are tensors on the decode device:

    - dp: committed decode params ({"lstm": [...], "head": {...}})
    - h, c: per-layer lists of (S, H_l) f32 — device-resident carries
    - rng: (S, 2) int64 per-slot keys (two 32-bit words)
    - tokens (S,) int64 in, reset/active (S,) bool, seeds (S,) int64,
      temp (S,) f32, top_k (S,) int64, greedy (S,) bool — host controls
    - ext_key (S, 2) int64 + use_ext (S,) bool — counter-mode sampling
      keys (splitmix64 of (seed, position), computed host-side by
      ``speculative.counter_keys``). A slot with ``use_ext`` samples
      with its external key instead of the carried split chain, which
      is what lets the speculative verify step reproduce any position's
      sampling without replaying the chain. The chain still advances
      either way.
    - next_tokens (S,) int64 — the streamed payload

    A reset slot's carries are zeroed and its key re-derived from its
    seed *inside* the tick; an inactive slot's state rows and token pass
    through unchanged (masked-neutral), which is what makes each slot's
    trajectory — including its key chain, advanced exactly one split
    per active tick — independent of its co-residents.
    """
    cores = _lstm_cores(model, spec)

    def tick(dp, h, c, rng, tokens, reset, seeds, active, temp, top_k,
             greedy, ext_key, use_ext):
        hs, cs, rng_in = _reset_state(h, c, rng, reset, seeds)
        h_new, c_new, top = _stack_step(cores, dp, tokens, hs, cs)
        logits = _head_logits(dp["head"], top)
        carry, sample = _split(rng_in)
        key = torch.where(use_ext[:, None], ext_key, sample)
        sampled = _sample(key, logits, temp, top_k, greedy)
        amask = active[:, None]
        h_out = [torch.where(amask, hn, hi) for hn, hi in zip(h_new, hs)]
        c_out = [torch.where(amask, cn, ci) for cn, ci in zip(c_new, cs)]
        rng_out = torch.where(amask, carry, rng_in)
        next_tokens = torch.where(active, sampled, tokens)
        return h_out, c_out, rng_out, next_tokens

    return tick


# ---- chunked prefill ---------------------------------------------------


def prefill_chunk_ladder(max_chunk: int) -> List[int]:
    """pow2 chunk sizes up to ``max_chunk`` (always included) — the
    prefill analog of the slot-bucket ladder, warmed the same way so a
    live prompt of any length dispatches warm shapes only."""
    if max_chunk < 1:
        raise ValueError("max_chunk must be >= 1")
    out, b = [], 8
    while b < max_chunk:
        out.append(b)
        b <<= 1
    if not out or out[-1] != max_chunk:
        out.append(max_chunk)
    return sorted(set(out))


def build_prefill(model, spec: DecodeSpec):
    """The multi-token prefill step: a loop over a padded (S, C) prompt
    chunk with per-slot valid lengths (the JAX package's ``lax.scan``).

    prefill(dp, h, c, rng, chunk, lens, reset, seeds, active)
        -> (h', c', rng')

    A slot consumes ``lens[i]`` tokens of its chunk row; positions past
    its length (and inactive slots) are masked-neutral pass-throughs.
    No head projection and no sampling — prefill only advances carries.
    The per-slot key chain advances exactly one split per consumed
    token, identical to feeding the same tokens through the tick one at
    a time, so chunked and tick-at-a-time prefill are bitwise-
    interchangeable mid-sequence.
    """
    cores = _lstm_cores(model, spec)

    def prefill(dp, h, c, rng, chunk, lens, reset, seeds, active):
        hs, cs, r = _reset_state(h, c, rng, reset, seeds)
        for t in range(chunk.shape[1]):
            vmask = (active & (t < lens))[:, None]
            h_new, c_new, _ = _stack_step(cores, dp, chunk[:, t], hs, cs)
            hs = [torch.where(vmask, hn, hi) for hn, hi in zip(h_new, hs)]
            cs = [torch.where(vmask, cn, ci) for cn, ci in zip(c_new, cs)]
            r = torch.where(vmask, _derive(r, 0), r)
        return hs, cs, r

    return prefill


# ---- per-slot carry extract/restore (session store) -------------------


def build_slot_extract(spec: DecodeSpec):
    """Gather of one slot's device state rows — the capture half of
    session resume."""
    def extract(h, c, rng, idx: int):
        return [hl[idx] for hl in h], [cl[idx] for cl in c], rng[idx]

    return extract


def build_slot_restore(spec: DecodeSpec):
    """Scatter of saved carry rows into one slot of the live batch — the
    resume half. The joining slot skips its reset (its state IS the
    restored rows) and continues the sequence as if it had never
    retired."""
    def restore(h, c, rng, hr, cr, rr, idx: int):
        def put(t, row):
            t = t.clone()
            t[idx] = row
            return t
        return ([put(hl, r) for hl, r in zip(h, hr)],
                [put(cl, r) for cl, r in zip(c, cr)], put(rng, rr))

    return restore


def zero_carries(spec: DecodeSpec, n_slots: int, device):
    """Fresh device state for a bucket: zero carries + zero key rows
    (every slot is reseeded through its reset flag before first use)."""
    h = [torch.zeros((n_slots, hd), dtype=torch.float32, device=device)
         for hd in spec.hidden_sizes]
    c = [torch.zeros((n_slots, hd), dtype=torch.float32, device=device)
         for hd in spec.hidden_sizes]
    rng = torch.zeros((n_slots, 2), dtype=torch.int64, device=device)
    return h, c, rng


def build_resize(spec: DecodeSpec, src: int, dst: int):
    """Bucket resize for the device state. Growing zero-pads new slot
    rows (they get reseeded on join); shrinking slices — the scheduler
    only shrinks when no active slot lives above ``dst``. Warmed like
    the tick."""
    def resize(h, c, rng):
        if dst > src:
            pad = dst - src

            def grow(t):
                return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
            return [grow(t) for t in h], [grow(t) for t in c], grow(rng)
        return ([t[:dst].clone() for t in h], [t[:dst].clone() for t in c],
                rng[:dst].clone())

    return resize


# ---- reference decode (test/bench oracle) ----------------------------


def reference_decode(model, prompt_ids: Sequence[int], max_new: int,
                     stop_id: Optional[int] = None) -> List[int]:
    """Greedy single-sequence decode through the model's own
    ``rnn_time_step``, one token per call: the prompt is consumed a token
    at a time, then each argmax is fed back until ``max_new`` tokens (or
    ``stop_id``)."""
    vocab_size = extract_decode_spec(model).vocab_size
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


# ---- int8 head calibration + decode-level quant gate -----------------


def probe_head(model, spec: DecodeSpec, probe_ids: Sequence[int],
               free_run: int = 32):
    """Greedy f32 probe drive: consume ``probe_ids`` then free-run
    ``free_run`` ticks, collecting the head's input activations (the
    last LSTM's h — bounded in (-1, 1) since h = o*tanh(c)) and the f32
    logits at every position. Feeds both the int8 activation-scale
    calibration and the decode-level quant gate. A host loop over the
    model's ``rnn_time_step``: runs once at engine init, pre-traffic."""
    if not probe_ids:
        raise ValueError("probe needs a non-empty id stream")
    last = spec.lstm_names[-1]
    p = model.params
    W = p[spec.head_name]["W"].detach().float().cpu().numpy()
    b = p[spec.head_name]["b"].detach().float().cpu().numpy()
    carries = None
    hs: List[np.ndarray] = []
    feed = list(probe_ids)
    pos = 1
    tok = feed[0]
    total = len(feed) - 1 + free_run
    for _ in range(total):
        x = np.zeros((1, spec.vocab_size), np.float32)
        x[0, tok] = 1.0
        probs, carries = model.rnn_time_step(x, carries)
        hs.append(carries[last][0][0].float().cpu().numpy())
        if pos < len(feed):
            tok = feed[pos]
            pos += 1
        else:
            tok = int(probs.reshape(-1).argmax())
    h_stream = np.stack(hs)                        # (T, H)
    logits_f32 = h_stream @ W + b                  # (T, V)
    return h_stream, logits_f32


def int8_head_gate(model, spec: DecodeSpec, probe_ids: Sequence[int],
                   top1_budget: float = 0.03, logit_budget: float = 0.25,
                   free_run: int = 32, model_name: str = "generate",
                   registry=None):
    """Calibrate the int8 head and gate it at the decode level: next-
    token (argmax) agreement against the f32 head over the probe
    trajectory must stay within ``top1_budget``. Returns (x_scale,
    GateResult); raises QuantGateError on a miss."""
    from deeplearning4j_tpu_torch.evaluation.quant_gate import (
        GateResult, QuantGateError)
    from deeplearning4j_tpu_torch.ops.quantize import (
        activation_scale, int8_dot, quantize_weight)
    h_stream, logits_f32 = probe_head(model, spec, probe_ids, free_run)
    amax = float(np.abs(h_stream).max())
    x_scale = activation_scale(amax)
    p = model.params
    W = p[spec.head_name]["W"].detach().float().cpu().numpy()
    b = p[spec.head_name]["b"].detach().float().cpu().numpy()
    w_q, w_scale = quantize_weight(W, reduce_axes=(0,))
    logits_q = int8_dot(
        torch.from_numpy(h_stream), torch.from_numpy(w_q),
        torch.from_numpy(w_scale), torch.tensor(x_scale)).numpy() + b
    agree = float((logits_q.argmax(-1) == logits_f32.argmax(-1)).mean())
    delta = np.abs(logits_q - logits_f32)
    denom = float(np.abs(logits_f32).mean()) or 1.0
    rel = float(np.linalg.norm(logits_q - logits_f32)
                / (np.linalg.norm(logits_f32) or 1.0))
    result = GateResult(
        model=model_name, n_examples=int(h_stream.shape[0]),
        n_positions=int(h_stream.shape[0]),
        top1_agreement=agree, top1_delta=1.0 - agree,
        max_logit_delta=float(delta.max()) / denom,
        mean_logit_delta=float(delta.mean()) / denom,
        top1_budget=top1_budget, logit_budget=logit_budget,
        layer_errors={spec.head_name: rel}, fallback=[],
        passed=(1.0 - agree) <= top1_budget)
    if registry is not None:
        registry.gauge(
            "dl4j_gen_int8_agreement",
            "decode-level next-token agreement, int8 head vs f32"
        ).set(agree, model=model_name)
    if not result.passed:
        raise QuantGateError(result)
    return float(x_scale), result
