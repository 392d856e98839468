"""Speculative decode: n-gram draft + one-dispatch batched verify.

The port of the JAX package's ``generation/speculative.py``. Decode is
dispatch-bound — one tick per token costs far more in launch overhead
than in FLOPs at decode batch sizes. Speculative decoding amortizes
that: a host-side n-gram/suffix-table draft proposes up to ``k``
continuation tokens per slot from the sequence's own history, and ONE
verify dispatch feeds the slot's current input plus all k drafts
through the stack, samples every position, and commits the longest
accepted prefix on the device. A dispatch emits ``n_acc + 1`` tokens
(the accepted drafts plus the model's own token at the first divergence
— the "bonus" token), so acceptance rate converts directly into
tokens/s.

Exactness discipline: a draft token is accepted iff it equals the token
plain decode *would* have emitted at that position. For greedy that is
the argmax; for seeded sampling the per-position key must be
reproducible without replaying the carried split chain, so sampling keys
derive from **counter-based splitmix64** over (request seed, absolute
position) — ``counter_keys``, a copy of the JAX package's, bit for bit.
Accepted output is bitwise-equal to non-speculative decode in the same
sampling mode, because the verify loop runs the tick's own
``_stack_step``, head and sampler at the same row count. Keys are keyed
on (seed, position) only — never the physical slot index — so
co-residency stays invisible.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nlp.pairgen import GOLDEN, _mix_np

# domain-separation salt so generation draws never collide with the
# embedding pair streams sharing the splitmix64 construction
_SALT = np.uint64(0x47454E5350454331)          # "GENSPEC1"
_LO32 = np.uint64(0xFFFFFFFF)


def counter_keys(seeds: np.ndarray, pos: np.ndarray,
                 k: int) -> np.ndarray:
    """(S,) request seeds + (S,) absolute positions -> (S, k, 2) uint32
    sampling keys; ``key[s, j]`` covers position ``pos[s] + j``.

    key64 = mix(mix(seed ^ SALT) + (pos + j + 1) * GOLDEN) — the
    pairgen ``draws_at`` shape with a generation-domain salt. Pure
    counter arithmetic: any position's key is computable from (seed,
    position) alone, which is what the speculative verify step and
    cross-node session resume both rely on.
    """
    s = np.asarray(seeds, np.uint64).reshape(-1, 1) ^ _SALT  # host-sync-ok: seeds are host scalars, keys are host-computed by design
    base = _mix_np(s.copy())
    p = (np.asarray(pos, np.uint64).reshape(-1, 1)  # host-sync-ok: positions are host counters
         + np.arange(k, dtype=np.uint64)[None, :])
    z = _mix_np(base + (p + np.uint64(1)) * np.uint64(GOLDEN))
    out = np.empty(z.shape + (2,), np.uint32)
    out[..., 0] = (z >> np.uint64(32)).astype(np.uint32)
    out[..., 1] = (z & _LO32).astype(np.uint32)
    return out


class NGramDraft:
    """Per-sequence n-gram/suffix draft table.

    Observes every token the sequence consumes or emits and keeps, for
    each context length 1..max_order, the most recent continuation seen
    after that context. ``propose(k)`` walks the longest-match table
    greedily to extend the current suffix — character LSTM output is
    highly self-repetitive, so recency-biased longest-suffix matching
    is a strong cheap draft (and a wrong draft only costs the already
    amortized verify dispatch, never correctness)."""

    __slots__ = ("max_order", "max_history", "history", "tables")

    def __init__(self, max_order: int = 3, max_history: int = 512):
        self.max_order = int(max_order)
        self.max_history = int(max_history)
        self.history: List[int] = []
        self.tables = [dict() for _ in range(self.max_order)]

    def observe(self, tok: int) -> None:
        h = self.history
        for o in range(self.max_order):
            n = o + 1
            if len(h) >= n:
                self.tables[o][tuple(h[-n:])] = tok
        h.append(tok)
        if len(h) > self.max_history:
            del h[:len(h) - self.max_history]

    def observe_many(self, toks) -> None:
        for t in toks:
            self.observe(int(t))

    def _lookup(self, ctx: List[int]) -> Optional[int]:
        for o in reversed(range(self.max_order)):
            n = o + 1
            if len(ctx) >= n:
                hit = self.tables[o].get(tuple(ctx[-n:]))
                if hit is not None:
                    return hit
        return None

    def propose(self, k: int) -> List[int]:
        out: List[int] = []
        ctx = list(self.history)
        for _ in range(k):
            tok = self._lookup(ctx)
            if tok is None:
                break
            out.append(tok)
            ctx.append(tok)
        return out


def build_spec_tick(model, spec, k: int):
    """The draft-verify-commit step for up to ``k`` drafts.

    spec_tick(dp, h, c, rng, tokens, n_draft, reset, seeds, active,
    temp, top_k, greedy, ext_keys, use_ext)
        -> (h', c', rng', emitted, n_emit)

    - tokens (S, k+1) int64: position 0 is the slot's current input,
      the rest its draft continuation (padded past ``n_draft``)
    - n_draft (S,) int64: drafts attached this dispatch (0 = plain tick
      semantics — exactly one token emits)
    - ext_keys (S, k+1, 2) int64 + use_ext (S,): counter-mode sampling
      keys per position (see ``counter_keys``); chain-mode slots use
      the carried split chain, advanced one split per emitted token —
      bitwise the same chain plain decode would have consumed
    - emitted (S, k+1) int64: per-position sampled tokens; the scheduler
      streams ``emitted[i, :n_emit[i]]``
    - n_emit (S,) int64: accepted drafts + 1 bonus token (0 for inactive
      slots)

    The commit stays on the device: acceptance compares each draft
    against the token sampled at its position, the carries/keys roll
    back to the state after the last *emitted* token by a ``gather``
    over the loop's stacked states (the JAX package's ``lax.scan`` +
    ``take_along_axis``), and masked-neutral slots pass through.
    """
    import torch

    from deeplearning4j_tpu_torch.generation.decode import (
        _head_logits, _lstm_cores, _reset_state, _sample, _split,
        _stack_step)
    if k < 1:
        raise ValueError("speculative k must be >= 1")
    cores = _lstm_cores(model, spec)
    K1 = k + 1

    def spec_tick(dp, h, c, rng, tokens, n_draft, reset, seeds, active,
                  temp, top_k, greedy, ext_keys, use_ext):
        h0, c0, rng0 = _reset_state(h, c, rng, reset, seeds)
        hs, cs, r = h0, c0, rng0
        ys_h = [[] for _ in h0]
        ys_c = [[] for _ in c0]
        ys_rng, ys_tok = [], []
        for j in range(K1):
            hs, cs, top = _stack_step(cores, dp, tokens[:, j], hs, cs)
            logits = _head_logits(dp["head"], top)
            r, sample = _split(r)
            key = torch.where(use_ext[:, None], ext_keys[:, j], sample)
            ys_tok.append(_sample(key, logits, temp, top_k, greedy))
            for l in range(len(hs)):
                ys_h[l].append(hs[l])
                ys_c[l].append(cs[l])
            ys_rng.append(r)
        targets = torch.stack(ys_tok, dim=1)                 # (S, K1)
        drafts = tokens[:, 1:]
        dpos = torch.arange(k, device=tokens.device)[None, :]
        ok = (targets[:, :k] == drafts) & (dpos < n_draft[:, None])
        n_acc = torch.cumprod(ok.to(torch.int64), dim=1).sum(dim=1)

        def sel(ys):
            y = torch.stack(ys, dim=0)                       # (K1, S, D)
            idx = n_acc.view(1, -1, 1).expand(1, y.shape[1], y.shape[2])
            return y.gather(0, idx)[0]

        amask = active[:, None]
        h_out = [torch.where(amask, sel(y), hi) for y, hi in zip(ys_h, h0)]
        c_out = [torch.where(amask, sel(y), ci) for y, ci in zip(ys_c, c0)]
        rng_out = torch.where(amask, sel(ys_rng), rng0)
        n_emit = torch.where(active, n_acc + 1, 0)
        return h_out, c_out, rng_out, targets, n_emit

    return spec_tick
