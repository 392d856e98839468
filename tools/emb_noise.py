#!/usr/bin/env python3
"""Rounding noise of one full-width Word2Vec superchunk.

The first superchunk of ``chip_smoke.py``'s SGNS arm (100k-word zipf
corpus, layer 128, window 5, negative 5, chunks of 65536 pairs, shared
negatives) is run by the port's float32 path, and by the same path with
its segment sums taken from a float32 running sum (the JAX package's
form) instead of a float64 one, each held against the same path in
float64. Prints each table's largest difference relative to
its largest entry. Run from a tree's root, on the CPU (about 30 s):

    python3 tools/emb_noise.py [TOKENS]     # default 600000

With ``--card`` the same float32 superchunk also runs on the card, and
its difference from the float64 reference and from the CPU's float32
result (``chip_smoke.py``'s parity gate, EMB_PARITY_TOL) is printed too.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path.cwd()))


def main(argv) -> int:
    import chip_smoke as cs
    from deeplearning4j_tpu_torch.nlp import skipgram as sk
    card = "--card" in argv
    argv = [a for a in argv if a != "--card"]
    tokens = int(argv[0]) if argv else 600_000
    seqs = cs.zipf_sentences(cs.EMB["vocab"], tokens, cs.EMB["sentence"],
                             cs.EMB["zipf"], cs.EMB["corpus_seed"])
    m = cs.w2v_model({}, "cpu", overlap_pairgen=False)
    m.build_vocab(seqs)
    m._init_tables()
    start = (m.syn0.clone(), m.syn1.clone())
    preps = []
    m._dispatch_chunks = preps.append
    m.fit(seqs)
    cen, ctx, nv, lrs, negs = (torch.from_numpy(a) for a in preps[0][1:])

    def run(dtype, device="cpu"):
        s0, s1 = (t.to(device, dtype).clone() for t in start)
        sk.skipgram_scan_step_shared(
            s0, s1, *(t.to(device) for t in (cen, ctx, negs, nv)),
            lrs.to(device, dtype))
        return s0.cpu(), s1.cpu()

    ref = run(torch.float64)
    f64_sums = run(torch.float32)
    running = sk._running_sum
    sk._running_sum = lambda x: running(x.to(torch.float32)).to(x.dtype)
    try:
        f32_sums = run(torch.float32)
    finally:
        sk._running_sum = running
    rows = [("float64 running sums", f64_sums, ref),
            ("float32 running sums", f32_sums, ref)]
    if card:
        on_card = run(torch.float32, "cuda")
        rows += [("the card, float64 running sums", on_card, ref),
                 ("the card against the CPU's float32", on_card, f64_sums)]
    print(f"{tokens} tokens, {m.vocab.num_words()} words")
    for name, got, want in rows:
        errs = [float((g - r.float()).abs().max() / r.abs().max())
                for g, r in zip(got, want)]
        against = "float64" if want is ref else "the CPU"
        print(f"{name}: syn0 {errs[0]:.3g}, syn1 {errs[1]:.3g} of the "
              f"largest entry against {against}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
