#!/usr/bin/env python3
"""CPU rehearsal of ``chip_smoke.py``'s ``generate`` phase, and the op
count of one decode tick. It runs against the tree in the working
directory (so one copy measures a parent tree and its change alike); run
it from a tree's root on any machine:

    python3 tools/gen_rehearsal.py rehearse [NEW_TOKENS]   # default 32
    python3 tools/gen_rehearsal.py ops

``rehearse`` runs ``phase_generate`` end to end on the CPU with the
committed model: chip_smoke's source is executed with its ``"cuda"``
device strings turned to ``"cpu"`` and ``torch.cuda.synchronize()``
removed, ``resolve_device`` is pinned to the CPU in the modules that call
it, and ``GEN_NEW`` is lowered. Every check of the phase runs; its
times are CPU times, which say nothing about the card.

``ops`` counts the top-level torch ops of one f32 tick at 8 slots
(``torch.profiler`` on the CPU): the host's work a tick, which on the card
is one launch or more per op.
"""

from __future__ import annotations

import collections
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def _cpu_resolve(device=None):
    return torch.device("cpu")


def rehearse(new_tokens: int) -> None:
    from deeplearning4j_tpu_torch.generation import engine, session
    from deeplearning4j_tpu_torch.models import (multi_layer_network,
                                                 serialization)
    from deeplearning4j_tpu_torch.utils import device
    for mod in (device, multi_layer_network, serialization, session,
                engine):
        mod.resolve_device = _cpu_resolve
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace('device="cuda"', 'device="cpu"').replace(
        "torch.cuda.synchronize()", "None")
    smoke = types.ModuleType("chip_smoke_cpu")
    smoke.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), smoke.__dict__)
    smoke.GEN_NEW = new_tokens
    t0 = time.perf_counter()
    smoke.phase_generate({}, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def ops() -> None:
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.generation import decode as D
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    model = TextGenerationLSTM().init_pretrained(device="cpu")
    spec = D.extract_decode_spec(model)
    dp = D.commit_decode_params(model, spec, "f32")
    tick = D.build_tick(model, spec)
    S = 8
    h, c, rng = D.zero_carries(spec, S, "cpu")
    i64 = dict(dtype=torch.int64)
    b = dict(dtype=torch.bool)
    args = (torch.zeros(S, **i64), torch.zeros(S, **b),
            torch.zeros(S, **i64), torch.ones(S, **b), torch.ones(S),
            torch.zeros(S, **i64), torch.ones(S, **b),
            torch.zeros((S, 2), **i64), torch.zeros(S, **b))
    with torch.no_grad():
        tick(dp, h, c, rng, *args)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tick(dp, h, c, rng, *args)
    top = [e.name for e in prof.events() if e.cpu_parent is None]
    print(f"top-level torch ops in one f32 tick at {S} slots: {len(top)}")
    print(collections.Counter(top).most_common(12))


def main(argv) -> int:
    if not argv or argv[0] not in ("rehearse", "ops"):
        print(__doc__)
        return 2
    if argv[0] == "ops":
        ops()
    else:
        rehearse(int(argv[1]) if len(argv) > 1 else 32)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
