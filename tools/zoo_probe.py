#!/usr/bin/env python3
"""Probes of the convolutional model library on the card.

    python3 tools/zoo_probe.py vgg [STEPS]     # default 24

``vgg`` trains VGG16 at the baseline suite's shape
(benchmarks/baseline_suite.py:32-64: 64×64×3, 200 classes, Nesterovs(1e-2,
0.9)) from seed 123 on one fixed random batch, in bf16 and in f32, at
batch 128 and at the suite's 512, K = 4 steps a call, and prints each
run's losses, its step ms, and for every parameter array the share of
its elements whose compute-dtype value (bf16 or f32) moved over the run:
whether the weights the forward sees change at all. Run it from the
repository root on a machine with a card.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))


def vgg(steps: int) -> None:
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.zoo.models import VGG16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = 4
    for dtype in ("bfloat16", "float32"):
        for batch in (128, 512):
            model = VGG16(num_classes=200, height=64, width=64,
                          compute_dtype=dtype).init()
            cast = getattr(torch, dtype)
            before = {f"{n}/{p}": v.to(cast).clone()
                      for n, lp in model.params.items()
                      for p, v in lp.items()}
            rng = np.random.default_rng(16)
            x = torch.from_numpy(rng.normal(0, 1, (batch, 64, 64, 3))
                                 .astype(np.float32)).cuda()
            y = torch.from_numpy(np.eye(200, dtype=np.float32)[
                rng.integers(0, 200, batch)]).cuda()
            xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
            yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
            scan = model._build_scan_train_step()
            losses = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps // k):
                model.train_state, ls = scan(model.train_state, xk, yk)
                losses.append(ls)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / steps
            losses = torch.cat(losses).float().cpu().numpy()
            moved = {key: (model.params[key.split("/")[0]][key.split("/")[1]]
                           .to(cast) != v).float().mean().item()
                     for key, v in before.items()}
            print(f"VGG16 {dtype} batch {batch}: {ms:.3f} ms a step "
                  f"(first call's compile included), losses "
                  f"{' '.join(f'{v:.4f}' for v in losses)}")
            print("  share of elements whose compute-dtype value moved: "
                  + ", ".join(f"{key} {v:.3g}" for key, v in moved.items()))
            del model, scan
            torch.cuda.empty_cache()


def main(argv) -> int:
    if not argv or argv[0] != "vgg":
        print(__doc__)
        return 2
    vgg(int(argv[1]) if len(argv) > 1 else 24)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
