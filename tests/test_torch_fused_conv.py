"""The port's fused conv+BN op (deeplearning4j_tpu_torch.ops.fused_conv)
against the JAX package's ``fused_conv_bn_act`` run in Pallas interpret
mode, on the same numpy inputs.

On the CPU the port's wrappers run their plain PyTorch versions (the
CUDA kernels are held against those on the card by chip_smoke.py and
tests/test_torch_cuda.py). Tolerances:

* float32: y rtol/atol 1e-5, stats rtol 1e-4 / atol 1e-3 — both sides sum
  in f32, in different orders;
* bfloat16: y rtol/atol 2e-2 (a last-bit difference in an f32 sum, or in
  the fused x·s+b, flips a bf16 rounding: 2^-8 relative per rounding),
  stats rtol 1e-3 / atol 1e-2 (f32 sums of the same bf16 operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.fused_conv import \
    fused_conv_bn_act as jax_fused
from deeplearning4j_tpu.ops.fused_conv import \
    stats_to_scale_shift as jax_stats_to_scale_shift
from deeplearning4j_tpu_torch.ops import fused_conv as fc

TOL = {"float32": dict(y=(1e-5, 1e-5), st=(1e-4, 1e-3)),
       "bfloat16": dict(y=(2e-2, 2e-2), st=(1e-3, 1e-2))}


def _mk(seed, n, h, w, cin, cout, kernel):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    shape = (cin, cout) if kernel == 1 else (3, 3, cin, cout)
    wt = rng.normal(0, 0.1, shape).astype(np.float32)
    s = rng.normal(1, 0.1, cin).astype(np.float32)
    b = rng.normal(0, 0.1, cin).astype(np.float32)
    return x, wt, s, b


def _both(x, wt, s, b, dtype, relu, norm, stride):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    yj, stj = jax_fused(jnp.asarray(x).astype(jdt), jnp.asarray(wt).astype(jdt),
                        jnp.asarray(s), jnp.asarray(b), relu, norm, stride,
                        True)
    yt, stt = fc.fused_conv_bn_act(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
        torch.from_numpy(s), torch.from_numpy(b), relu, norm, stride)
    assert yt.dtype == tdt and stt.dtype == torch.float32
    return (np.asarray(yj.astype(jnp.float32)), np.asarray(stj),
            yt.float().numpy(), stt.numpy())


CASES = [
    dict(n=4, h=8, w=8, cin=16, cout=32, kernel=1, stride=1),
    dict(n=4, h=8, w=8, cin=16, cout=32, kernel=1, stride=2),
    dict(n=2, h=33, w=5, cin=24, cout=16, kernel=1, stride=1),  # ragged M
    dict(n=3, h=7, w=5, cin=8, cout=72, kernel=1, stride=2),    # odd plane
    dict(n=4, h=6, w=6, cin=16, cout=24, kernel=3, stride=1),
    dict(n=6, h=2, w=2, cin=32, cout=16, kernel=3, stride=1),   # multi-img
    dict(n=1, h=9, w=7, cin=8, cout=8, kernel=3, stride=1),     # one plane
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case, dtype):
    x, wt, s, b = _mk(7, case["n"], case["h"], case["w"], case["cin"],
                      case["cout"], case["kernel"])
    yj, stj, yt, stt = _both(x, wt, s, b, dtype, True, True, case["stride"])
    assert yt.shape == yj.shape
    rt, at = TOL[dtype]["y"]
    np.testing.assert_allclose(yt, yj, rtol=rt, atol=at)
    rt, at = TOL[dtype]["st"]
    np.testing.assert_allclose(stt, stj, rtol=rt, atol=at)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1)])
def test_no_norm_prologue_matches_jax(kernel, stride, dtype):
    """norm_in=False skips the scale/shift on both kernels (how the block
    runs W1 and Wds)."""
    x, wt, s, b = _mk(3, 2, 5, 4, 8, 16, kernel)
    yj, stj, yt, stt = _both(x, wt, s, b, dtype, False, False, stride)
    rt, at = TOL[dtype]["y"]
    np.testing.assert_allclose(yt, yj, rtol=rt, atol=at)
    rt, at = TOL[dtype]["st"]
    np.testing.assert_allclose(stt, stj, rtol=rt, atol=at)


@pytest.mark.parametrize("kernel", [1, 3])
def test_norm_without_relu_matches_jax(kernel):
    x, wt, s, b = _mk(5, 2, 4, 4, 8, 8, kernel)
    yj, stj, yt, stt = _both(x, wt, s, b, "float32", False, True, 1)
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(stt, stj, rtol=1e-4, atol=1e-3)


def test_zero_border_is_applied_after_the_normalize():
    """A 3×3 conv of a constant plane: with shift > 0 and ReLU the
    normalized interior is positive, the border must stay 0 — so corner
    outputs see 4 taps, edges 6, interior 9."""
    x = torch.zeros((1, 4, 4, 1))
    w = torch.ones((3, 3, 1, 1))
    y, st = fc.fused_c3_reference(x, w, torch.ones(1), torch.full((1,), 2.0),
                                  True, True)
    y = y[0, :, :, 0]
    assert y[0, 0] == 8.0 and y[0, 1] == 12.0 and y[1, 1] == 18.0
    assert st[0, 0] == y.sum() and st[1, 0] == (y * y).sum()


def test_cpu_wrappers_use_the_plain_version_and_count_nothing():
    fc.reset_launch_counts()
    x, wt, s, b = (torch.from_numpy(a) for a in _mk(1, 2, 4, 4, 8, 8, 1))
    y, st = fc.fused_mm(x, wt, s, b, True, True, 2)
    yr, str_ = fc.fused_mm_reference(x, wt, s, b, True, True, 2)
    assert torch.equal(y, yr) and torch.equal(st, str_)
    assert y.shape == (2, 2, 2, 8)
    x3, w3, s3, b3 = (torch.from_numpy(a) for a in _mk(1, 2, 4, 4, 8, 8, 3))
    y3, _ = fc.fused_c3(x3, w3, s3, b3)
    assert torch.equal(y3, fc.fused_c3_reference(x3, w3, s3, b3)[0])
    assert fc.LAUNCHES == {"fused_mm": 0, "fused_c3": 0}


def test_three_by_three_refuses_a_stride():
    x, wt, s, b = (torch.from_numpy(a) for a in _mk(1, 1, 4, 4, 4, 4, 3))
    with pytest.raises(ValueError, match="stride-1"):
        fc.fused_conv_bn_act(x, wt, s, b, True, True, 2)


def test_stats_to_scale_shift_matches_jax():
    rng = np.random.default_rng(0)
    stats = np.stack([rng.normal(0, 10, 16),
                      rng.uniform(50, 100, 16)]).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    beta = rng.normal(0, 0.1, 16).astype(np.float32)
    want = jax_stats_to_scale_shift(jnp.asarray(stats), 32.0,
                                    jnp.asarray(gamma), jnp.asarray(beta),
                                    1e-5)
    got = fc.stats_to_scale_shift(torch.from_numpy(stats), 32.0,
                                  torch.from_numpy(gamma),
                                  torch.from_numpy(beta), 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
