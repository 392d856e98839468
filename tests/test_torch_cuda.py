"""On-card tests of the port's CUDA kernels and serving path. They need an
NVIDIA GPU with ``nvcc`` and skip without one; run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances of a kernel against its plain version on the card: float32 y
rtol/atol 1e-4, bfloat16 y rtol/atol 1e-2 (one bf16 rounding of the same
f32 sum taken in another order), statistics 1e-4 relative to their
largest entry plus 1e-3.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.ops import fused_conv as fc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, shape_x, shape_w, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    cin = shape_x[-1]
    x = torch.randn(shape_x, generator=g, device=card).to(dtype)
    w = (0.1 * torch.randn(shape_w, generator=g, device=card)).to(dtype)
    s = 1 + 0.1 * torch.randn(cin, generator=g, device=card)
    b = 0.1 * torch.randn(cin, generator=g, device=card)
    return x, w, s, b


def _check(y, st, yr, str_, dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert y.dtype == yr.dtype and y.shape == yr.shape
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
    assert (st - str_).abs().max() <= 1e-4 * str_.abs().max() + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,stride,norm", [
    (2, 5, 7, 24, 40, 1, True), (3, 9, 9, 64, 130, 2, False),
    (1, 1, 1, 16, 8, 1, True), (4, 16, 16, 256, 64, 1, False),
    (2, 3, 3, 1100, 70, 1, True),          # K split in 2, ragged slice
    (32, 4, 4, 1024, 2048, 2, False)])     # the stage-3 projection
def test_fused_mm_matches_plain(card, n, h, w, cin, cout, stride, norm,
                                dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (cin, cout), dtype)
    before = fc.LAUNCHES["fused_mm"]
    y, st = fc.fused_mm(x, wt, s, b, True, norm, stride)
    assert fc.LAUNCHES["fused_mm"] == before + 1
    _check(y, st, *fc.fused_mm_reference(x, wt, s, b, True, norm, stride),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 5, 7, 24, 40), (6, 2, 2, 64, 64), (1, 56, 56, 64, 64),
    (3, 1, 3, 8, 72), (2, 3, 5, 130, 40),  # K = 1170: 3 slices
    (32, 2, 2, 512, 512)])                 # stage 3: 8 slices
def test_fused_c3_matches_plain(card, n, h, w, cin, cout, dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    y, st = fc.fused_c3(x, wt, s, b, True, True)
    _check(y, st, *fc.fused_c3_reference(x, wt, s, b, True, True), dtype)


@pytest.mark.parametrize("cin", [32, 512])      # one K slice, eight
def test_rows_do_not_depend_on_the_batch(card, cin):
    x, wt, s, b = _inputs(card, (8, 4, 4, cin), (3, 3, cin, 48),
                          torch.bfloat16)
    y8, _ = fc.fused_c3(x, wt, s, b)
    y3, _ = fc.fused_c3(x[:3].contiguous(), wt, s, b)
    assert torch.equal(y8[:3], y3)


def test_stats_are_deterministic(card):
    x, wt, s, b = _inputs(card, (16, 8, 8, 64), (64, 256), torch.bfloat16)
    runs = [fc.fused_mm(x, wt, s, b)[1] for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x, wt, s, b = _inputs(card, (2, 4, 4, 8), (8, 8), torch.float32)
    with pytest.raises(TypeError):
        fc.fused_mm(x, wt.to(torch.bfloat16), s, b)
    with pytest.raises(ValueError):
        fc.fused_mm(x.transpose(1, 2), wt, s, b)
    with pytest.raises(ValueError):
        fc.fused_mm(x, wt.cpu(), s, b)
    with pytest.raises(NotImplementedError):
        fc.fused_mm(x, wt.requires_grad_(), s, b)


def test_served_slice_model_on_the_card(card):
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    m = ResNet50(num_classes=10, height=32, width=32, fused_blocks=True,
                 s2d_stem=True, compute_dtype="bfloat16").init()
    x = np.random.default_rng(0).normal(0, 1, (5, 32, 32, 3)).astype(
        np.float32)
    fc.reset_launch_counts()
    with ServingEngine(m, batch_limit=4, feature_shape=(32, 32, 3),
                       precision="bf16", warmup=False) as eng:
        got = eng.output(x)
    assert fc.LAUNCHES == {"fused_mm": 72, "fused_c3": 32}   # 2 batches
    np.testing.assert_array_equal(got, m.output(x).float().cpu().numpy())


@pytest.mark.parametrize("kernel", ["fused_mm", "fused_c3"])
def test_without_statistics(card, kernel):
    shape_w = (256, 96) if kernel == "fused_mm" else (3, 3, 256, 96)
    x, wt, s, b = _inputs(card, (4, 6, 6, 256), shape_w, torch.bfloat16)
    fn = getattr(fc, kernel)
    y, st = fn(x, wt, s, b, want_stats=False)
    assert st is None
    assert torch.equal(y, fn(x, wt, s, b)[0])
