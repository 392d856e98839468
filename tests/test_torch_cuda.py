"""On-card tests of the port's CUDA kernels and serving path. They need an
NVIDIA GPU with ``nvcc`` and skip without one; run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Tolerances of a kernel against its plain version on the card: float32 y
rtol/atol 1e-4, bfloat16 y rtol/atol 1e-2 (one bf16 rounding of the same
f32 sum taken in another order), statistics 1e-4 relative to their
largest entry plus 1e-3. Backward: dx as y; dW, dscale and dshift (f32
sums over M of the same rounded factors, in another order) 1e-4 relative
to their largest entry plus 1e-5.
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


# the sixteen 1×1 calls of the ResNet50 path at batch 32 (N, H, W, Cin,
# Cout, stride, normalize): M 128-8192, four stride-2 projections
MM_PATH = [
    (32, 16, 16, 64, 64, 1, False), (32, 16, 16, 64, 256, 1, True),
    (32, 16, 16, 64, 256, 1, False), (32, 16, 16, 256, 64, 1, False),
    (32, 16, 16, 256, 128, 2, False), (32, 8, 8, 128, 512, 1, True),
    (32, 16, 16, 256, 512, 2, False), (32, 8, 8, 512, 128, 1, False),
    (32, 8, 8, 512, 256, 2, False), (32, 4, 4, 256, 1024, 1, True),
    (32, 8, 8, 512, 1024, 2, False), (32, 4, 4, 1024, 256, 1, False),
    (32, 4, 4, 1024, 512, 2, False), (32, 2, 2, 512, 2048, 1, True),
    (32, 4, 4, 1024, 2048, 2, False),      # the stage-3 projection
    (32, 2, 2, 2048, 512, 1, False)]       # M = 128, K in 8 slices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,stride,norm", [
    (2, 5, 7, 24, 40, 1, True), (3, 9, 9, 64, 130, 2, False),
    (1, 1, 1, 16, 8, 1, True), (4, 16, 16, 256, 64, 1, False),
    (2, 3, 3, 1100, 70, 1, True),          # K split in 2 (bf16: 5), ragged
    *MM_PATH,
    (128, 16, 16, 64, 256, 1, True)])      # M = 32768 at the train batch
def test_fused_mm_matches_plain(card, n, h, w, cin, cout, stride, norm,
                                dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (cin, cout), dtype)
    before = fc.LAUNCHES["fused_mm"]
    y, st = fc.fused_mm(x, wt, s, b, True, norm, stride)
    assert fc.LAUNCHES["fused_mm"] == before + 1
    _check(y, st, *fc.fused_mm_reference(x, wt, s, b, True, norm, stride),
           dtype)
    again = fc.fused_mm(x, wt, s, b, True, norm, stride)
    assert torch.equal(y, again[0]) and torch.equal(st, again[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 5, 7, 24, 40), (6, 2, 2, 64, 64), (1, 56, 56, 64, 64),
    (3, 1, 3, 8, 72), (2, 3, 5, 130, 40),  # K = 1170: 3 slices
    (32, 2, 2, 512, 512)])                 # stage 3: 8 slices
def test_fused_c3_matches_plain(card, n, h, w, cin, cout, dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    y, st = fc.fused_c3(x, wt, s, b, True, True)
    _check(y, st, *fc.fused_c3_reference(x, wt, s, b, True, True), dtype)


# the four 3×3 calls of the ResNet50 path at batch 32 (N, H, W, Cin, Cout)
C3_PATH = [(32, 16, 16, 64, 64), (32, 8, 8, 128, 128), (32, 4, 4, 256, 256),
           (32, 2, 2, 512, 512)]


def _unaligned(t):
    """A contiguous copy of t that starts one element past 16 bytes."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,stage", [
    *[s + ("vec",) for s in C3_PATH],
    (1, 8, 8, 128, 128, "vec"),            # batch 1
    (3, 5, 7, 24, 40, "vec"),              # M = 105: no whole 64-row tile
    (2, 4, 6, 5, 16, "vec"),               # Cin % 8: 2-byte x staging
    (2, 4, 4, 16, 12, "vec"),              # Cout % 8: 2-byte W staging
    (2, 3, 3, 328, 24, "vec"),             # K = 2952: a cluster of 6
    (2, 2, 3, 600, 40, "vec"),             # K = 5400: 8 slices, the cap
    (2, 4, 4, 64, 64, "unaligned")])       # x one element off 16 bytes
def test_fused_c3_path_and_edge_shapes_match_plain_and_repeat(
        card, n, h, w, cin, cout, stage, dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    if stage == "unaligned":
        x = _unaligned(x)
    before = fc.LAUNCHES["fused_c3"]
    y, st = fc.fused_c3(x, wt, s, b, True, True)
    assert fc.LAUNCHES["fused_c3"] == before + 1
    _check(y, st, *fc.fused_c3_reference(x, wt, s, b, True, True), dtype)
    again = fc.fused_c3(x, wt, s, b, True, True)
    assert torch.equal(y, again[0]) and torch.equal(st, again[1])


@pytest.mark.parametrize("kernel,n,h,w,cin,cout,stride", [
    *[("fused_c3",) + c + (1,) for c in [(8, 4, 4, 32, 48),
                                         (8, 4, 4, 512, 48)] + C3_PATH],
    ("fused_mm", 8, 4, 4, 64, 256, 1), ("fused_mm", 8, 4, 4, 2048, 512, 1),
    ("fused_mm", 8, 8, 8, 1024, 2048, 2), ("fused_mm", 8, 9, 9, 1100, 70, 2),
    ("fused_mm", 8, 16, 16, 256, 128, 2)])
def test_rows_do_not_depend_on_the_batch(card, kernel, n, h, w, cin, cout,
                                         stride):
    """K's slices depend on K alone: the rows of a smaller (or padded)
    batch are the same bits as those of a bigger one."""
    shape_w = (cin, cout) if kernel == "fused_mm" else (3, 3, cin, cout)
    x, wt, s, b = _inputs(card, (8, h, w, cin), shape_w, torch.bfloat16)
    fn = getattr(fc, kernel)
    kw = {"stride": stride} if kernel == "fused_mm" else {}
    y8, _ = fn(x, wt, s, b, **kw)
    y3, _ = fn(x[:3].contiguous(), wt, s, b, **kw)
    assert torch.equal(y8[:3], y3)
    y1, _ = fn(x[5:6].contiguous(), wt, s, b, want_stats=False, **kw)
    assert torch.equal(y8[5:6], y1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_c3_border_is_zero_after_the_normalize(card, dtype):
    """With shift > 0, relu(x·scale + shift) is nonzero on the border's
    taps had the border been padded before the normalize; both kernels must
    match the plain versions (padding after), and a control that pads
    first must be outside the tolerance, so the check can see it."""
    import torch.nn.functional as F
    x, wt, s, b = _inputs(card, (4, 4, 4, 64), (3, 3, 64, 64), dtype)
    b = b.abs() + 0.5
    y, st = fc.fused_c3(x, wt, s, b)
    yr, sr = fc.fused_c3_reference(x, wt, s, b)
    _check(y, st, yr, sr, dtype)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    e = torch.relu(xp * s + b).to(dtype).float()            # padded first
    ctrl = F.conv2d(e.permute(0, 3, 1, 2), wt.float().permute(3, 2, 0, 1))
    ctrl = ctrl.permute(0, 2, 3, 1)
    assert (ctrl - yr.float()).abs().max() > 10 * (1e-2 if dtype ==
                                                   torch.bfloat16 else 1e-4)
    dy, yy, dst = _grad_inputs(card, x, 64, dtype)
    ref = fc.fused_c3_bwd_reference(dy, yy, x, wt, dst, s, b)
    _check_bwd(fc.fused_c3_bwd(dy, yy, x, wt, dst, s, b), ref, dtype)


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
    dy = torch.zeros((2, 4, 4, 8), device=card)
    with pytest.raises(TypeError):                 # dstats must be (2, Cout)
        fc.fused_mm_bwd(dy, dy, x, wt, torch.zeros(8, device=card), s, b)
    with pytest.raises(ValueError):                # dy of the wrong shape
        fc.fused_mm_bwd(dy[:1], dy, x, wt, torch.zeros((2, 8), device=card),
                        s, b)


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
    assert fc.LAUNCHES == {"fused_mm": 72, "fused_c3": 32,  # 2 batches
                           "fused_mm_bwd": 0, "fused_c3_bwd": 0,
                           "fused_c3_bwd_in": 0, "fused_c3_bwd_w": 0}
    np.testing.assert_array_equal(got, m.output(x).float().cpu().numpy())


@pytest.mark.parametrize("kernel", ["fused_mm", "fused_c3"])
def test_without_statistics(card, kernel):
    shape_w = (256, 96) if kernel == "fused_mm" else (3, 3, 256, 96)
    x, wt, s, b = _inputs(card, (4, 6, 6, 256), shape_w, torch.bfloat16)
    fn = getattr(fc, kernel)
    y, st = fn(x, wt, s, b, want_stats=False)
    assert st is None
    assert torch.equal(y, fn(x, wt, s, b)[0])


def _grad_inputs(card, x, cout, dtype, seed=1):
    """dy and y of x's plane with ``cout`` channels, and dstats."""
    g = torch.Generator(device=card).manual_seed(seed)
    shape = tuple(x.shape[:3]) + (cout,)
    return (torch.randn(shape, generator=g, device=card).to(dtype),
            torch.randn(shape, generator=g, device=card).to(dtype),
            0.1 * torch.randn((2, cout), generator=g, device=card))


def _check_bwd(got, ref, dtype):
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == r.dtype and a.shape == r.shape, i
        if i == 0:                                     # dx
            torch.testing.assert_close(a.float(), r.float(), rtol=tol,
                                       atol=tol * r.float().abs().max())
        else:                                          # f32 sums over M
            assert (a - r).abs().max() <= 1e-4 * r.abs().max() + 1e-5, i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,stride,norm", [
    (2, 5, 7, 24, 40, 1, True), (3, 9, 9, 64, 130, 2, False),
    (4, 16, 16, 256, 64, 1, True),         # M = 1024: dW in M slices
    (2, 3, 3, 1100, 70, 1, True),          # Cin, Cout % 8: 2-byte staging
    (3, 9, 9, 24, 40, 2, True),            # normalize on a stride-2 grid
    *MM_PATH,
    (128, 16, 16, 64, 256, 1, True)])      # M = 32768 at the train batch
def test_fused_mm_bwd_matches_plain(card, n, h, w, cin, cout, stride, norm,
                                    dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (cin, cout), dtype)
    dy, y, dst = _grad_inputs(card, x[:, ::stride, ::stride], cout, dtype)
    # leave NaN in the caching allocator's free block the kernel's dx will
    # most likely reuse, so a pixel off the stride grid that the kernel
    # does not write cannot pass as zero
    torch.full_like(x, float("nan"))
    before = fc.LAUNCHES["fused_mm_bwd"]
    got = fc.fused_mm_bwd(dy, y, x, wt, dst, s, b, True, norm, stride)
    assert fc.LAUNCHES["fused_mm_bwd"] == before + 1
    _check_bwd(got, fc.fused_mm_bwd_reference(dy, y, x, wt, dst, s, b, True,
                                              norm, stride), dtype)
    if stride != 1:                 # off the stride grid dx stays zero
        off = got[0].clone()
        off[:, ::stride, ::stride] = 0
        assert not off.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 5, 7, 24, 40), (3, 1, 3, 8, 72), (32, 16, 16, 64, 64),
    (32, 2, 2, 512, 512)])
def test_fused_c3_bwd_routes_match_plain(card, n, h, w, cin, cout, dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    dy, y, dst = _grad_inputs(card, x, cout, dtype)
    ref = fc.fused_c3_bwd_reference(dy, y, x, wt, dst, s, b)
    _check_bwd(fc.fused_c3_bwd(dy, y, x, wt, dst, s, b), ref, dtype)
    dx, dsc, dsh = fc.fused_c3_bwd_in(dy, y, x, wt, dst, s, b)
    dw = fc.fused_c3_bwd_w(dy, y, x, dst, s, b)
    _check_bwd((dx, dw, dsc, dsh), ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout", [
    (32, 2, 2, 512, 512),       # stage 4 at the kernels phase's batch
    (128, 2, 2, 512, 512),      # and at the train phase's
    (3, 3, 5, 520, 72)])        # M, Cin and 9·Cout fit no tile or slice
def test_fused_c3_bwd_in_matches_plain_and_repeats(card, n, h, w, cin, cout,
                                                  dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    dy, y, dst = _grad_inputs(card, x, cout, dtype)
    before = fc.LAUNCHES["fused_c3_bwd_in"]
    got = fc.fused_c3_bwd_in(dy, y, x, wt, dst, s, b)
    assert fc.LAUNCHES["fused_c3_bwd_in"] == before + 1
    _check_bwd(got, fc.fused_c3_bwd_in_reference(dy, y, x, wt, dst, s, b),
               dtype)
    again = fc.fused_c3_bwd_in(dy, y, x, wt, dst, s, b)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout,shift,norm", [
    (13, 0, True),              # Cout % 8 != 0: 2-byte staging
    (64, 1, True),              # dy and y one element off 16 bytes
    (40, 0, False)])            # no normalize: dx = de, no sums
def test_fused_c3_bwd_in_scalar_staging_matches_plain(card, cout, shift,
                                                      norm, dtype):
    x, wt, s, b = _inputs(card, (4, 3, 6, 24), (3, 3, 24, cout), dtype)
    dy0, y0, dst = _grad_inputs(card, x, cout, dtype)
    if shift:
        dy, y = (torch.empty(t.numel() + shift, dtype=dtype, device=card)
                 [shift:].view(t.shape).copy_(t) for t in (dy0, y0))
    else:
        dy, y = dy0, y0
    got = fc.fused_c3_bwd_in(dy, y, x, wt, dst, s, b, True, norm)
    _check_bwd(got, fc.fused_c3_bwd_in_reference(dy0, y0, x, wt, dst, s, b,
                                                 True, norm), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,cin,cout,stage", [
    *[s + ("vec",) for s in C3_PATH],
    *[(128,) + s[1:] + ("vec",) for s in C3_PATH[:3]],   # train batch
    (1, 8, 8, 128, 128, "vec"),            # batch 1
    (3, 5, 7, 24, 40, "vec"),              # M = 105: no whole 64-row tile
    (2, 4, 6, 5, 16, "vec"),               # Cin % 8: 2-byte x staging
    (4, 3, 6, 24, 13, "vec"),              # Cout % 8: 2-byte dyc staging
    (2, 4, 4, 64, 64, "unaligned")])       # x, dy, y one element off
def test_fused_c3_bwd_matches_plain_and_repeats(card, n, h, w, cin, cout,
                                               stage, dtype):
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout), dtype)
    dy, y, dst = _grad_inputs(card, x, cout, dtype)
    if stage == "unaligned":
        x, dy, y = _unaligned(x), _unaligned(dy), _unaligned(y)
    before = fc.LAUNCHES["fused_c3_bwd"]
    got = fc.fused_c3_bwd(dy, y, x, wt, dst, s, b)
    assert fc.LAUNCHES["fused_c3_bwd"] == before + 1
    _check_bwd(got, fc.fused_c3_bwd_reference(dy, y, x, wt, dst, s, b),
               dtype)
    again = fc.fused_c3_bwd(dy, y, x, wt, dst, s, b)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    nn = fc.fused_c3_bwd(dy, y, x, wt, dst, s, b, True, False)   # no norm
    _check_bwd(nn, fc.fused_c3_bwd_reference(dy, y, x, wt, dst, s, b, True,
                                             False), dtype)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    *C3_PATH, *[(128,) + s[1:] for s in C3_PATH],
    (2, 4, 6, 5, 16)])                     # Cin % 8: 2-byte x staging
def test_fused_c3_bwd_w_bf16_matches_plain_and_repeats(card, n, h, w, cin,
                                                      cout):
    """The bf16 split route's dW (tensor-core tiles over pixel slices) at
    the four 3×3 path shapes at batch 32 and 128; NaN left in the output's
    block, bitwise on a repeat."""
    x, wt, s, b = _inputs(card, (n, h, w, cin), (3, 3, cin, cout),
                          torch.bfloat16)
    dy, y, dst = _grad_inputs(card, x, cout, torch.bfloat16)
    ref = fc.fused_c3_bwd_w_reference(dy, y, x, dst, s, b)
    size = fc.c3_bwd_w_plan(n * h * w, cin, cout).size
    _poison(((size,), torch.float32), device=card)
    before = fc.LAUNCHES["fused_c3_bwd_w"]
    got = fc.fused_c3_bwd_w(dy, y, x, dst, s, b)
    assert fc.LAUNCHES["fused_c3_bwd_w"] == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-5
    _poison(((size,), torch.float32), device=card)
    assert torch.equal(got, fc.fused_c3_bwd_w(dy, y, x, dst, s, b))
    nn = fc.fused_c3_bwd_w(dy, y, x, dst, s, b, True, False)    # no norm
    ref = fc.fused_c3_bwd_w_reference(dy, y, x, dst, s, b, True, False)
    assert (nn - ref).abs().max() <= 1e-4 * ref.abs().max() + 1e-5


@pytest.mark.parametrize("kernel", ["fused_c3_bwd", "fused_mm_bwd"])
def test_backward_is_deterministic(card, kernel):
    """Three calls give the same bits: the 3×3 one-call backward, and the
    1×1 at the stage-3 projection (dx depth in 8 cluster slices) and at
    batch 128's first stage (dW in 64 pixel slices, 512 row tiles of
    sums)."""
    if kernel == "fused_c3_bwd":
        cases = [((32, 8, 8, 128), (3, 3, 128, 128), 1, True)]
    else:
        cases = [((32, 4, 4, 1024), (1024, 2048), 2, False),
                 ((128, 16, 16, 64), (64, 256), 1, True)]
    for shape_x, shape_w, stride, norm in cases:
        x, wt, s, b = _inputs(card, shape_x, shape_w, torch.bfloat16)
        dy, y, dst = _grad_inputs(card, x[:, ::stride, ::stride],
                                  shape_w[-1], torch.bfloat16)
        fn = getattr(fc, kernel)
        kw = {"stride": stride} if kernel == "fused_mm_bwd" else {}
        runs = [fn(dy, y, x, wt, dst, s, b, True, norm, **kw)
                for _ in range(3)]
        for r in runs[1:]:
            assert all(torch.equal(a, c) for a, c in zip(runs[0], r))


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_mm_unaligned_inputs_stage_with_2_byte_loads(card, stride):
    """x (and dy, y) one element off 16 bytes: both 1×1 kernels take their
    2-byte staging and still match the plain versions."""
    x0, wt, s, b = _inputs(card, (4, 6, 6, 64), (64, 96), torch.bfloat16)
    dy0, y0, dst = _grad_inputs(card, x0[:, ::stride, ::stride], 96,
                                torch.bfloat16)
    x, dy, y = _unaligned(x0), _unaligned(dy0), _unaligned(y0)
    _check(*fc.fused_mm(x, wt, s, b, True, True, stride),
           *fc.fused_mm_reference(x0, wt, s, b, True, True, stride),
           torch.bfloat16)
    _check_bwd(fc.fused_mm_bwd(dy, y, x, wt, dst, s, b, True, True, stride),
               fc.fused_mm_bwd_reference(dy0, y0, x0, wt, dst, s, b, True,
                                         True, stride), torch.bfloat16)


def test_train_steps_on_the_card_launch_every_kernel(card):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    m = ResNet50(num_classes=10, height=32, width=32, fused_blocks=True,
                 s2d_stem=True, compute_dtype="bfloat16").init()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    fc.reset_launch_counts()
    m.fit(DataSet(x, y))
    assert fc.LAUNCHES == {"fused_mm": 36, "fused_c3": 16,
                           "fused_mm_bwd": 36, "fused_c3_bwd": 13,
                           "fused_c3_bwd_in": 3, "fused_c3_bwd_w": 3}
    assert m.iteration == 1 and np.isfinite(m.score())
    assert all(v.dtype == torch.float32 and v.is_cuda
               for lp in m.params.values() for v in lp.values())


# ---- the fused LSTM kernels (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu) --------
# Kernel vs plain version on the card, relative to the largest reference
# magnitude: float32 1e-4 (the same f32 products summed in other orders,
# carried through the recurrence); bfloat16 outputs 3e-2 (a sum-order
# difference can flip one bf16 rounding of h, about 4e-3 at |h| < 1,
# and the flipped value feeds every later tick).
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _lstm_inputs(card, t, n, h, dtype, masked, seed=0):
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    g = torch.Generator(device=card).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=card)
    zx = r(t, n, 4 * h).to(dtype)
    wh = (r(h, 4 * h) / h ** 0.5).to(dtype)
    h0, c0 = r(n, h).to(dtype), r(n, h).to(dtype)
    mask3 = ((torch.rand(t, n, 1, generator=g, device=card) > 0.2)
             .to(dtype) if masked else None)
    return fl, zx, h0, c0, wh, mask3


def _lstm_close(got, ref, dtype):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = LSTM_TOL[dtype] * max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,n,h", [(7, 4, 8), (5, 3, 40), (9, 300, 48),
                                   (60, 128, 256)])
def test_lstm_fwd_matches_plain(card, t, n, h, masked, dtype):
    fl, zx, h0, c0, wh, mask3 = _lstm_inputs(card, t, n, h, dtype, masked)
    before = fl.LAUNCHES["lstm_fwd"]
    got = fl.lstm_fwd(zx, h0, c0, wh, mask3)
    assert fl.LAUNCHES["lstm_fwd"] == before + 1
    _lstm_close(got, fl.lstm_fwd_reference(zx, h0, c0, wh, mask3), dtype)
    again = fl.lstm_fwd(zx, h0, c0, wh, mask3)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,n,h", [(7, 4, 8), (5, 3, 40), (9, 300, 48),
                                   (60, 128, 256)])
def test_lstm_bwd_matches_plain(card, t, n, h, masked, dtype):
    fl, zx, h0, c0, wh, mask3 = _lstm_inputs(card, t, n, h, dtype, masked)
    ys, gates, tcs, ccs, _, _ = fl.lstm_fwd_reference(zx, h0, c0, wh, mask3)
    g = torch.Generator(device=card).manual_seed(1)
    dys = torch.randn(ys.shape, generator=g, device=card).to(dtype)
    dhT, dcT = (torch.randn(h0.shape, generator=g, device=card).to(dtype)
                for _ in range(2))
    hprev = torch.cat([h0[None], ys[:-1]])
    cprev = torch.cat([c0[None], ccs[:-1]])
    args = (dys, dhT, dcT, gates, tcs, cprev, hprev, mask3, wh)
    got = fl.lstm_bwd(*args)
    _lstm_close(got, fl.lstm_bwd_reference(*args), dtype)
    again = fl.lstm_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _poison(*shapes_dtypes, device):
    """Leave NaN in the caching allocator's free blocks of these sizes, so
    an output element the kernel does not write cannot pass."""
    for shape, dtype in shapes_dtypes:
        torch.full(shape, float("nan"), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,n,h", [
    (1, 5, 20),                 # T = 1: one tick, the dWh depth one row tile
    (4, 129, 256),              # N = 129: 15 row tiles of 9, the last short
    (3, 50, 200),               # H = 200: the last of 7 slices has 8 of 32
    (6, 7, 10),                 # H % 4 != 0: element-wise staging
    (60, 128, 256),             # the slice shape: dWh in 2 depth slices
    (128, 256, 512),            # the kernels phase's benchmark geometry
    (3, 600, 520)])             # rows 600 (f32) and 300 (bf16) a block: the
                                # mask rows past the block's 256 threads
def test_lstm_bwd_plan_edges_match_plain_and_repeat(card, t, n, h, masked,
                                                    dtype):
    fl, zx, h0, c0, wh, mask3 = _lstm_inputs(card, t, n, h, dtype, masked)
    ys, gates, tcs, ccs, _, _ = fl.lstm_fwd_reference(zx, h0, c0, wh, mask3)
    g = torch.Generator(device=card).manual_seed(1)
    dys = torch.randn(ys.shape, generator=g, device=card).to(dtype)
    dhT, dcT = (torch.randn(h0.shape, generator=g, device=card).to(dtype)
                for _ in range(2))
    hprev = torch.cat([h0[None], ys[:-1]])
    cprev = torch.cat([c0[None], ccs[:-1]])
    args = (dys, dhT, dcT, gates, tcs, cprev, hprev, mask3, wh)
    ref = fl.lstm_bwd_reference(*args)
    outs = [((t, n, 4 * h), dtype), ((h, 4 * h), torch.float32),
            ((n, h), dtype), ((n, h), dtype)]
    _poison(*outs, device=card)
    before = fl.LAUNCHES["lstm_bwd"]
    got = fl.lstm_bwd(*args)
    assert fl.LAUNCHES["lstm_bwd"] == before + 1
    _lstm_close(got, ref, dtype)
    _poison(*outs, device=card)
    again = fl.lstm_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _lstm_fwd_close(got, ref, dtype):
    """Each output against the plain version within LSTM_TOL: float32's
    where zx and the output are both float32, else bfloat16's (hT and cT
    in a bf16 state are one rounding to bf16 of f32 values that agree to
    1e-4, which a last-bit difference can flip; in an f32 state after a
    bf16 recurrence they carry its flipped roundings of h)."""
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        bf16 = torch.bfloat16 in (a.dtype, dtype)
        tol = LSTM_TOL[torch.bfloat16 if bf16 else torch.float32] * max(
            1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol


def _lstm_fwd_once_and_again(fl, card, args, state):
    """Two launches on NaN-poisoned outputs; both hold one launch, the
    second gives the first's bits."""
    zx, h0, c0, wh, mask3 = args
    t, n, g4 = zx.shape
    seq = ((t, n, g4 // 4), zx.dtype)
    outs = [seq, ((t, n, g4), zx.dtype), seq, seq, ((n, g4 // 4), state),
            ((n, g4 // 4), state)]
    _poison(*outs, device=card)
    before = fl.LAUNCHES["lstm_fwd"]
    got = fl.lstm_fwd(*args)
    assert fl.LAUNCHES["lstm_fwd"] == before + 1
    _poison(*outs, device=card)
    again = fl.lstm_fwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("state", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t,n,h", [
    (1, 1, 256),                # T = 1, N = 1: one generated char
    (4, 129, 256),              # N = 129: 8 clusters of 17 rows, the last 10
    (3, 50, 200),               # H = 200: 13 slices of 16, the last 8 of 16
    (6, 7, 10),                 # H % 4 != 0: element-wise copies
    (60, 128, 256),             # the slice shape
    (128, 256, 512),            # the kernels phase's benchmark geometry
    (3, 600, 520)])             # the grid route with 300 (f32) and 150
                                # (bf16) rows a block: mask rows past the
                                # block's 256 threads
def test_lstm_fwd_plan_edges_match_plain_and_repeat(card, t, n, h, masked,
                                                    dtype, state):
    fl, zx, h0, c0, wh, mask3 = _lstm_inputs(card, t, n, h, dtype, masked)
    args = (zx, h0.to(state), c0.to(state), wh, mask3)
    ref = fl.lstm_fwd_reference(*args)
    _lstm_fwd_close(_lstm_fwd_once_and_again(fl, card, args, state), ref,
                    dtype)


@pytest.mark.parametrize("shape,dtype,route", [
    ((7, 4, 8), torch.float32, ("cluster", 1)),
    ((6, 7, 10), torch.bfloat16, ("cluster", 2)),
    ((1, 5, 20), torch.float32, ("cluster", 3)),
    ((5, 8, 32), torch.bfloat16, ("cluster", 4)),
    ((5, 15, 64), torch.float32, ("cluster", 8)),
    ((3, 50, 200), torch.bfloat16, ("cluster", 13)),
    ((60, 128, 256), torch.bfloat16, ("cluster", 16)),
    ((60, 128, 256), torch.float32, ("grid", 8)),
    ((3, 2, 1000), torch.bfloat16, ("grid", 125))], ids=lambda v: str(v))
def test_lstm_fwd_runs_the_route_its_plan_picks(card, shape, dtype, route):
    """One shape for each cluster size and route the plan picks on a
    132-SM H100 (tests/test_torch_bwd_plans.py holds the plans), each run
    through the wrapper, which counts the route it launched."""
    t, n, h = shape
    fl, zx, h0, c0, wh, mask3 = _lstm_inputs(card, t, n, h, dtype, True)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    plan = fl.lstm_fwd_plan(t, n, h, dtype == torch.bfloat16, sms)
    assert (plan.route, plan.slices) == route
    routes = dict(fl.FWD_ROUTES)
    args = (zx, h0, c0, wh, mask3)
    got = _lstm_fwd_once_and_again(fl, card, args, dtype)
    assert fl.FWD_ROUTES[route] == routes.get(route, 0) + 2
    _lstm_fwd_close(got, fl.lstm_fwd_reference(*args), dtype)


def test_lstm_model_on_the_card_launches_both_kernels(card):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    m = TextGenerationLSTM(vocab_size=11, timesteps=9, lstm_units=32).init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 11, (6, 10))
    eye = np.eye(11, dtype=np.float32)
    fl.reset_launch_counts()
    probs = m.output(eye[ids[:, :9]])
    assert fl.LAUNCHES == {"lstm_fwd": 2, "lstm_bwd": 0}
    _, carries = m.rnn_time_step(eye[ids[:, 0]])
    assert fl.LAUNCHES == {"lstm_fwd": 4, "lstm_bwd": 0}
    m.fit(DataSet(eye[ids[:, :9]], eye[ids[:, 1:]]))
    assert fl.LAUNCHES == {"lstm_fwd": 6, "lstm_bwd": 2}
    assert probs.is_cuda and probs.shape == (6, 9, 11)
    assert np.isfinite(m.score()) and set(carries) == {"layer_0", "layer_1"}


# ---- the flash attention kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) --
# Kernel vs plain version on the card, relative to max(1, the largest
# reference magnitude): float32 2e-5 (tests/test_pallas_kernels.py's bound:
# the same f32 products summed in another order); bfloat16 2^-7, one bf16
# ulp at the largest magnitude (the same f32 values, then one rounding that
# a last-bit difference can flip).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -7}
FLASH_SHAPES = [(2, 37, 3, 16), (2, 130, 2, 64), (1, 64, 1, 128),
                (3, 200, 2, 4), (2, 5, 2, 100)]


def _flash_inputs(card, n, t, h, dh, dtype, masked, seed=0):
    """q, k, v as the strided views of one packed (N, T, H, 3, Dh)
    projection (as SelfAttentionLayer cuts them), a key mask with one
    fully masked batch row, and dO."""
    g = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn((n, t, h, 3, dh), generator=g, device=card).to(dtype)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=g, device=card) > 0.3).float()
        mask[-1] = 0.0
    do = torch.randn((n, t, h, dh), generator=g, device=card).to(dtype)
    return q, k, v, mask, do


def _flash_close(got, ref, dtype):
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        tol = FLASH_TOL[dtype] * max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,t,h,dh", FLASH_SHAPES)
def test_flash_kernels_match_plain(card, n, t, h, dh, masked, causal,
                                   dtype):
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, mask, do = _flash_inputs(card, n, t, h, dh, dtype, masked)
    before = dict(fa.LAUNCHES)
    out, lse = fa.flash_fwd(q, k, v, mask, causal)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, mask, causal)
    _flash_close((out,), (ref_out,), dtype)
    assert (lse - ref_lse).abs().max().item() <= 2e-5 * max(
        1.0, ref_lse.abs().max().item())
    delta = fa.attention_delta(do, ref_out)
    args = (q, k, v, mask, do, ref_lse, delta, causal)
    dkv = fa.flash_bwd_dkv(*args)
    dq = fa.flash_bwd_dq(*args)
    _flash_close(dkv, fa.flash_bwd_dkv_reference(*args), dtype)
    _flash_close((dq,), (fa.flash_bwd_dq_reference(*args),), dtype)
    assert {k_: fa.LAUNCHES[k_] - before[k_] for k_ in fa.LAUNCHES} == {
        "flash_fwd": 1, "flash_bwd_dkv": 1, "flash_bwd_dq": 1}
    # a second call gives the same bits
    assert all(torch.equal(a, b) for a, b in
               zip((out, lse), fa.flash_fwd(q, k, v, mask, causal)))
    assert all(torch.equal(a, b) for a, b in
               zip(dkv + (dq,), fa.flash_bwd_dkv(*args)
                   + (fa.flash_bwd_dq(*args),)))
    if masked:
        assert not out[-1].any() and (lse[-1] == fa._NEG).all()


@pytest.mark.parametrize("n", [64, 32])       # served and trained BERT
def test_flash_fwd_bert_shapes_bf16(card, n):
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, _, _ = _flash_inputs(card, n, 128, 12, 64, torch.bfloat16,
                                  False)
    assert fa.vector_loads(q, k, v)
    out, lse = fa.flash_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v)
    _flash_close((out,), (ref_out,), torch.bfloat16)
    assert (lse - ref_lse).abs().max().item() <= 2e-5 * max(
        1.0, ref_lse.abs().max().item())
    assert all(torch.equal(a, b) for a, b in
               zip((out, lse), fa.flash_fwd(q, k, v)))


@pytest.mark.parametrize("n", [32, 64])       # trained BERT, and twice it
def test_flash_bwd_bert_shapes_bf16(card, n):
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, _, do = _flash_inputs(card, n, 128, 12, 64, torch.bfloat16,
                                   False)
    assert fa.vector_loads(q, k, v, do)
    ref_out, lse = fa.flash_fwd_reference(q, k, v)
    args = (q, k, v, None, do, lse, fa.attention_delta(do, ref_out))
    got = fa.flash_bwd_dkv(*args) + (fa.flash_bwd_dq(*args),)
    _flash_close(got, fa.flash_bwd_dkv_reference(*args)
                 + (fa.flash_bwd_dq_reference(*args),), torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in
               zip(got, fa.flash_bwd_dkv(*args) + (fa.flash_bwd_dq(*args),)))


def _bf16_ulps(got, ref):
    """|got − ref| in bf16 ulps of |ref|, elementwise, with |ref| floored
    at 2^-8 of its largest magnitude (below that an ulp is finer than the
    f32 sums' own rounding)."""
    r = ref.float()
    a = torch.maximum(r.abs(), r.abs().max() * 2.0 ** -8)
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)
    return (got.float() - r).abs() / ulp


def test_flash_fwd_bf16_keeps_p_at_f32_accuracy(card):
    """The bf16 kernel adds p·V with p = hi + lo in bf16 (f32 accuracy):
    each output is within one bf16 ulp of the plain version's (f32
    arithmetic on the same bf16 inputs, rounded once). A control that
    rounds p to bf16 once, as a kernel without the lo products would, must
    exceed that limit, so the check can see the difference."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, _, _ = _flash_inputs(card, 64, 128, 12, 64, torch.bfloat16,
                                  False)
    out, _ = fa.flash_fwd(q, k, v)
    ref, _ = fa.flash_fwd_reference(q, k, v)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    s = qf @ kf.transpose(-1, -2) / 8.0
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    control = ((p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True)
               ).permute(0, 2, 1, 3).to(torch.bfloat16)
    kernel_ulps = _bf16_ulps(out, ref).max().item()
    control_ulps = _bf16_ulps(control, ref).max().item()
    print(f"flash_fwd bf16 (64, 128, 12, 64): max |out - ref| {kernel_ulps}"
          f" ulp; p rounded to bf16 once: {control_ulps} ulp")
    assert kernel_ulps <= 1.0
    assert control_ulps > 1.0


def test_flash_bwd_bf16_keeps_p_and_ds_at_f32_accuracy(card):
    """The bf16 backward adds P^T dO, dS^T Q and dS K with p and dS as
    hi + lo in bf16 (f32 accuracy): dk, dv and dq are each within one bf16
    ulp of the plain version's (f32 arithmetic on the same bf16 inputs,
    rounded once). A control that rounds p and dS to bf16 once, as a
    kernel without the lo products would, must exceed that limit on at
    least one of the three, so the check can see the difference."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, _, do = _flash_inputs(card, 64, 128, 12, 64, torch.bfloat16,
                                   False)
    ref_out, lse = fa.flash_fwd_reference(q, k, v)
    delta = fa.attention_delta(do, ref_out)
    args = (q, k, v, None, do, lse, delta)
    got = fa.flash_bwd_dkv(*args) + (fa.flash_bwd_dq(*args),)
    ref = fa.flash_bwd_dkv_reference(*args) + (
        fa.flash_bwd_dq_reference(*args),)
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    p = torch.exp(qf @ kf.transpose(-1, -2) / 8.0 - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None]) / 8.0
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    control = tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16) for t in (
        dsb.transpose(-1, -2) @ qf, pb.transpose(-1, -2) @ dof, dsb @ kf))
    kernel_ulps = [_bf16_ulps(a, r).max().item() for a, r in zip(got, ref)]
    control_ulps = [_bf16_ulps(a, r).max().item()
                    for a, r in zip(control, ref)]
    print(f"flash_bwd bf16 (64, 128, 12, 64): max |(dk, dv, dq) - ref| "
          f"{kernel_ulps} ulp; p and dS rounded to bf16 once: "
          f"{control_ulps} ulp")
    assert max(kernel_ulps) <= 1.0
    assert max(control_ulps) > 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_unaligned_views_stage_with_2_byte_loads(card, causal):
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    n, t, h, dh = 2, 130, 3, 64
    g = torch.Generator(device=card).manual_seed(3)
    buf = torch.randn(1 + n * t * h * 3 * dh, generator=g, device=card)
    qkv = buf.to(torch.bfloat16)[1:].view(n, t, h, 3, dh)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    assert not fa.vector_loads(q, k, v)
    out, lse = fa.flash_fwd(q, k, v, None, causal)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, None, causal)
    _flash_close((out,), (ref_out,), torch.bfloat16)
    assert (lse - ref_lse).abs().max().item() <= 2e-5 * max(
        1.0, ref_lse.abs().max().item())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shifted", ["qkv", "do"])
def test_flash_bwd_unaligned_views_stage_with_2_byte_loads(card, shifted,
                                                           causal):
    # the packed projection (or dO alone) one element off 16 bytes
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    n, t, h, dh = 2, 130, 3, 64
    g = torch.Generator(device=card).manual_seed(3)
    off = (1, 0) if shifted == "qkv" else (0, 1)
    buf = torch.randn(off[0] + n * t * h * 3 * dh, generator=g, device=card)
    qkv = buf.to(torch.bfloat16)[off[0]:].view(n, t, h, 3, dh)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    dbuf = torch.randn(off[1] + n * t * h * dh, generator=g, device=card)
    do = dbuf.to(torch.bfloat16)[off[1]:].view(n, t, h, dh)
    assert not fa.vector_loads(q, k, v, do)
    assert fa.vector_loads(q, k, v) is (shifted == "do")
    ref_out, lse = fa.flash_fwd_reference(q, k, v, None, causal)
    args = (q, k, v, None, do, lse, fa.attention_delta(do, ref_out), causal)
    _flash_close(fa.flash_bwd_dkv(*args) + (fa.flash_bwd_dq(*args),),
                 fa.flash_bwd_dkv_reference(*args)
                 + (fa.flash_bwd_dq_reference(*args),), torch.bfloat16)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, _, _ = _flash_inputs(card, 1, 8, 1, 16, torch.float32, False)
    with pytest.raises(ValueError, match="Dh"):
        big = torch.zeros((1, 8, 1, 129), device=card)
        fa.flash_fwd(big, big, big)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous last"):
        t = torch.zeros((1, 8, 1, 32), device=card)[..., ::2]
        fa.flash_fwd(t, t, t)
    with pytest.raises(ValueError, match="mask"):
        fa.flash_fwd(q, k, v, torch.ones((1, 8), device=card,
                                         dtype=torch.bfloat16))


def test_attention_layers_on_the_card_launch_every_flash_kernel(card):
    from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        TransformerEncoderBlock
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    block = TransformerEncoderBlock(n_in=64, n_out=64, n_heads=4)
    params = {k: v.to(card).requires_grad_() if not isinstance(v, dict)
              else {kk: vv.to(card).requires_grad_() for kk, vv in v.items()}
              for k, v in block.initialize(torch.Generator().manual_seed(0),
                                           RecurrentType(64, 20)).items()}
    x = torch.randn((3, 20, 64), device=card)
    mask = torch.ones((3, 20), device=card)
    mask[1, 12:] = 0.0
    fa.reset_launch_counts()
    y, _ = block.apply(params, {}, x, LayerContext(mask=mask))
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkv": 0,
                           "flash_bwd_dq": 0}
    y.sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                           "flash_bwd_dq": 1}
    assert params["attn"]["Wqkv"].grad is not None
    assert not y[1, 12:].any()


def test_transformer_stack_on_the_card_trains_through_the_kernels(card):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-3))
            .compute_dtype("bfloat16").list()
            .layer(EmbeddingSequenceLayer(n_in=50, n_out=64))
            .layer(LearnedPositionalEmbedding(max_len=24))
            .layer(TransformerEncoderBlock(n_out=64, n_heads=4))
            .layer(TransformerEncoderBlock(n_out=64, n_heads=4))
            .layer(RnnOutputLayer(n_out=50))
            .set_input_type(InputType.recurrent(1, 24)).build())
    m = MultiLayerNetwork(conf).init()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (4, 24))
    y = np.eye(50, dtype=np.float32)[rng.integers(0, 50, (4, 24))]
    fa.reset_launch_counts()
    probs = m.output(ids)
    assert fa.LAUNCHES["flash_fwd"] == 2 and probs.is_cuda
    m.fit(DataSet(ids, y))
    assert fa.LAUNCHES == {"flash_fwd": 4, "flash_bwd_dkv": 2,
                           "flash_bwd_dq": 2}
    assert np.isfinite(m.score())


def _staged_batches(feeder):
    """The feeder's items as host arrays, after each hand-off."""
    out = []
    for item in feeder:
        item = feeder.hand_off(item)
        out.append(tuple(None if t is None else t.cpu().numpy()
                         for t in item[:4]) + (item.k,))
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_feeder_stages_to_the_card_what_the_cpu_path_yields(card, k):
    """Pinned slots, the side stream and the hand-off: every staged
    batch on the card equals the CPU path's (ragged tail padded when
    k > 1), over two passes of one feeder (its slot ring wraps)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.feeder import DeviceFeeder
    rng = np.random.default_rng(0)
    data = DataSet(rng.normal(size=(250, 7)).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.integers(0, 3, 250)])
    it = lambda: ArrayDataSetIterator(data, 32, shuffle=True, seed=5)
    on_card = DeviceFeeder(it(), device=card, k_steps=k)
    on_cpu = DeviceFeeder(it(), device="cpu", k_steps=k)
    for _ in range(2):
        got, want = _staged_batches(on_card), _staged_batches(on_cpu)
        assert on_card.transport is not None and on_cpu.transport is None
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[4] == w[4]
            for a, b in zip(g[:4], w[:4]):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


def test_evaluate_on_the_card_matches_the_cpu(card):
    """The pretrained LeNet evaluated on the card and on the CPU: the
    same confusion matrix, probabilities within 1e-5 of each row's
    largest."""
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    gpu = LeNet().init_pretrained(flavor="digits", device=card)
    cpu = LeNet().init_pretrained(flavor="digits", device="cpu")
    it = lambda: DigitsDataSetIterator(64, train=False, shuffle=False)
    eg, ec = gpu.evaluate(it()), cpu.evaluate(it())
    np.testing.assert_array_equal(eg.confusion_matrix(),
                                  ec.confusion_matrix())
    assert eg.accuracy() >= 0.98
    x, _ = DigitsDataSetIterator.fetch(train=False)
    p, q = gpu.output(x).cpu().numpy(), cpu.output(x).numpy()
    assert (np.abs(p - q).max(1) / q.max(1)).max() <= 1e-5


def _small_textgen(card):
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    return TextGenerationLSTM(vocab_size=31, timesteps=8,
                              lstm_units=32).init(device=card)


def test_generation_engine_greedy_on_the_card_matches_reference_decode(
        card):
    """The engine's staggered greedy streams at 4 slots on the card
    against ``reference_decode`` (the ``lstm_fwd`` kernel path): equal up
    to the oracle's first near tie (top-2 probability gap < 1e-4), the
    bound of chip_smoke.py's lstm_serve and generate phases."""
    import random
    from deeplearning4j_tpu_torch.generation import (GenerationEngine,
                                                     reference_decode)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    model = _small_textgen(card)
    eng = GenerationEngine(model, max_slots=4, registry=MetricsRegistry())
    try:
        rng = random.Random(99)
        cfgs = [([rng.randrange(31) for _ in range(rng.randrange(2, 7))],
                 rng.randrange(10, 30)) for _ in range(8)]
        streams = [eng.submit(p, max_new_tokens=m) for p, m in cfgs]
        eye = torch.eye(31, device=card)
        for (p, m), s in zip(cfgs, streams):
            got = s.result(timeout=120)["ids"]
            ref = reference_decode(model, p, m)
            probs, _ = model.rnn_time_step(eye[p + ref[:-1]][None])
            top2 = probs[0, len(p) - 1:].topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            tie = int(np.argmax(gaps < 1e-4)) if (gaps < 1e-4).any() \
                else len(ref)
            assert got[:tie] == ref[:tie]
        eng.assert_warm()
        assert eng.stats()["device"].startswith("cuda")
    finally:
        eng.shutdown()


def test_generation_stream_does_not_depend_on_its_bucket(card):
    """A seeded sampled stream alone at bucket 1 equals the same request
    among three co-residents at bucket 4, bit for bit."""
    from deeplearning4j_tpu_torch.generation import GenerationEngine
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    eng = GenerationEngine(_small_textgen(card), max_slots=4,
                           stop_text=None, registry=MetricsRegistry())
    try:
        kw = dict(greedy=False, temperature=0.8, top_k=10, seed=3,
                  max_new_tokens=40)
        alone = eng.submit([1, 2, 3], **kw).result(timeout=120)["ids"]
        others = [eng.submit([j], greedy=False, seed=j, max_new_tokens=60)
                  for j in range(3)]
        crowd = eng.submit([1, 2, 3], **kw).result(timeout=120)["ids"]
        for s in others:
            s.result(timeout=120)
        assert eng.stats()["slots"]["max_active"] == 4
        assert alone == crowd
    finally:
        eng.shutdown()


@pytest.mark.parametrize("k", [256, 1040, 4608])
def test_int8_dot_on_the_card_is_exact(card, k):
    """``int8_dot`` on the card: the int32 accumulator equals the int64
    CPU product exactly at any K (chunks of at most 1040 summed exactly
    in f32, added in int32), and the rescaled result equals the CPU
    route's bit for bit; TF32 raises."""
    from deeplearning4j_tpu_torch.ops.quantize import (_int_matmul,
                                                       int8_dot,
                                                       quantize_act)
    g = torch.Generator().manual_seed(k)
    x = torch.rand((8, k), generator=g) * 2 - 1
    wq = torch.randint(-127, 128, (k, 77), generator=g, dtype=torch.int8)
    wq[:, 0] = 127                       # a column at the extreme
    x[0] = 1.0
    ws = torch.rand(77, generator=g) * 0.01
    xs = torch.tensor(1.0 / 127)
    got = int8_dot(x.to(card), wq.to(card), ws.to(card), xs.to(card))
    acc = _int_matmul(quantize_act(x.to(card), xs.to(card)).float(),
                      wq.to(card).float()).cpu()
    exact = quantize_act(x, xs).long() @ wq.long()
    assert acc.dtype == torch.int32 and torch.equal(acc.long(), exact)
    assert torch.equal(got.cpu(), int8_dot(x, wq, ws, xs))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            int8_dot(x.to(card), wq.to(card), ws.to(card), xs.to(card))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("shape_x,shape_w,stride,pad,dil,groups", [
    ((32, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((32, 12, 12, 20), (5, 5, 20, 50), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((4, 9, 9, 8), (3, 3, 4, 6), (2, 2), "SAME", (1, 1), 2),
    ((4, 11, 11, 4), (3, 3, 4, 5), (1, 1), ((2, 2), (1, 1)), (2, 2), 1),
    ((2, 6, 6, 512), (3, 3, 512, 8), (1, 1), "SAME", (1, 1), 1),
])
def test_int8_conv_on_the_card_is_exact(card, shape_x, shape_w, stride,
                                        pad, dil, groups):
    """``int8_conv`` on the card at LeNet's shapes, a grouped, a dilated
    and a K = 4608 case: its int32 accumulator equals the CPU's, which
    (unpadded, one group) is the int64 product of the same patches, and
    the rescaled output is bitwise the CPU's."""
    from deeplearning4j_tpu_torch.ops.quantize import (
        int8_conv, int8_conv_accumulator, quantize_act)
    import chip_smoke
    g = torch.Generator().manual_seed(sum(shape_w))
    x = torch.randn(shape_x, generator=g)
    wq = torch.randint(-127, 128, shape_w, generator=g, dtype=torch.int8)
    ws = torch.rand(shape_w[-1], generator=g) * 0.01
    xs = torch.tensor(float(x.abs().max()) / 127)
    kw = dict(window_strides=stride, padding=pad, rhs_dilation=dil,
              feature_group_count=groups)
    xq = quantize_act(x, xs)
    acc = int8_conv_accumulator(xq.to(card), wq.to(card), **kw).cpu()
    assert acc.dtype == torch.int32
    assert torch.equal(acc, int8_conv_accumulator(xq, wq, **kw))
    if groups == 1 and pad == ((0, 0), (0, 0)):
        exact = chip_smoke._int64_conv(xq, wq, stride, dil)
        assert torch.equal(acc.reshape(exact.shape).long(), exact)
    got = int8_conv(x.to(card), wq.to(card), ws.to(card), xs.to(card), **kw)
    assert torch.equal(got.cpu(), int8_conv(x, wq, ws, xs, **kw))


def test_f64_lstm_on_the_card_raises_from_the_kernel_wrapper(card):
    """The gradient check runs in float64; the LSTM kernels take f32 and
    bf16 only, so an f64 LSTM model on the card raises TypeError from the
    wrapper (it is checked on the CPU instead)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(LSTM(n_out=8)).layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(4, 5)).build())
    m = MultiLayerNetwork(conf, device=card).init()
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(2, 5, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5))])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check_model_gradients(m, ds, verbose=False)


def test_library_gradient_check_on_the_card(card):
    """Dense + AutoEncoder + MixtureOfExperts + SameDiffLayer + output in
    float64 on the card: autograd against central differences."""
    import chip_smoke
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    assert check_model_gradients(chip_smoke.library_mln(card),
                                 chip_smoke.library_data(),
                                 max_params_per_leaf=6, verbose=False)


def _small_resnet(seed=123):
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    return ResNet50(num_classes=10, height=32, width=32, fused_blocks=True,
                    s2d_stem=True, compute_dtype="bfloat16", seed=seed).init()


def test_http_predict_of_the_slice_model_equals_its_engine(card, tmp_path):
    """``serve`` on the card: /api/predict answers (a split request
    included) equal the served engine's own ``output`` bitwise, and the
    dispatches launch the fused kernels."""
    import json
    import urllib.request
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    from deeplearning4j_tpu_torch.models.serialization import save_model
    path = str(tmp_path / "rn.zip")
    save_model(_small_resnet(), path)
    front, server = cmd_serve(["serve", "--model", path, "--bf16",
                               "--warmup-shape", "32", "32", "3",
                               "--batch-limit", "4", "--ui-port", "0"],
                              block=False)
    try:
        x = np.random.default_rng(1).normal(0, 1, (5, 32, 32, 3)).astype(
            np.float32)
        fc.reset_launch_counts()
        req = urllib.request.Request(
            server.url + "/api/predict",
            data=json.dumps({"features": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        out = json.loads(urllib.request.urlopen(req, timeout=120).read())
        assert out["n"] == 5
        assert fc.LAUNCHES["fused_mm"] == 72 and fc.LAUNCHES["fused_c3"] == 32
        got = np.asarray(out["output"], np.float32)
        assert np.array_equal(got, front.engine.output(x))
        stats = json.loads(urllib.request.urlopen(
            server.url + "/api/serving/stats", timeout=60).read())
        assert stats["device"] == "cuda:0" and stats["precision"] == "bf16"
        front.engine.assert_warm()
    finally:
        front.shutdown()
        server.stop()


def test_inplace_mode_equals_batched_on_the_card(card):
    from deeplearning4j_tpu_torch.parallel.inference import (
        InferenceMode, ParallelInference)
    m = _small_resnet()
    x = np.random.default_rng(2).normal(0, 1, (7, 32, 32, 3)).astype(
        np.float32)
    with ParallelInference(m, InferenceMode.BATCHED, batch_limit=4,
                           feature_shape=(32, 32, 3)) as batched, \
            ParallelInference(m, InferenceMode.INPLACE,
                              batch_limit=4) as inplace:
        assert inplace._stream is not None
        a, b = batched.output(x), inplace.output(x)
    assert a.shape == b.shape == (7, 10)
    np.testing.assert_array_equal(a, b)


def test_swap_params_keeps_the_ladder_warm_on_the_card(card):
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    m1, m2 = _small_resnet(1), _small_resnet(2)
    x = np.random.default_rng(3).normal(0, 1, (3, 32, 32, 3)).astype(
        np.float32)
    with ServingEngine(m1, batch_limit=4, feature_shape=(32, 32, 3),
                       precision="bf16") as e1, \
            ServingEngine(m2, batch_limit=4, feature_shape=(32, 32, 3),
                          precision="bf16") as e2:
        before, want = e1.output(x), e2.output(x)
        host = e1.committed_host()
        e1.swap_params(m2.params, m2.model_state, version="v2")
        fc.reset_launch_counts()
        np.testing.assert_array_equal(e1.output(x), want)
        assert fc.LAUNCHES["fused_mm"] == 36 and fc.LAUNCHES["fused_c3"] == 16
        e1.swap_params(*host)
        np.testing.assert_array_equal(e1.output(x), before)
        e1.assert_warm()
        assert e1.recompiles_after_warmup == 0


# ---- the recurrent family on the card (truncated BPTT, the layers, the
# streaming graph, Graves generation) ----------------------------------
# Against the same port model on the CPU (the plain versions): segment
# losses within 1e-5 relative and parameters after one TBPTT batch within
# 1e-3 of each array's largest (a few Adam steps over f32 sums taken in
# another order, with lstm_fwd's activations within 1e-6 of expf/tanhf:
# chip_smoke.py's CHAIN_* comment); probabilities within 1e-5.


def _tbptt_pair(card, cell="LSTM", wrap=None, compute="float32"):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers import recurrent as R
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    core = getattr(R, cell)(n_out=32)
    conf = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(5e-3))
            .gradient_normalization("clip_value", 5.0)
            .compute_dtype(compute).list()
            .layer(R.LSTM(n_out=32))
            .layer(core if wrap is None else getattr(R, wrap)(inner=core))
            .layer(RnnOutputLayer(n_out=7))
            .set_input_type(InputType.recurrent(5))
            .backprop_type("tbptt").tbptt_fwd_length(6).build())
    return (MultiLayerNetwork(conf, device=card).init(),
            MultiLayerNetwork(conf, device="cpu").init())


def _seq_data(n, t, f=5, c=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, f)).astype(np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, t))]
    m = np.ones((n, t), np.float32)
    m[1, t - 4:] = 0.0
    m[2, t // 2:] = 0.0
    return x, y, m


@pytest.mark.parametrize("cell,wrap", [("LSTM", None), ("SimpleRnn", None),
                                       ("LSTM", "MaskZeroLayer")])
def test_tbptt_on_the_card_matches_the_cpu(card, cell, wrap):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    gpu, cpu = _tbptt_pair(card, cell, wrap)
    x, y, m = _seq_data(6, 16)               # segments 6, 6 and a tail of 4
    fl.reset_launch_counts()
    gpu.fit(DataSet(x, y, m))
    lstms = 2 if cell == "LSTM" else 1
    assert fl.LAUNCHES == {"lstm_fwd": 3 * lstms, "lstm_bwd": 3 * lstms}
    cpu.fit(DataSet(x, y, m))
    assert gpu.iteration == cpu.iteration == 3
    np.testing.assert_allclose([v.item() for v in gpu.last_segment_losses],
                               [v.item() for v in cpu.last_segment_losses],
                               rtol=1e-5)
    want = flatten_paths(cpu.params)
    for k, v in flatten_paths(gpu.params).items():
        err = (v.cpu() - want[k]).abs().max().item()
        assert err <= 1e-3 * want[k].abs().max().item(), k


def test_tbptt_bf16_carries_on_the_card(card):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    gpu, _ = _tbptt_pair(card, compute="bfloat16")
    x, y, m = _seq_data(4, 12)
    fl.reset_launch_counts()
    gpu.fit(DataSet(x, y, m))
    assert fl.LAUNCHES == {"lstm_fwd": 4, "lstm_bwd": 4}
    assert gpu.model_state["layer_1"]["last_h"].dtype == torch.bfloat16
    assert all(np.isfinite(v.item()) for v in gpu.last_segment_losses)


@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_bidirectional_lstm_on_the_card_matches_plain(card, mode):
    """A right-padded ragged mask: the reversed pass starts with masked
    ticks; output and gradients through the kernels against the plain
    versions on the card, 2 lstm_fwd a call and 2 + 2 a step."""
    from unittest import mock
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (LSTM,
                                                              Bidirectional)
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    layer = Bidirectional(fwd=LSTM(n_in=5, n_out=40), mode=mode)
    p = {k: {kk: v.to(card).requires_grad_() for kk, v in d.items()}
         for k, d in layer.initialize(torch.Generator().manual_seed(0),
                                      InputType.recurrent(5, 16)).items()}
    x, _, m = _seq_data(6, 16)
    xt, mt = torch.tensor(x, device=card), torch.tensor(m, device=card)
    w = torch.randn(6, 16, 80 if mode == "concat" else 40, device=card)

    def run():
        y, _ = layer.apply(p, {}, xt, LayerContext(mask=mt))
        leaves = [v for d in p.values() for v in d.values()]
        return y.detach(), torch.autograd.grad((y * w).sum(), leaves)
    fl.reset_launch_counts()
    y, g = run()
    assert fl.LAUNCHES == {"lstm_fwd": 2, "lstm_bwd": 2}
    with mock.patch.object(fl, "lstm_fwd", fl.lstm_fwd_reference), \
            mock.patch.object(fl, "lstm_bwd", fl.lstm_bwd_reference):
        y_ref, g_ref = run()
    torch.testing.assert_close(y, y_ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(g, g_ref):
        assert (a - b).norm() <= 1e-4 * b.norm()
    assert torch.all(y[2, 8:] == 0)


def test_recurrent_graph_on_the_card_streams_like_output(card):
    """A TBPTT graph with a features mask trains on the card (1 + 1
    launches a segment) as on the CPU, and streams a tick at a time like
    output()."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    def graph(device):
        g = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(5e-3))
             .graph_builder().add_inputs("in")
             .set_input_types(InputType.recurrent(5)))
        g.add_layer("lstm", LSTM(n_out=48), "in")
        g.add_layer("out", RnnOutputLayer(n_out=7), "lstm")
        g.set_outputs("out")
        g.backprop_type("tbptt").tbptt_fwd_length(8)
        return ComputationGraph(g.build(), device=device).init()
    gpu, cpu = graph(card), graph("cpu")
    x, y, m = _seq_data(6, 20)
    fl.reset_launch_counts()
    gpu.fit(DataSet(x, y, m))
    assert fl.LAUNCHES == {"lstm_fwd": 3, "lstm_bwd": 3}
    cpu.fit(DataSet(x, y, m))
    np.testing.assert_allclose([v.item() for v in gpu.last_segment_losses],
                               [v.item() for v in cpu.last_segment_losses],
                               rtol=1e-5)
    xt = torch.tensor(x, device=card)
    whole = gpu.output(xt, mask=torch.tensor(m, device=card))
    np.testing.assert_allclose(whole.cpu().numpy(),
                               cpu.output(x, mask=m).numpy(), atol=1e-5)
    gpu.rnn_clear_previous_state()
    streamed = torch.stack([gpu.rnn_time_step(xt[:, s]) for s in range(20)],
                           1)
    torch.testing.assert_close(streamed, gpu.output(xt), rtol=1e-5,
                               atol=1e-5)


def test_graves_generation_on_the_card_matches_reference_decode(card):
    """2 x GravesLSTM(32) with peepholes drawn from a seed: the engine's
    greedy streams equal reference_decode up to the first near tie."""
    import random
    from deeplearning4j_tpu_torch.generation import (GenerationEngine,
                                                     reference_decode)
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    conf = (NeuralNetConfiguration.Builder().seed(3).list()
            .layer(GravesLSTM(n_out=32)).layer(GravesLSTM(n_out=32))
            .layer(RnnOutputLayer(n_out=31))
            .set_input_type(InputType.recurrent(31)).build())
    model = MultiLayerNetwork(conf, device=card).init()
    gen = torch.Generator().manual_seed(3)
    params = {k: dict(v) for k, v in model.params.items()}
    for name in ("layer_0", "layer_1"):
        for k in ("pI", "pF", "pO"):
            params[name][k] = torch.rand(32, generator=gen) - 0.5
    model.set_params(params)
    eng = GenerationEngine(model, max_slots=4, registry=MetricsRegistry())
    try:
        rng = random.Random(5)
        cfgs = [([rng.randrange(31) for _ in range(rng.randrange(2, 7))],
                 rng.randrange(10, 30)) for _ in range(6)]
        streams = [eng.submit(p, max_new_tokens=m) for p, m in cfgs]
        eye = torch.eye(31, device=card)
        for (p, m), s in zip(cfgs, streams):
            got = s.result(timeout=120)["ids"]
            ref = reference_decode(model, p, m)
            probs, _ = model.rnn_time_step(eye[p + ref[:-1]][None])
            top2 = probs[0, len(p) - 1:].topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            tie = int(np.argmax(gaps < 1e-4)) if (gaps < 1e-4).any() \
                else len(ref)
            assert got[:tie] == ref[:tie]
        eng.assert_warm()
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# the convolutional model library (plain torch on the card, no kernel):
# each layer against the same layer on the CPU, f32 with TF32 off; cuDNN
# and the CPU sum in other orders, so |diff| <= 1e-5·max|cpu| + 1e-6
# ---------------------------------------------------------------------------

def _library_layers():
    from deeplearning4j_tpu_torch.nn.graph import vertices as V
    from deeplearning4j_tpu_torch.nn.inputs import (ConvolutionalType,
                                                    FeedForwardType,
                                                    RecurrentType)
    from deeplearning4j_tpu_torch.nn.layers import convolution as C
    from deeplearning4j_tpu_torch.nn.layers import feedforward as FF
    from deeplearning4j_tpu_torch.nn.layers import misc as M
    from deeplearning4j_tpu_torch.nn.layers import normalization as N
    from deeplearning4j_tpu_torch.nn.layers.fused import \
        FusedBottleneckBlock
    from deeplearning4j_tpu_torch.nn.layers.output import \
        CenterLossOutputLayer
    cm = C.ConvolutionMode
    img, seq = ConvolutionalType(9, 8, 6), RecurrentType(6, 10)
    return [
        (C.SeparableConvolution2D(n_out=5, kernel_size=(3, 3),
                                  convolution_mode=cm.SAME,
                                  depth_multiplier=2), img),
        (C.Deconvolution2D(n_out=5, kernel_size=(3, 3), stride=(2, 2),
                           convolution_mode=cm.SAME), img),
        (C.Deconvolution2D(n_out=5, kernel_size=(3, 2), stride=(2, 1),
                           padding=(1, 0), convolution_mode=cm.TRUNCATE),
         img),
        (C.Upsampling2D(size=(2, 3)), img),
        (C.Cropping2D(crop=(1, 2, 0, 1)), img),
        (C.SpaceToBatchLayer(block_size=(3, 2)), img),
        (C.Convolution1DLayer(n_out=7, kernel_size=3, stride=2), seq),
        (C.Subsampling1DLayer(kernel_size=3, stride=2), seq),
        (C.Upsampling1D(size=2), seq),
        (C.ZeroPadding1DLayer(pad=(1, 2)), seq),
        (C.Cropping1D(crop=(2, 1)), seq),
        (N.LocalResponseNormalization(), img),
        (FF.ReshapeLayer(shape=(-1, 6)), img),
        (FF.PermuteLayer(dims=(2, 1)), seq),
        (FF.ElementWiseMultiplicationLayer(n_out=6), FeedForwardType(6)),
        (M.FrozenLayer(underlying=N.BatchNormalization()), img),
        (M.MaskLayer(), seq),
        (CenterLossOutputLayer(n_out=5), FeedForwardType(6)),
        (FusedBottleneckBlock(filters=4, stride=2, downsample=True,
                              impl="xla"), img),
        (V.L2NormalizeVertex(), img),
    ]


def _card_close(got, want):
    want = want.float()
    assert (got.float().cpu() - want).abs().max() <= \
        1e-5 * want.abs().max() + 1e-6


@pytest.mark.parametrize("idx", range(20))
def test_library_layer_on_the_card_matches_the_cpu(card, idx):
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    layer, it = _library_layers()[idx]
    g = torch.Generator().manual_seed(idx)
    x = torch.randn((4,) + tuple(it.shape()), generator=g)
    if not hasattr(layer, "initialize"):                 # a vertex
        _card_close(layer.apply(x.to(card)), layer.apply(x))
        return
    p = layer.initialize(g, it)
    st = layer.init_state(it)
    for train in (False, True):
        ctx = LayerContext(train=train)
        pc = {k: v.to(card).requires_grad_(train) for k, v in p.items()}
        pp = {k: v.clone().requires_grad_(train) for k, v in p.items()}
        yc, _ = layer.apply(pc, {k: v.to(card) for k, v in st.items()},
                            x.to(card), ctx)
        yp, _ = layer.apply(pp, st, x, ctx)
        _card_close(yc, yp)
        if train and p:
            # (an output layer's centers take no part in its forward)
            gc = torch.autograd.grad(yc.square().sum(), list(pc.values()),
                                     allow_unused=True)
            gp = torch.autograd.grad(yp.square().sum(), list(pp.values()),
                                     allow_unused=True)
            for a, b in zip(gc, gp):
                assert (a is None) == (b is None)
                if b is not None:
                    assert (a.cpu() - b).norm() <= 1e-4 * b.norm() + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,cin,cout,stride", [
    (8192, 64, 256, 1), (2048, 128, 512, 1), (512, 256, 1024, 1),
    (128, 512, 2048, 1), (8192, 256, 512, 2), (8192, 256, 64, 1)])
def test_gram_route_against_direct_route_on_the_card(card, dtype, m, cin,
                                                     cout, stride):
    """The two statistics routes of ``conv_bn_stats_xla`` on the card: the
    same y; (Σy, Σy²) within 1e-4 (f32) or 1e-2 (bf16: the direct route
    sums the rounded y, the Gram route the unrounded product) of their
    largest entry; the bf16 Gram is f32 and equals the upcast product
    within 1e-4 of its largest entry."""
    side = int(round((m / 32) ** 0.5)) * stride
    x, w, s, b = _inputs(card, (32, side, side, cin), (cin, cout), dtype)
    ya, sa = fc.conv_bn_stats_xla(x, w, s, b, True, True, stride,
                                  gram="always")
    yb, sb = fc.conv_bn_stats_xla(x, w, s, b, True, True, stride,
                                  gram="never")
    assert torch.equal(ya, yb)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert (sa - sb).abs().max() <= tol * sb.abs().max()
    e = x.reshape(-1, cin)
    gram = fc._gram_product(e)
    assert gram.dtype == torch.float32
    ref = e.float().t() @ e.float()
    # f32 sums of M products in two orders (cuBLAS's and the upcast's)
    assert (gram - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize("name,kw", [
    ("ResNet50", dict(height=32, width=32, num_classes=10)),
    ("ResNet50", dict(height=32, width=32, num_classes=10,
                      fused_blocks=True, fused_impl="xla", s2d_stem=True)),
    ("VGG16", dict(height=32, width=32, num_classes=10)),
    ("AlexNet", dict(height=67, width=67, num_classes=10)),
    ("Darknet19", dict(height=32, width=32, num_classes=10)),
    ("TinyYOLO", dict(height=64, width=64, num_classes=4)),
    ("YOLO2", dict(height=64, width=64, num_classes=4)),
    ("GoogLeNet", dict(height=32, width=32, num_classes=7)),
    ("InceptionResNetV1", dict(height=32, width=32, num_classes=9)),
    ("FaceNetNN4Small2", dict(height=32, width=32, num_classes=11)),
])
def test_zoo_model_on_the_card_matches_the_cpu(card, name, kw):
    """Each zoo model's f32 output on the card against the same model on
    the CPU, and one train step moves every trainable layer."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.zoo import models as Z
    zoo = getattr(Z, name)(**kw)
    mc, mp = zoo.init(), zoo.init(device="cpu")
    assert mc.device.type == "cuda"
    x = torch.randn((2, kw["height"], kw["width"], 3),
                    generator=torch.Generator().manual_seed(0)).numpy()
    yc, yp = mc.output(x), mp.output(x)
    assert (yc.cpu() - yp).abs().max() <= 1e-4 * yp.abs().max()
    if yp.ndim == 2:
        y = np.eye(yp.shape[1], dtype=np.float32)[[0, 1]]
        before = {k: {n: v.clone() for n, v in lp.items()}
                  for k, lp in mc.params.items()}
        mc.fit(DataSet(x, y))
        assert torch.isfinite(torch.tensor(mc.score()))
        moved = [k for k, lp in mc.params.items()
                 if any(not torch.equal(v, before[k][n])
                        for n, v in lp.items())]
        assert len(moved) == sum(1 for lp in before.values() if lp)


def test_yolo_loss_on_the_card_matches_the_cpu(card):
    from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        Yolo2OutputLayer, get_predicted_objects)
    layer = Yolo2OutputLayer(boxes=((1.0, 1.5), (2.0, 1.0)))
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 4, 2 * 8), generator=g)
    y = torch.zeros((3, 4, 4, 7))
    y[..., :2] = torch.rand((3, 4, 4, 2), generator=g) * 4
    y[..., 2:4] = 0.5 + torch.rand((3, 4, 4, 2), generator=g) * 2
    y[..., 4] = 1.0
    xc = x.to(card).requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    lc = layer.compute_loss({}, {}, xc, y.to(card), LayerContext())
    lp = layer.compute_loss({}, {}, xp, y, LayerContext())
    assert abs(lc.item() - lp.item()) <= 1e-5 * abs(lp.item())
    (gc,), (gp,) = (torch.autograd.grad(lc, xc),
                    torch.autograd.grad(lp, xp))
    assert (gc.cpu() - gp).norm() <= 1e-5 * gp.norm()
    dc = get_predicted_objects(layer, x.to(card), 0.3)
    dp = get_predicted_objects(layer, x, 0.3)
    assert [(d.example, d.predicted_class) for d in dc] == \
        [(d.example, d.predicted_class) for d in dp]


# ---- Keras import on the card -------------------------------------------
# The card's machine has no h5py and no keras: the importer's conversion
# runs on the committed resources of deeplearning4j_tpu_torch/modelimport/
# resources through chip_smoke.py's KerasResourceArchive. Bounds: each
# fixture within rtol 1e-4, atol 1e-5 of its _io.npz
# (tests/test_keras_fixtures.py:45); card against the same import on the
# CPU within 1e-5 of the output's largest magnitude; gradients through
# the kernels within 1e-4 relative L2 of the plain path.

def _keras_res():
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke, os.path.join(root, chip_smoke.KERAS_RES), root


_KERAS_FIXTURES = ("k1_mlp", "k1_cnn_atrous", "k1_lstm", "k1_merge",
                   "k2_googlenet_bits", "k2_yolo_bits", "k2_temporal",
                   "k2_reshape_permute", "k2_selu_alpha_dropout", "k3_conv",
                   "k3_temporal", "k3_merges", "k3_attention",
                   "k3_pool_extras")


@pytest.mark.parametrize("name", _KERAS_FIXTURES)
def test_keras_fixture_on_the_card(card, name):
    import os

    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    cs, res, root = _keras_res()
    stem = os.path.join(res, name)
    gpu = _import_archive(cs.KerasResourceArchive(stem), "cuda")
    cpu = _import_archive(cs.KerasResourceArchive(stem), "cpu")
    io = np.load(os.path.join(root, "tests", "resources", "keras",
                              name + "_io.npz"))
    got = gpu.output(io["x"]).cpu().numpy()
    np.testing.assert_allclose(got, io["y"], rtol=1e-4, atol=1e-5)
    ref = cpu.output(io["x"]).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_imported_small_bert_on_the_card(card):
    """The small BERT geometry from its committed configuration and seeded
    weights: the output against Keras's, 2 flash_fwd launches a call, and
    one f32 step of the grafted fine-tune's gradients against the plain
    path."""
    import contextlib
    import os
    from unittest import mock

    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.nn.layers.output import (
        GlobalPoolingLayer, OutputLayer, PoolingType)
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    cs, res, _ = _keras_res()
    model = _import_archive(cs.KerasResourceArchive(
        os.path.join(res, "bert_small")), "cuda")
    g = np.load(os.path.join(res, "bert_small_golden.npz"))
    ids = torch.from_numpy(g["ids"]).long().cuda()
    pos = torch.arange(ids.shape[1], device="cuda").expand_as(ids)
    before = fa.LAUNCHES["flash_fwd"]
    out = model.output(ids, pos)
    assert fa.LAUNCHES["flash_fwd"] - before == 2
    np.testing.assert_allclose(out.cpu().numpy(), g["hidden"], rtol=1e-4,
                               atol=1e-5)
    enc = model.conf.network_outputs[0]
    ft = (TransferLearning.GraphBuilder(model).fine_tune_configuration(
        FineTuneConfiguration.Builder().updater(Adam(1e-3)).build())
        .add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                   enc)
        .add_layer("cls", OutputLayer(n_out=2), "pool")
        .set_outputs("cls").build())
    y = torch.eye(2, device="cuda")[torch.tensor([0, 1], device="cuda")]
    args = ft._step_args(MultiDataSet((ids, pos), (y,)))
    _, _, g_k = solver.value_and_grad(ft._loss, ft.train_state, *args)
    with contextlib.ExitStack() as stack:
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
            stack.enter_context(mock.patch.object(
                fa, name, getattr(fa, name + "_reference")))
        _, _, g_p = solver.value_and_grad(ft._loss, ft.train_state, *args)
    fk, fp = flatten_paths(g_k), flatten_paths(g_p)
    for k, r in fp.items():
        assert (fk[k] - r).norm() <= 1e-4 * r.norm() + 1e-12, k


def test_shadow_cast_steps_bitwise_on_the_card(card):
    """Two K-step calls of a bf16 graft of the small BERT: with the shadow
    cast and without it, the losses and parameters are bitwise equal."""
    import os

    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.models.base import cast_params
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.nn.layers.output import (
        GlobalPoolingLayer, OutputLayer, PoolingType)
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    cs, res, _ = _keras_res()
    model = _import_archive(cs.KerasResourceArchive(
        os.path.join(res, "bert_small")), "cuda")
    enc = model.conf.network_outputs[0]
    ft = (TransferLearning.GraphBuilder(model).fine_tune_configuration(
        FineTuneConfiguration.Builder().updater(Adam(1e-3))
        .compute_dtype("bfloat16").build())
        .add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                   enc)
        .add_layer("cls", OutputLayer(n_out=2), "pool")
        .set_outputs("cls").build())
    twin = ft.clone()
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 50, (3, 8, 12), generator=gen).cuda()
    pos = torch.arange(12, device="cuda").expand(3, 8, 12)
    y = torch.eye(2)[torch.randint(0, 2, (3, 8), generator=gen)].cuda()
    ts_a, la = ft._build_scan_train_step(
        shadow_cast=lambda p: cast_params(p, "bfloat16"))(
        ft.train_state, (ids, pos), (y,))
    ts_b, lb = twin._build_scan_train_step()(twin.train_state, (ids, pos),
                                             (y,))
    assert torch.equal(la, lb)
    fa_, fb_ = flatten_paths(ts_a.params), flatten_paths(ts_b.params)
    assert all(torch.equal(fa_[k], fb_[k]) for k in fa_)


def _observed_resnet(card, k=2, flush=4):
    """A narrow fused-block ResNet50 on the card, a clone with nothing
    attached, and 2k batches of 8."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    m = ResNet50(num_classes=6, height=32, width=32, fused_blocks=True,
                 s2d_stem=True).init()
    plain = m.clone()
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16 * k, 32, 32, 3)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 16 * k)]
    return m, plain, ArrayDataSetIterator(DataSet(x, y), 8), x, y


def test_observers_change_no_parameter_bit_on_the_card(card, tmp_path):
    """fit(iterator, k_steps=2) with telemetry (histograms), score and
    performance listeners, a tracer and a flight recorder gives the
    parameters bitwise of the same K-step calls made directly on the same
    staged batches (with the feeder's ones labels mask)."""
    from deeplearning4j_tpu_torch.observe import (FlightRecorder,
                                                  SpanTracer,
                                                  TelemetryCollector)
    from deeplearning4j_tpu_torch.optimize.listeners import (
        PerformanceListener, ScoreIterationListener)
    torch.backends.cudnn.deterministic = True
    m, plain, it, x, y = _observed_resnet(card)
    m.set_telemetry(TelemetryCollector(flush_interval=4, histograms=True,
                                       hist_interval=2))
    m.set_listeners(ScoreIterationListener(1), PerformanceListener(1))
    m.set_tracer(SpanTracer())
    m.set_flight_recorder(FlightRecorder(str(tmp_path)))
    m.fit(it, k_steps=2)
    scan = plain._build_scan_train_step()
    for lo in range(0, len(x), 16):
        xs = torch.from_numpy(x[lo:lo + 16].reshape(2, 8, 32, 32, 3)).to(
            card)
        ys = torch.from_numpy(y[lo:lo + 16].reshape(2, 8, 6)).to(card)
        ones = torch.ones((2, 8), device=card)
        plain.train_state, _ = scan(plain.train_state, (xs,), (ys,), None,
                                    (ones,), plain._generator)
    for ln, lp in plain.params.items():
        for key, v in lp.items():
            assert m.params[ln][key].equal(v), (ln, key)
    assert len(m.telemetry.history) == m.iteration == 4


def test_no_sync_between_telemetry_flushes_on_the_card(card):
    """With sync debug mode "error" around every telemetry record, every
    collector step that does not flush and the listeners' calls, a
    monitored fit raises nothing: telemetry and score listeners make no
    device-to-host sync between flushes."""
    from deeplearning4j_tpu_torch.observe import TelemetryCollector
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener, ScoreIterationListener,
        TrainingListener)
    m, _, it, _, _ = _observed_resnet(card, k=4)
    tc = TelemetryCollector(flush_interval=4, histograms=True,
                            hist_interval=2)
    m.set_telemetry(tc)
    record, on_step = tc.spec.record, tc.on_step

    def guarded(fn, when=lambda *a, **k: True):
        def call(*a, **k):
            if not when(*a, **k):
                return fn(*a, **k)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    class Guard(TrainingListener):
        def __init__(self, on):
            self.on = on

        def iteration_done(self, *args):
            torch.cuda.set_sync_debug_mode("error" if self.on
                                           else "default")
    m.fit(it, k_steps=2)                 # warm: the record's constants
    tc.spec.record = guarded(record)
    tc.on_step = guarded(on_step, lambda ts, steps=1: not tc.will_flush(
        steps))
    m.set_listeners(Guard(True), ScoreIterationListener(1),
                    CollectScoresIterationListener(1), Guard(False))
    try:
        m.fit(it, k_steps=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tc.fetch_count == 6 and len(tc.history) == 16


# ---- retrieval and the cluster tier on the card -----------------------------

_NN_STORE = __import__("pathlib").Path(__file__).resolve().parent / \
    "resources" / "retrieval"


def _nn_engine(key, device):
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
    return RetrievalEngine(
        ShardedCorpusIndex.load(ArtifactStore(str(_NN_STORE)), key),
        k_ladder=(10, 40), max_batch=16, registry=MetricsRegistry(),
        device=device).warmup()


@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("mode", ["brute", "ivf"])
def test_retrieval_on_the_card_matches_the_cpu(card, precision, mode):
    """The committed JAX-saved index: the card's ids are the port's CPU
    ids (which the CPU tests hold to the JAX package's); distances within
    1e-5 of |q|^2 + |c|^2 (the expanded form cancels near a neighbour)."""
    q = np.load(_NN_STORE / "queries.npy")
    got = _nn_engine(f"small-{precision}", card)
    want = _nn_engine(f"small-{precision}", "cpu")
    dc, ic = got.search(q, 10, mode=mode)
    dp, ip = want.search(q, 10, mode=mode)
    assert np.array_equal(ic, ip)
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
    rows = np.concatenate([s.vectors[:s.n] for s in ShardedCorpusIndex.load(
        ArtifactStore(str(_NN_STORE)), "small-f32").shards])
    c2 = np.sum(rows.astype(np.float64) ** 2, axis=1)[ip]
    scale = np.sum(q.astype(np.float64) ** 2, 1)[:, None] + c2
    assert (np.abs(dc.astype(np.float64) - dp) <= 1e-5 * scale).all()
    d2, i2 = got.search(q, 10, mode=mode)
    assert d2.tobytes() == dc.tobytes() and i2.tobytes() == ic.tobytes()
    got.assert_warm()
    assert got.stats()["device"].startswith("cuda")


@pytest.mark.parametrize("fn", ["brute_topk_f32", "brute_topk_int8",
                                "ivf_topk_f32", "ivf_topk_int8"])
def test_retrieval_ties_on_the_card(card, fn):
    """A tie-heavy integer corpus (every distance exact): the card's ids
    are the CPU's, in lax.top_k's order."""
    from deeplearning4j_tpu_torch.retrieval import kernels as tk
    rng = np.random.default_rng(7)
    r, d, kc, m = 4096, 4, 16, 256
    c = rng.integers(-2, 3, size=(r, d)).astype(np.float32)
    q = rng.integers(-2, 3, size=(64, d)).astype(np.float32)
    ids = np.arange(r, dtype=np.int32)
    c2 = np.sum(c * c, axis=1)
    cl, c_ids = c.reshape(kc, m, d), ids.reshape(kc, m)
    cents = cl.mean(axis=1).round()
    args = {"brute_topk_f32": (c, c2, ids),
            "brute_topk_int8": (c.astype(np.int8), np.ones(r, np.float32),
                                c2, ids),
            "ivf_topk_f32": (cents, cl, c2.reshape(kc, m), c_ids),
            "ivf_topk_int8": (cents, cl.astype(np.int8),
                              np.ones((kc, m), np.float32),
                              c2.reshape(kc, m), c_ids)}[fn]
    extra = (6,) if fn.startswith("ivf") else ()
    t = [torch.from_numpy(a) for a in (q, *args)]
    for k in (10, 40):
        dp, ip = getattr(tk, fn)(*t, k, *extra)
        dc, ic = getattr(tk, fn)(*[a.to(card) for a in t], k, *extra)
        assert torch.equal(ic.cpu(), ip) and torch.equal(dc.cpu(), dp)


def test_topk_smallest_order_on_the_card(card):
    from deeplearning4j_tpu_torch.retrieval.kernels import topk_smallest
    d = torch.tensor([[0.0, -0.0, float("inf"), -1.0, 0.0, float("inf")]],
                     device=card).repeat(3, 1000)
    v, p = topk_smallest(d, 12)
    vc, pc = topk_smallest(d.cpu(), 12)
    assert torch.equal(p.cpu(), pc) and torch.equal(v.cpu(), vc)
    assert p[0, :4].tolist() == [3, 9, 15, 21]


def test_int8_retrieval_refuses_tf32_on_the_card(card):
    eng = _nn_engine("small-int8", card)
    q = np.load(_NN_STORE / "queries.npy")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for mode in ("brute", "ivf"):
            with pytest.raises(RuntimeError, match="TF32"):
                eng.search(q, 10, mode=mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_serving_node_and_dispatcher_on_the_card(card, tmp_path):
    """A ServingNode on the card behind a RemoteDispatcher over HTTP:
    answers bitwise the node's engine, the drain deregisters."""
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.node import (NodeRegistry,
                                                        ServingNode)
    from deeplearning4j_tpu_torch.parallel.remote import RemoteDispatcher
    zip_path = _NN_STORE.parents[2] / "deeplearning4j_tpu" / "zoo" / \
        "weights" / "lenet_digits.zip"
    model = restore_model(str(zip_path))
    reg = NodeRegistry(str(tmp_path / "reg"))
    node = ServingNode(model, node_id="c1", registry=reg, device="cuda",
                       metrics_registry=MetricsRegistry(), batch_limit=8,
                       feature_shape=(784,))
    d = RemoteDispatcher(reg, metrics=MetricsRegistry())
    try:
        x = np.random.default_rng(0).uniform(0, 1, (5, 784)).astype(
            np.float32)
        eng = node.router.pool("default").engines[0]
        assert np.array_equal(np.asarray(d.output(x), np.float32),
                              eng.output(x))
        node.assert_warm()
        assert node.drain(10.0)["drained"] and reg.read_all() == {}
    finally:
        d.shutdown()
        node.shutdown()


# ---- the embedding tier's device steps (nlp/skipgram.py, GloVe) ----------

def _emb_inputs(seed=0, v=300, d=64, b=2048, k=6):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    syn0 = (rng.normal(size=(v, d)) * 0.3).astype(f32)
    syn1 = (rng.normal(size=(v, d)) * 0.3).astype(f32)
    # zipf-like rows: many duplicates in every scatter
    p = 1.0 / np.arange(1, v + 1)
    ids = lambda *shape: rng.choice(v, size=shape, p=p / p.sum()).astype(
        np.int32)
    labels = np.zeros((b, k), f32)
    labels[:, 0] = 1.0
    mask = np.ones((b, k), f32)
    mask[b - 100:] = 0.0
    cm = (rng.random((b, 10)) < 0.7).astype(f32)
    return dict(syn0=syn0, syn1=syn1, centers=ids(b), targets=ids(b, k),
                labels=labels, mask=mask, context=ids(b, 10), cmask=cm,
                cen3=ids(3, b), ctx3=ids(3, b), tgt3=ids(3, b, k),
                negs3=ids(3, 4, 5), nv=np.array([b, 1500, 0], np.int32),
                lrs=np.array([0.05, 0.03, 0.01], f32))


def _emb_step(name, x, dev):
    """Run step ``name`` on ``dev`` from the numpy inputs; return the
    tables it updated, on the CPU."""
    from deeplearning4j_tpu_torch.nlp import skipgram as sk
    t = {k: torch.from_numpy(np.array(a)).to(dev) for k, a in x.items()}
    s0, s1 = t["syn0"], t["syn1"]
    if name == "skipgram":
        sk.skipgram_step(s0, s1, t["centers"], t["targets"], t["labels"],
                         t["mask"], 0.5)
    elif name == "cbow":
        sk.cbow_step(s0, s1, t["context"], t["cmask"], t["targets"],
                     t["labels"], t["mask"], 0.5)
    elif name == "scan":
        sk.skipgram_scan_step(s0, s1, t["cen3"], t["tgt3"], t["nv"],
                              t["lrs"])
    elif name == "shared":
        sk.skipgram_scan_step_shared(s0, s1, t["cen3"], t["ctx3"],
                                     t["negs3"], t["nv"], t["lrs"])
    elif name == "infer":
        vec = s0[0].clone()
        sk.infer_step(vec, s1, t["targets"], t["labels"], t["mask"], 1.0)
        return [vec.cpu()]
    elif name == "glove":
        from deeplearning4j_tpu_torch.nlp.glove import _glove_step
        st = [s0, s1, s0[:, 0].clone(), s1[:, 0].clone()]
        st += [torch.full_like(a, 1e-8) for a in st]
        loss = _glove_step(*st, t["centers"], t["targets"][:, 0],
                           t["lrs"][0].expand(len(t["centers"])),
                           t["mask"][:, 0], 0.05)
        return [a.cpu() for a in st] + [loss.cpu()]
    return [s0.cpu(), s1.cpu()]


@pytest.mark.parametrize("name", ["skipgram", "cbow", "scan", "shared",
                                  "infer", "glove"])
def test_embedding_step_on_the_card_matches_the_cpu(card, name):
    """Each device step on the card against its CPU path (1e-5 of each
    table's largest entry: the same float32 sums in another order),
    and bitwise on a second run."""
    x = _emb_inputs()
    got = _emb_step(name, x, card)
    ref = _emb_step(name, x, "cpu")
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()
    again = _emb_step(name, x, card)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_embedding_superchunk_has_no_host_sync(card):
    """A Word2Vec superchunk (upload and eight chunk steps) runs with
    every synchronizing CUDA call an error, then trains on."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    rng = np.random.default_rng(1)
    sents = [" ".join(f"w{i}" for i in rng.integers(0, 200, 40))
             for _ in range(400)]
    for kw in ({}, {"use_hierarchic_softmax": True}, {"use_cbow": True}):
        preps = []
        m = Word2Vec(layer_size=32, window_size=5, negative=5, seed=3,
                     device=card, **kw)
        m._dispatch_chunks = preps.append
        m.fit(sents)
        del m._dispatch_chunks
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            m._dispatch_chunks(preps[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(m.syn0).all()


def test_device_pair_draws_on_the_card(card):
    from deeplearning4j_tpu_torch.nlp import skipgram as sk
    table = torch.from_numpy(np.repeat(np.arange(4), [10, 20, 30, 40]).astype(
        np.int32)).to(card)
    g = torch.Generator(device=card).manual_seed(5)
    b, negs = sk.token_draws((64, 40), table, window=5, n_neg=5,
                             generator=g)
    assert b.device.type == "cuda" and int(b.min()) == 1 \
        and int(b.max()) == 5
    counts = torch.bincount(b.flatten().long(), minlength=6)[1:].double()
    assert ((counts / counts.sum() - 0.2).abs() < 0.02).all()
    freq = torch.bincount(negs.flatten().long(), minlength=4).double()
    assert torch.allclose(freq / freq.sum(), torch.tensor(
        [0.1, 0.2, 0.3, 0.4], dtype=torch.float64, device=card), atol=0.01)
    g2 = torch.Generator(device=card).manual_seed(5)
    assert torch.equal(negs, sk.token_draws((64, 40), table, window=5,
                                            n_neg=5, generator=g2)[1])


# ---- the online tier and the kernel cache on the card ---------------------


def _online_mlp(card, seed=1):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=16))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(5)).build())
    return MultiLayerNetwork(conf, device=card).init()


def test_online_snapshot_promotion_and_rollback_on_the_card(card):
    """A learner on the card: its snapshot is a CPU copy taken between
    steps, committed bitwise by a promotion and restored bitwise by a
    rollback; the copies share no storage."""
    import threading
    import time

    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.online import (OnlineServing,
                                                 publish_samples)
    from deeplearning4j_tpu_torch.streaming.broker import InProcessTransport
    transport = InProcessTransport()
    online = OnlineServing(_online_mlp(card), transport, model_name="m",
                           feature_shape=(5,), batch_limit=8,
                           holdout_every=2, registry=MetricsRegistry())
    w = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    stop = threading.Event()

    def feed():
        g = np.random.default_rng(4)
        while not stop.is_set():
            x = g.normal(size=(8, 5)).astype(np.float32)
            publish_samples(transport, "train", x,
                            np.eye(3, dtype=np.float32)[np.argmax(x @ w, 1)])
            stop.wait(0.005)
    pub = threading.Thread(target=feed, daemon=True)
    try:
        ptrs = [{t.data_ptr() for t in flatten_paths(tree).values()}
                for tree in (online.model.params,
                             online.promoter.eval_model.params,
                             online.pool.engines[0]._committed[0])]
        assert not (ptrs[0] & ptrs[1] or ptrs[0] & ptrs[2]
                    or ptrs[1] & ptrs[2])
        online.start(background_promotion=False)
        pub.start()
        deadline = time.time() + 60
        while online.learner.iterations < 10 \
                or online.stream.holdout_examples == 0:
            assert time.time() < deadline and online.learner.alive
            time.sleep(0.02)
        before = online.pool.engines[0].committed_host()
        snap = online.learner.snapshot(timeout=10)
        assert snap is not None
        assert all(t.device.type == "cpu"
                   for t in flatten_paths(snap.params).values())
        d = online.promoter.run_once(candidate=snap, force=True)
        assert d.promoted
        got = online.pool.engines[0].committed_host()
        for k, t in flatten_paths(snap.params).items():
            assert torch.equal(flatten_paths(got[0])[k], t)
        online.router.rollback_params("m")
        back = online.pool.engines[0].committed_host()
        for k, t in flatten_paths(before[0]).items():
            assert torch.equal(flatten_paths(back[0])[k], t)
    finally:
        stop.set()
        if pub.is_alive():
            pub.join(10)
        online.stop()


def test_the_served_forward_records_its_kernel_sources(card):
    """What the kernel cache persists: the sources the engine's warmup
    reaches on the card (the fused ResNet50 blocks' two forward
    libraries)."""
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    model = ResNet50(num_classes=10, height=32, width=32, channels=3,
                     fused_blocks=True, fused_impl="pallas", s2d_stem=True,
                     compute_dtype="bfloat16").init(device=card)
    with ServingEngine(model, batch_limit=2, feature_shape=(32, 32, 3),
                       registry=MetricsRegistry()) as eng:
        assert eng._reached == {"fused_mm", "fused_c3"}
    assert all(cuda_build.library_path(s).exists()
               for s in ("fused_mm", "fused_c3"))


# ---- the data-parallel wrapper at one NCCL rank (parallel/wrapper.py) ----

@pytest.fixture
def nccl_one_rank(card, tmp_path):
    """A process group of one NCCL rank on the card, for this test."""
    from deeplearning4j_tpu_torch.parallel.mesh import (
        initialize_distributed, shutdown_distributed)
    initialize_distributed("nccl", 0, 1, store_path=str(tmp_path / "store"),
                           timeout_s=60.0, device=card)
    # the stem convolution's default cuDNN backward differs from run to
    # run in the last bits; these tests compare steps bitwise
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = deterministic
    shutdown_distributed()


def _wrapper_run(card, mode, steps=4):
    """(plain trees, plain losses, wrapper model, launches) of ``steps``
    steps of 4 rows on a 32x32 bf16 fused ResNet50, plain fit against the
    wrapper in ``mode`` (averaging frequency ``steps``)."""
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.serialization import (
        flatten_paths, params_from_jax)
    from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                           TrainingMode)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    def fresh():
        m = ResNet50(num_classes=10, height=32, width=32, fused_blocks=True,
                     s2d_stem=True, compute_dtype="bfloat16").init(card)
        params_from_jax(p0, s0, card, model=m)
        return m
    first = ResNet50(num_classes=10, height=32, width=32, fused_blocks=True,
                     s2d_stem=True, compute_dtype="bfloat16").init(card)
    p0 = {k: {n: v.cpu().numpy() for n, v in lp.items()}
          for k, lp in first.params.items()}
    s0 = {k: {n: v.cpu().numpy() for n, v in lp.items()}
          for k, lp in first.model_state.items()}
    rng = np.random.default_rng(0)
    batches = [DataSet(rng.normal(0, 1, (4, 32, 32, 3)).astype(np.float32),
                       np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)])
               for _ in range(steps)]
    plain, losses = fresh(), []
    for b in batches:
        plain.fit(b)
        losses.append(plain._last_loss)
    m = fresh()
    w = (ParallelWrapper.builder(m).training_mode(TrainingMode[mode])
         .workers(1).averaging_frequency(steps).build())
    fc.reset_launch_counts()
    w.fit(ListDataSetIterator(batches))
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    trees = lambda model: {f"{g}/{k}": v for g in ("params", "model_state",
                                                   "opt_state")
                           for k, v in flatten_paths(getattr(model, g))
                           .items()}
    return trees(plain), losses, m, trees(m), launches


@pytest.mark.parametrize("mode", ["SHARED_GRADIENTS", "AVERAGING"])
def test_one_nccl_rank_takes_the_plain_fit_steps_bitwise(card, nccl_one_rank,
                                                         mode):
    """At one rank every collective is the identity: the wrapper's steps
    through kernels 1-6 are the plain fit's, bitwise (parameters, BN
    state, updater state, the dispatch's loss)."""
    ref, losses, m, got, launches = _wrapper_run(card, mode)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    want = (losses[-1] if mode == "SHARED_GRADIENTS"
            else torch.stack(losses).mean())
    assert float(m._last_loss) == float(want)
    assert launches == {"fused_mm": 144, "fused_c3": 64,
                        "fused_mm_bwd": 144, "fused_c3_bwd": 52,
                        "fused_c3_bwd_in": 12, "fused_c3_bwd_w": 12}


def test_one_nccl_rank_async_elastic_is_averaging_but_for_its_merge(
        card, nccl_one_rank):
    """ASYNC_ELASTIC without stragglers at one rank: its merge θ + (l − θ)
    rounds where l − θ is not exact: half an ulp of l − θ (at most twice
    the leaf's largest entry) and half an ulp of the sum, so each
    parameter leaf is within 2 f32 ulps of its largest entry of
    AVERAGING's; the BN state and the updater state, merged as
    (1 · l) / 1, are bitwise."""
    _, _, _, avg, _ = _wrapper_run(card, "AVERAGING")
    _, _, _, asy, launches = _wrapper_run(card, "ASYNC_ELASTIC")
    for k, v in avg.items():
        if k.startswith("params/"):
            ulp = float(np.spacing(np.float32(v.abs().max().item())))
            assert (asy[k] - v).abs().max().item() <= 2 * ulp, k
        else:
            assert torch.equal(asy[k], v), k
    assert launches["fused_mm"] == 144
