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
