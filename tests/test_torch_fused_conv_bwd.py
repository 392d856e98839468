"""The port's fused conv+BN backward (the ``autograd.Function`` around
``fused_conv_bn_act``) against ``jax.grad`` of the JAX package's op, whose
backward runs its Pallas kernels in interpret mode, on the same numpy
inputs. The loss consumes y AND the statistics through
``stats_to_scale_shift``, as ``tests/test_fused_conv.py`` does, so the
statistics cotangent reaches the kernels.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances: float32 rtol/atol 2e-4 (the JAX package's own bound for its
kernels against autodiff: the same f32 math summed in other orders).
bfloat16: gradients relative to their largest entry, 3e-2 — dyc, the
recomputed input and dx are rounded to bf16 on both sides, and a last-bit
difference in an f32 sum flips a bf16 rounding (2^-8 relative each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.fused_conv import \
    fused_conv_bn_act as jax_fused
from deeplearning4j_tpu.ops.fused_conv import \
    stats_to_scale_shift as jax_sss
from deeplearning4j_tpu_torch.ops import fused_conv as fc

BF16_TOL = 3e-2


def _mk(seed, n, h, w, cin, cout, kernel):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, h, w, cin)).astype(np.float32)
    shape = (cin, cout) if kernel == 1 else (3, 3, cin, cout)
    wt = rng.normal(0, 0.1, shape).astype(np.float32)
    s = rng.normal(1, 0.1, cin).astype(np.float32)
    b = rng.normal(0, 0.1, cin).astype(np.float32)
    return x, wt, s, b


def _jax_grads(x, wt, s, b, dtype, relu, norm, stride):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def loss(x, wt, s, b):
        y, st = jax_fused(x, wt, s, b, relu, norm, stride, True)
        inv, shift, mean, var = jax_sss(
            st, y.size // y.shape[-1], jnp.ones(y.shape[-1]),
            jnp.zeros(y.shape[-1]), 1e-5)
        z = y.astype(jnp.float32) * inv + shift
        return jnp.sum(jnp.tanh(z)) + 0.1 * jnp.sum(mean * mean) \
            + 0.1 * jnp.sum(var)
    g = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x).astype(jdt), jnp.asarray(wt).astype(jdt),
        jnp.asarray(s), jnp.asarray(b))
    return [np.asarray(a.astype(jnp.float32)) for a in g]


def _torch_loss(fn, x, wt, s, b, relu, norm, stride):
    y, st = fn(x, wt, s, b, relu, norm, stride)
    count = y.numel() // y.shape[-1]
    ones = torch.ones(y.shape[-1])
    inv, shift, mean, var = fc.stats_to_scale_shift(st, count, ones,
                                                    torch.zeros_like(ones),
                                                    1e-5)
    z = y.float() * inv + shift
    return torch.tanh(z).sum() + 0.1 * (mean * mean).sum() + 0.1 * var.sum()


def _torch_grads(x, wt, s, b, dtype, relu, norm, stride,
                 fn=fc.fused_conv_bn_act):
    tdt = getattr(torch, dtype)
    ins = [torch.from_numpy(x).to(tdt).requires_grad_(),
           torch.from_numpy(wt).to(tdt).requires_grad_(),
           torch.from_numpy(s).requires_grad_(),
           torch.from_numpy(b).requires_grad_()]
    loss = _torch_loss(fn, *ins, relu, norm, stride)
    g = torch.autograd.grad(loss, ins)
    assert g[0].dtype == tdt and g[1].dtype == tdt
    return [a.float().numpy() for a in g]


CASES = {
    "1x1 s1": dict(n=4, h=4, w=4, cin=8, cout=12, kernel=1, stride=1),
    "1x1 s2": dict(n=4, h=5, w=4, cin=8, cout=12, kernel=1, stride=2),
    "1x1 ragged M": dict(n=3, h=7, w=5, cin=24, cout=16, kernel=1,
                         stride=1),
    "3x3 merged": dict(n=4, h=4, w=4, cin=8, cout=12, kernel=3, stride=1),
    # cin > 384 takes the split route (bwd_in + bwd_w) on both sides
    "3x3 split": dict(n=2, h=2, w=2, cin=392, cout=8, kernel=3, stride=1),
}


def _compare(got, want, dtype):
    for a, r, name in zip(got, want, "x w scale shift".split()):
        assert a.shape == r.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, r, rtol=2e-4, atol=2e-4,
                                       err_msg=f"grad of {name}")
        else:
            err = np.abs(a - r).max() / max(np.abs(r).max(), 1e-6)
            assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(case, dtype):
    c = CASES[case]
    x, wt, s, b = _mk(3, c["n"], c["h"], c["w"], c["cin"], c["cout"],
                      c["kernel"])
    args = (dtype, True, True, c["stride"])
    _compare(_torch_grads(x, wt, s, b, *args), _jax_grads(x, wt, s, b, *args),
             dtype)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (1, 2), (3, 1)])
def test_backward_without_norm_matches_jax(kernel, stride):
    """norm_in=False (the block's W1 and Wds): dx = de, zero dscale and
    dshift, e = x."""
    x, wt, s, b = _mk(4, 2, 5, 4, 8, 16, kernel)
    args = ("float32", False, False, stride)
    got = _torch_grads(x, wt, s, b, *args)
    _compare(got, _jax_grads(x, wt, s, b, *args), "float32")
    assert not got[2].any() and not got[3].any()


def test_norm_without_relu_matches_jax():
    x, wt, s, b = _mk(5, 2, 4, 4, 8, 8, 3)
    args = ("float32", False, True, 1)
    _compare(_torch_grads(x, wt, s, b, *args), _jax_grads(x, wt, s, b, *args),
             "float32")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd_of_the_forward(case):
    """The port's own consistency check: the explicit backward formulas
    (the kernels' plain versions) against torch.autograd of the plain
    forward ``_conv_reference`` + ``_stats``, in f32."""
    c = CASES[case]
    x, wt, s, b = _mk(6, c["n"], c["h"], c["w"], c["cin"], c["cout"],
                      c["kernel"])
    args = ("float32", True, True, c["stride"])
    _compare(_torch_grads(x, wt, s, b, *args),
             _torch_grads(x, wt, s, b, *args, fn=fc._conv_reference),
             "float32")


@pytest.mark.parametrize("route", ["merged", "split"])
def test_three_by_three_routes_agree(route):
    """fused_c3_bwd (one launch) and fused_c3_bwd_in + fused_c3_bwd_w (two)
    compute the same function; each entry point returns its parts."""
    rng = np.random.default_rng(8)
    x, wt, s, b = (torch.from_numpy(a) for a in _mk(8, 2, 3, 4, 8, 6, 3))
    dy = torch.from_numpy(rng.normal(0, 1, (2, 3, 4, 6)).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 1, (2, 3, 4, 6)).astype(np.float32))
    dst = torch.from_numpy(rng.normal(0, 0.1, (2, 6)).astype(np.float32))
    dx, dw, dsc, dsh = fc.fused_c3_bwd(dy, y, x, wt, dst, s, b)
    if route == "split":
        dx2, dsc2, dsh2 = fc.fused_c3_bwd_in(dy, y, x, wt, dst, s, b)
        dw2 = fc.fused_c3_bwd_w(dy, y, x, dst, s, b)
        for a, r in ((dx, dx2), (dw, dw2), (dsc, dsc2), (dsh, dsh2)):
            assert torch.equal(a, r)
    else:
        assert dx.shape == x.shape and dw.shape == (3, 3, 8, 6)
        assert dsc.shape == dsh.shape == (8,)


def test_backward_routes_follow_the_jax_rule(monkeypatch):
    """1×1 → fused_mm_bwd; 3×3 with cin ≤ 384 and the normalize → the
    merged fused_c3_bwd; otherwise fused_c3_bwd_in + fused_c3_bwd_w."""
    calls = []
    for name in ("fused_mm_bwd", "fused_c3_bwd", "fused_c3_bwd_in",
                 "fused_c3_bwd_w"):
        real = getattr(fc, name)
        monkeypatch.setattr(fc, name, lambda *a, _n=name, _r=real, **k: (
            calls.append(_n), _r(*a, **k))[1])
    for cin, norm in ((8, True), (392, True), (8, False)):
        x, wt, s, b = _mk(9, 1, 2, 2, cin, 4, 3)
        _torch_grads(x, wt, s, b, "float32", True, norm, 1)
    x, wt, s, b = _mk(9, 1, 2, 2, 8, 4, 1)
    _torch_grads(x, wt, s, b, "float32", True, True, 2)
    assert calls == ["fused_c3_bwd", "fused_c3_bwd_in", "fused_c3_bwd_w",
                     "fused_c3_bwd_in", "fused_c3_bwd_w", "fused_mm_bwd"]


def test_backward_is_deterministic_and_counts_nothing_on_the_cpu():
    fc.reset_launch_counts()
    x, wt, s, b = _mk(2, 2, 4, 4, 8, 8, 3)
    a = _torch_grads(x, wt, s, b, "float32", True, True, 1)
    r = _torch_grads(x, wt, s, b, "float32", True, True, 1)
    for u, v in zip(a, r):
        np.testing.assert_array_equal(u, v)
    assert not any(fc.LAUNCHES.values())


def test_dw_chunk_is_a_function_of_the_shapes():
    # stage 0's 3×3 dW at batch 128: 9 tiles, M = 32768 rows → sliced
    c = fc.dw_chunk(9 * 64, 64, 32768)
    assert c % 16 == 0 and c >= 256 and -(-32768 // c) >= 16
    # many tiles already: one slice over all of M
    assert fc.dw_chunk(9 * 512, 512, 512) >= 512
    assert fc.dw_chunk(64, 64, 7) == 16


def test_dx_slices_is_a_function_of_the_shapes():
    # stage 4's 3×3 backward-input at batch 32 and 128: M = 4·B rows,
    # Cin 512, depth 9·512; 16 and 64 tiles of 64×64
    assert fc.dx_slices(128, 512, 4608) == (16, 288)
    assert fc.dx_slices(512, 512, 4608) == (5, 928)
    assert fc.dx_slices(128, 512, 4608) == fc.dx_slices(128, 512, 4608)
    for m, cin in ((128, 512), (512, 512)):
        tiles = -(-m // 64) * -(-cin // 64)
        slices = fc.dx_slices(m, cin, 4608)[0]
        assert 132 <= tiles * slices <= 2 * 264       # about two per SM
    # many tiles already: one slice over the whole depth
    assert fc.dx_slices(32768, 512, 4608) == (1, 4608)


@pytest.mark.parametrize("m,cin,depth", [
    (128, 512, 4608), (512, 512, 4608), (45, 520, 648), (1, 8, 9),
    (7, 3, 117), (200, 64, 9 * 1000), (32768, 64, 576)])
def test_dx_slices_cover_the_depth(m, cin, depth):
    slices, per = fc.dx_slices(m, cin, depth)
    assert per % fc.DX_STEP == 0 and fc.DX_STEP % 16 == 0   # MMA k16 steps
    assert slices >= 1 and (slices - 1) * per < depth <= slices * per
    bounds = [(s * per, min(depth, (s + 1) * per)) for s in range(slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == depth
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(e > b for b, e in bounds)


@pytest.mark.parametrize("m,cin,cout", [(128, 512, 512), (45, 520, 72),
                                        (17, 8, 13)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dx_plan_matches_the_row_tiles(m, cin, cout, bf16):
    plan = fc.dx_plan(m, cin, cout, True, bf16)
    assert (plan.slices, plan.depth) == fc.dx_slices(m, cin, 9 * cout)
    # one (Σdpre·x, Σdpre) row per DX_SUM_ROWS-row tile of the epilogue
    tiles = plan.row_tiles
    assert (tiles - 1) * fc.DX_SUM_ROWS < m <= tiles * fc.DX_SUM_ROWS
    # disjoint, ordered, 16-byte aligned segments of one f32 buffer
    ends = [plan.slices * m * cin, plan.partial + tiles * 2 * cin,
            plan.sums + 2 * cin, plan.dyc + (-(-m * cout // 2) if bf16 else 0)]
    starts = [0, plan.partial, plan.sums, plan.dyc]
    assert all(a % 4 == 0 for a in starts)
    assert all(e <= b for e, b in zip(ends, starts[1:]))
    assert ends[-1] <= plan.size < ends[-1] + 4
    no_norm = fc.dx_plan(m, cin, cout, False, bf16)
    assert no_norm.row_tiles == 0 and no_norm.partial == no_norm.sums


@pytest.mark.parametrize("m,cin,cout", [
    (8192, 64, 64), (2048, 128, 128), (512, 256, 256), (128, 512, 512),
    (32768, 64, 64), (70, 24, 40), (9, 5, 13)])
def test_c3_bwd_plan_shares_the_dx_slices_and_cuts_dw_by_pixels(m, cin,
                                                                cout):
    plan = fc.c3_bwd_plan(m, cin, cout, True)
    # the dx product is the split route's: the same K slices
    dx = fc.dx_plan(m, cin, cout, True, True)
    assert (plan.slices, plan.depth) == (dx.slices, dx.depth)
    # BN-sum row tiles of whole 16-row groups that cover M, no more than
    # about two per SM once M is large (each is added in order)
    rows, tiles = plan.tile_rows, plan.row_tiles
    assert rows % fc.DX_SUM_ROWS == 0 and rows >= fc.DX_SUM_ROWS
    assert (tiles - 1) * rows < m <= tiles * rows
    assert tiles <= 264 or rows == fc.DX_SUM_ROWS
    # dW slices: whole MMA steps of pixels that cover M, about as many
    # as dw_chunk gives, none empty
    assert plan.dw_chunk % fc.DX_STEP == 0
    assert plan.dw_chunk >= fc.dw_chunk(9 * cin, cout, m)
    assert (plan.dw_slices - 1) * plan.dw_chunk < m <= \
        plan.dw_slices * plan.dw_chunk
    # disjoint, ordered, 16-byte aligned segments of one f32 buffer
    dw_planes = plan.dw_slices * 9 * cin * cout if plan.dw_slices > 1 else 0
    starts = [0, plan.dw_ws, plan.dw, plan.partial, plan.sums, plan.dyc]
    ends = [plan.slices * m * cin, plan.dw_ws + dw_planes,
            plan.dw + 9 * cin * cout, plan.partial + plan.row_tiles * 2 * cin,
            plan.sums + 2 * cin, plan.dyc + -(-m * cout // 2)]
    assert all(a % 4 == 0 for a in starts)
    assert all(e <= b for e, b in zip(ends, starts[1:]))
    assert ends[-1] <= plan.size < ends[-1] + 4
    no_norm = fc.c3_bwd_plan(m, cin, cout, False)
    assert no_norm.row_tiles == 0 and no_norm.partial == no_norm.sums


def test_c3_bwd_plan_is_a_function_of_the_shapes():
    # the path's merged-route shapes at batch 32: about two blocks per SM
    # in each product
    for m, cin in ((8192, 64), (2048, 128), (512, 256)):
        plan = fc.c3_bwd_plan(m, cin, cin, True)
        assert plan == fc.c3_bwd_plan(m, cin, cin, True)
        dw_tiles = -(-9 * cin // 64) * -(-cin // 64)
        assert 132 <= dw_tiles * plan.dw_slices <= 2 * 264
        dx_tiles = -(-m // 64) * -(-cin // 64)
        assert 132 <= dx_tiles * plan.slices <= 2 * 264
    # stage 4 at batch 32: one dW slice (576 tiles already)
    assert fc.c3_bwd_plan(128, 512, 512, True).dw_slices == 1
