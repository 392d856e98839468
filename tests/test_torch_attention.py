"""The port's flash attention against the JAX package on the CPU.

The same seeded numpy inputs go through the JAX package's Pallas flash
kernels in interpret mode (``block_q = block_k = 16``, as
``tests/test_pallas_kernels.py`` runs them; the backward through
``jax.grad``, i.e. the Pallas dk/dv and dq kernels) and through the port's
``flash_attention`` on CPU tensors, which runs the plain versions of the
port's three CUDA kernels: forward output, lse, dq, dk and dv. Cases:
causal or not, a key mask with a fully masked batch row, T = 37 (ragged
against the 16-row blocks) and T = 32, float32 and bfloat16.

Bounds, relative to max(1, the largest reference magnitude): float32 2e-5
(the bound of ``tests/test_pallas_kernels.py``: the same f32 products
summed in another order); bfloat16 2^-7, one bf16 ulp at the largest
magnitude (both sides compute in f32 from the same bf16 inputs and round
once at the end, where a last-bit difference can flip the rounding); lse
is f32 on both sides and held to 2e-5. Also: the two packages' plain
``scaled_dot_product_attention`` (f32, 1e-5), and the port's custom
backward against ``torch.autograd`` through its plain forward in float64
(1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.layers.attention import \
    scaled_dot_product_attention
from deeplearning4j_tpu_torch.ops import flash_attention as fa

N, H, DH, BLOCK = 2, 3, 16, 16
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}


def _inputs(t, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(N, t, H, DH)).astype(np.float32)
                  for _ in range(4))
    mask = None
    if masked:
        mask = (rng.random((N, t)) > 0.3).astype(np.float32)
        mask[1] = 0.0                       # a fully masked batch row
    return q, k, v, g, mask


def _jax_flash(q, k, v, g, mask, causal, dtype):
    """(out, lse, dq, dk, dv) of the JAX package's Pallas kernels in
    interpret mode."""
    from deeplearning4j_tpu.ops import pallas_kernels as pk
    jdt = getattr(jnp, dtype)
    q, k, v, g = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    t = q.shape[1]
    jmask = None if mask is None else jnp.asarray(mask)
    fwd = lambda q, k, v: pk.flash_attention(
        q, k, v, mask=jmask, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True)
    out, vjp = jax.vjp(fwd, q, k, v)
    dq, dk, dv = vjp(g)
    # lse from the forward kernel itself, on the padded NHTD layout the
    # public function builds
    pad = (-t) % BLOCK
    nhtd = lambda a: jnp.pad(jnp.swapaxes(a, 1, 2),
                             ((0, 0), (0, 0), (0, pad), (0, 0)))
    m = jnp.ones((N, t), jnp.float32) if jmask is None else jmask
    _, lse = pk._flash_forward(nhtd(q), nhtd(k), nhtd(v),
                               jnp.pad(m, ((0, 0), (0, pad))), causal,
                               BLOCK, BLOCK, True)
    return [np.asarray(a.astype(jnp.float32))
            for a in (out, lse[:, :, :t], dq, dk, dv)]


def _port_flash(q, k, v, g, mask, causal, dtype):
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.tensor(mask)
    out = fa.flash_attention(q, k, v, tmask, causal)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v),
                                     torch.tensor(g).to(tdt))
    _, lse = fa.flash_fwd(q.detach(), k.detach(), v.detach(),
                          None if tmask is None else tmask.float(), causal)
    return out, lse, dq, dk, dv


def _close(got, want, tol, what):
    assert tuple(got.shape) == want.shape, what
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("t", [37, 32])
def test_flash_matches_jax_pallas_kernels(t, masked, causal, dtype):
    q, k, v, g, mask = _inputs(t, masked)
    want = _jax_flash(q, k, v, g, mask, causal, dtype)
    got = _port_flash(q, k, v, g, mask, causal, dtype)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        tol = 2e-5 if name == "lse" else TOL[dtype]
        _close(a, b, tol, name)
    out, lse = got[0], got[1]
    assert out.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    if masked:
        # the fully masked row: zeros, lse = _NEG, zero gradients
        assert not out[1].any() and (lse[1] == fa._NEG).all()
        assert not got[2][1].any()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_attention_matches_jax(masked, causal):
    from deeplearning4j_tpu.nn.layers.attention import \
        scaled_dot_product_attention as jax_sdpa
    q, k, v, _, mask = _inputs(37, masked, seed=1)
    want = np.asarray(jax_sdpa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), causal=causal))
    got = scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        mask=None if mask is None else torch.tensor(mask), causal=causal)
    _close(got, want, 1e-5, "sdpa")
    flash = fa.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        None if mask is None else torch.tensor(mask), causal)
    _close(flash, want, 2e-5, "flash vs plain")


@pytest.mark.parametrize("causal", [False, True])
def test_custom_backward_matches_autograd_in_float64(causal):
    q, k, v, g, mask = _inputs(37, True, seed=2)
    mask[0, :4] = 0.0
    ts = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
          for a in (q, k, v)]
    tmask = torch.tensor(mask)
    gt = torch.tensor(g, dtype=torch.float64)
    got = torch.autograd.grad(fa.flash_attention(*ts, tmask, causal), ts, gt)
    ref_out, _ = fa.flash_fwd_reference(*ts, tmask, causal)
    want = torch.autograd.grad(ref_out, ts, gt)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_flash_attention_on_the_cpu_launches_nothing():
    q, k, v, _, mask = _inputs(20, True, seed=3)
    q, k, v, m = (torch.tensor(a) for a in (q, k, v, mask))
    fa.reset_launch_counts()
    flash = fa.flash_attention(q, k, v, m)
    plain = scaled_dot_product_attention(q, k, v, mask=m)
    torch.testing.assert_close(flash, plain, rtol=2e-5, atol=2e-5)
    # CPU tensors run the plain versions: no kernel launched
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                           "flash_bwd_dq": 0}


def test_reference_shapes_and_dtypes():
    q, k, v, g, mask = _inputs(37, True, seed=4)
    q, k, v, g, m = (torch.tensor(a).bfloat16() for a in (q, k, v, g, mask))
    out, lse = fa.flash_fwd_reference(q, k, v, m.float())
    assert out.dtype == torch.bfloat16 and out.shape == (N, 37, H, DH)
    assert lse.dtype == torch.float32 and lse.shape == (N, H, 37)
    delta = fa.attention_delta(g, out)
    assert delta.dtype == torch.float32 and delta.shape == (N, H, 37)
    dk, dv = fa.flash_bwd_dkv_reference(q, k, v, m.float(), g, lse, delta)
    dq = fa.flash_bwd_dq_reference(q, k, v, m.float(), g, lse, delta)
    for a in (dq, dk, dv):
        assert a.dtype == torch.bfloat16 and a.shape == (N, 37, H, DH)


@pytest.mark.parametrize("dh,offset,want", [
    (64, 0, True), (16, 0, True), (100, 0, False), (4, 0, False),
    (64, 1, False)])
def test_vector_loads_follows_the_views_alignment(dh, offset, want):
    # q, k, v as SelfAttentionLayer cuts them from a packed (N, T, H, 3, Dh)
    # projection; ``offset`` shifts the packed tensor by whole elements
    n, t, h = 2, 8, 3
    buf = torch.zeros(offset + n * t * h * 3 * dh, dtype=torch.bfloat16)
    qkv = buf[offset:].view(n, t, h, 3, dh)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    assert fa.vector_loads(q, k, v) is want
    f32 = qkv.float()
    assert fa.vector_loads(f32[:, :, :, 0], f32[:, :, :, 1],
                           f32[:, :, :, 2]) is (dh % 4 == 0)
    # the backward's four-tensor form: a contiguous dO leaves the answer
    # to q, k and v; a dO shifted by one element rules 16-byte loads out
    do = torch.zeros((n, t, h, dh), dtype=torch.bfloat16)
    assert fa.vector_loads(q, k, v, do) is want
    shifted = torch.zeros(1 + do.numel(), dtype=torch.bfloat16)[1:]
    assert fa.vector_loads(q, k, v, shifted.view(n, t, h, dh)) is False


@pytest.mark.parametrize("dtype,do_offset,want", [
    (torch.bfloat16, 0, [1, 1]), (torch.bfloat16, 1, [1, 0]),
    (torch.float32, 0, [0, 0])])
def test_backward_wrappers_pass_the_bf16_and_vec_flags(dtype, do_offset,
                                                       want):
    # (bf16, vec) as flash_bwd_dkv and flash_bwd_dq hand them to the
    # kernels, then the (n, t, h) strides of q, k, v and dO
    n, t, h, dh = 2, 8, 3, 64
    qkv = torch.zeros((n, t, h, 3, dh), dtype=dtype)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.zeros(do_offset + n * t * h * dh, dtype=dtype)[do_offset:] \
        .view(n, t, h, dh)
    rows = torch.zeros((n, h, t))
    shape, flags = fa._bwd_args("flash_bwd_dkv", q, k, v, None, do, rows,
                                rows)
    assert shape == (n, t, t, h, dh)
    assert flags[:2] == want
    assert flags[2:] == [t * h * 3 * dh, h * 3 * dh, 3 * dh] * 3 + [
        t * h * dh, h * dh, dh]
