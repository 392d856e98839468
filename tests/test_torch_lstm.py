"""The port's fused LSTM op (ops/fused_lstm.py) and LSTM layer
(nn/layers/recurrent.py) against the JAX package's on the same numpy
inputs, on the CPU: the JAX op runs its Pallas kernels in interpret mode
(as tests/test_pallas_lstm.py runs them), the port's wrappers run their
plain versions because the tensors lie on the CPU.

Tolerances (ROADMAP's f32 defaults): forward outputs rel 1e-5, gradients
rel 1e-4, each with an absolute floor of the same size times the largest
reference magnitude. bfloat16: both sides round the same f32 values to
bf16 at the same places (at these shapes the results are bitwise equal),
but their f32 sums of h@Wh may run in other orders, so a result can land
one bf16 ulp apart: rel and abs 2^-7 of the largest magnitude, one bf16
ulp at 1. The port's own backward against torch.autograd through its
forward runs in float64 (rel 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers.base import LayerContext as JCtx
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.ops import pallas_lstm
from deeplearning4j_tpu.ops.activations import Activation as JAct
from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
from deeplearning4j_tpu_torch.nn.layers.base import LayerContext
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
from deeplearning4j_tpu_torch.ops import fused_lstm as fl
from deeplearning4j_tpu_torch.ops.activations import Activation

T, N, H = 7, 4, 8
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}


def _np_inputs(seed, t=T, n=N, h=H):
    rng = np.random.default_rng(seed)
    return dict(zx=rng.normal(size=(t, n, 4 * h)).astype(np.float32),
                h0=rng.normal(size=(n, h)).astype(np.float32),
                c0=rng.normal(size=(n, h)).astype(np.float32),
                wh=(0.3 * rng.normal(size=(h, 4 * h))).astype(np.float32),
                mask=(rng.random((t, n)) > 0.3).astype(np.float32),
                dys=rng.normal(size=(t, n, h)).astype(np.float32),
                dhT=rng.normal(size=(n, h)).astype(np.float32),
                dcT=rng.normal(size=(n, h)).astype(np.float32))


def _close(got, want, rel, what):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_mask", [False, True])
def test_lstm_fused_matches_jax(dtype, use_mask):
    a = _np_inputs(0)
    fwd_tol, grad_tol = TOL[dtype]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    names = ("zx", "h0", "c0", "wh")
    jargs = [jnp.asarray(a[k], jdt) for k in names]
    jmask = jnp.asarray(a["mask"], jdt) if use_mask else None
    (ys, hT, cT), vjp = jax.vjp(
        lambda zx, h0, c0, wh: pallas_lstm.lstm_fused(zx, h0, c0, wh,
                                                      jmask), *jargs)
    cts = (jnp.asarray(a["dys"], jdt), jnp.asarray(a["dhT"], jdt),
           jnp.asarray(a["dcT"], jdt))
    jgrads = vjp(cts)

    targs = [torch.tensor(a[k]).to(tdt).requires_grad_() for k in names]
    tmask = torch.tensor(a["mask"]).to(tdt) if use_mask else None
    tys, thT, tcT = fl.lstm_fused(*targs, tmask)
    assert tys.dtype == tdt and thT.dtype == tdt
    for got, want, what in ((tys, ys, "ys"), (thT, hT, "hT"),
                            (tcT, cT, "cT")):
        _close(got, want, fwd_tol, what)
    tgrads = torch.autograd.grad(
        (tys, thT, tcT), targs,
        [torch.tensor(a[k]).to(tdt) for k in ("dys", "dhT", "dcT")])
    for got, want, what in zip(tgrads, jgrads, names):
        assert got.dtype == tdt
        _close(got, want, grad_tol, f"d{what}")


def test_masked_tick_freezes_the_carry():
    a = _np_inputs(1)
    mask = np.ones((T, N), np.float32)
    mask[3:, 1] = 0.0          # row 1 stops after tick 2
    mask[2, 2] = 0.0           # row 2 skips tick 2
    ys, gates, tcs, ccs, hT, cT = fl.lstm_fwd_reference(
        *(torch.tensor(a[k]) for k in ("zx", "h0", "c0", "wh")),
        torch.tensor(mask)[:, :, None])
    for t in range(3, T):
        assert torch.equal(ys[t, 1], ys[2, 1])
        assert torch.equal(ccs[t, 1], ccs[2, 1])
    assert torch.equal(hT[1], ys[2, 1]) and torch.equal(cT[1], ccs[2, 1])
    assert torch.equal(ys[2, 2], ys[1, 2])
    assert not torch.equal(ys[3, 2], ys[2, 2])


@pytest.mark.parametrize("use_mask", [False, True])
def test_bwd_reference_matches_autograd_in_f64(use_mask):
    a = _np_inputs(2)
    args = [torch.tensor(a[k], dtype=torch.float64, requires_grad=True)
            for k in ("zx", "h0", "c0", "wh")]
    mask3 = (torch.tensor(a["mask"], dtype=torch.float64)[:, :, None]
             if use_mask else None)
    ys, gates, tcs, ccs, hT, cT = fl.lstm_fwd_reference(*args, mask3)
    cts = [torch.tensor(a[k], dtype=torch.float64)
           for k in ("dys", "dhT", "dcT")]
    want = torch.autograd.grad((ys, hT, cT), args, cts)
    zx, h0, c0, wh = args
    hprev = torch.cat([h0[None], ys[:-1]]).detach()
    cprev = torch.cat([c0[None], ccs[:-1]]).detach()
    dzx, dwh, dh0, dc0 = fl.lstm_bwd_reference(
        *cts, gates.detach(), tcs.detach(), cprev, hprev, mask3,
        wh.detach())
    assert dwh.dtype == torch.float64
    for got, w in zip((dzx, dh0, dc0, dwh), (want[0], want[1], want[2],
                                             want[3])):
        torch.testing.assert_close(got, w, rtol=1e-10, atol=1e-10)


def _layer_pair(seed, gate_layout="gate_major", activation="TANH"):
    rng = np.random.default_rng(seed)
    f = 5
    p = {"Wx": (0.4 * rng.normal(size=(f, 4 * H))).astype(np.float32),
         "Wh": (0.3 * rng.normal(size=(H, 4 * H))).astype(np.float32),
         "b": (0.1 * rng.normal(size=(4 * H,))).astype(np.float32)}
    x = rng.normal(size=(N, T, f)).astype(np.float32)
    mask = (rng.random((N, T)) > 0.25).astype(np.float32)
    h0 = rng.normal(size=(N, H)).astype(np.float32)
    c0 = rng.normal(size=(N, H)).astype(np.float32)
    jl = JLSTM(n_in=f, n_out=H, gate_layout=gate_layout,
               activation=getattr(JAct, activation))
    tl = LSTM(n_in=f, n_out=H, gate_layout=gate_layout,
              activation=getattr(Activation, activation))
    return jl, tl, p, x, mask, h0, c0


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_layer_apply_matches_jax_fused(monkeypatch, use_mask, with_state):
    monkeypatch.setenv("DL4J_LSTM_IMPL", "fused")
    jl, tl, p, x, mask, h0, c0 = _layer_pair(3)
    init = (h0, c0) if with_state else None
    m = mask if use_mask else None
    jy, js = jl.apply({k: jnp.asarray(v) for k, v in p.items()}, {},
                      jnp.asarray(x), JCtx(mask=None if m is None
                                           else jnp.asarray(m)),
                      initial_state=None if init is None
                      else tuple(jnp.asarray(v) for v in init))
    ty, ts = tl.apply({k: torch.tensor(v) for k, v in p.items()}, {},
                      torch.tensor(x), LayerContext(
                          mask=None if m is None else torch.tensor(m)),
                      initial_state=None if init is None
                      else tuple(torch.tensor(v) for v in init))
    _close(ty, jy, 1e-5, "y")
    _close(ts["last_h"], js["last_h"], 1e-5, "last_h")
    _close(ts["last_c"], js["last_c"], 1e-5, "last_c")
    if use_mask:
        assert not ty[torch.tensor(mask) == 0].any()


@pytest.mark.parametrize("gate_layout,activation", [
    ("hidden_major", "TANH"), ("gate_major", "SOFTSIGN")])
def test_ineligible_layer_runs_the_loop_and_matches_jax(
        monkeypatch, gate_layout, activation):
    calls = []
    monkeypatch.setattr(fl, "lstm_fwd_reference",
                        lambda *a: calls.append(1))
    jl, tl, p, x, mask, h0, c0 = _layer_pair(4, gate_layout, activation)
    assert not tl._fused_eligible() and not jl._fused_eligible()
    jy, js = jl.apply({k: jnp.asarray(v) for k, v in p.items()}, {},
                      jnp.asarray(x), JCtx(mask=jnp.asarray(mask)))
    ty, ts = tl.apply({k: torch.tensor(v) for k, v in p.items()}, {},
                      torch.tensor(x), LayerContext(mask=torch.tensor(mask)))
    assert not calls
    _close(ty, jy, 1e-5, "y")
    _close(ts["last_c"], js["last_c"], 1e-5, "last_c")


def test_step_one_matches_jax():
    jl, tl, p, x, mask, h0, c0 = _layer_pair(5)
    jh, jc = jl.step_one({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x[:, 0]),
                         (jnp.asarray(h0), jnp.asarray(c0)))
    th, tc = tl.step_one({k: torch.tensor(v) for k, v in p.items()},
                         torch.tensor(x[:, 0]),
                         (torch.tensor(h0), torch.tensor(c0)))
    _close(th, jh, 1e-5, "h")
    _close(tc, jc, 1e-5, "c")


def test_cpu_layer_reaches_the_plain_versions(monkeypatch):
    """An eligible layer on CPU tensors goes through lstm_fused, whose
    wrappers run the plain versions (forward and backward) and launch
    nothing."""
    seen = []
    for name in ("lstm_fwd_reference", "lstm_bwd_reference"):
        orig = getattr(fl, name)
        monkeypatch.setattr(fl, name, lambda *a, _o=orig, _n=name: (
            seen.append(_n), _o(*a))[1])
    fl.reset_launch_counts()
    _, tl, p, x, mask, _, _ = _layer_pair(6)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y, _ = tl.apply(tp, {}, torch.tensor(x),
                    LayerContext(mask=torch.tensor(mask)))
    y.square().sum().backward()
    assert seen == ["lstm_fwd_reference", "lstm_bwd_reference"]
    assert all(v is not None for v in (tp["Wx"].grad, tp["Wh"].grad))
    assert fl.LAUNCHES == {"lstm_fwd": 0, "lstm_bwd": 0}


def test_initialize_sets_the_forget_bias():
    l = LSTM(n_in=3, n_out=4, forget_gate_bias_init=1.0)
    p = l.initialize(torch.Generator().manual_seed(0), RecurrentType(3, 5))
    assert p["Wx"].shape == (3, 16) and p["Wh"].shape == (4, 16)
    assert torch.equal(p["b"][4:8], torch.ones(4))
    assert not p["b"][:4].any() and not p["b"][8:].any()
    hm = LSTM(n_in=3, n_out=4, gate_layout="hidden_major").initialize(
        torch.Generator().manual_seed(0), RecurrentType(3, 5))["b"]
    assert torch.equal(hm.reshape(4, 4)[:, 1], torch.ones(4))
