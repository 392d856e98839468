"""Flash attention, forward and backward.

The port of the JAX package's ``ops/pallas_kernels.py``: blockwise
attention on (N, T, H, Dh) tensors with an (N, T_k) key-validity mask and
an optional causal mask, with an online softmax in f32, so the (Tq, Tk)
score matrix never reaches device memory. The forward returns the output
in q's dtype and the f32 log-sum-exp ``lse`` (N, H, Tq); the backward
recomputes p from ``lse`` in two passes, dk/dv per key tile and dq per
query tile, after ``delta = rowsum(dO ⊙ O)`` in f32 as plain torch (the
JAX package leaves it to XLA).

The TPU kernels' masking rules hold: a masked key (and, causal, a key
after the query) gets the large finite score ``_NEG``; a row that never
saw a valid key gives out = 0 and lse = ``_NEG``, and the backward zeroes
p where lse <= ``_NEG`` / 2.

Three hand-written CUDA kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
sm_90a) do the work on the card; all three multiply bf16 inputs on the
tensor cores, staging with 16-byte loads where ``vector_loads`` allows. They read q, k, v and dO through their strides, so the views
``SelfAttentionLayer`` cuts from its packed projection need no copy,
take their own 64-row tiles and mask the ragged edge themselves: the TPU
block sizes and Mosaic padding rules are not carried over. Beside each is
its plain PyTorch version
(``flash_fwd_reference``, ``flash_bwd_dkv_reference``,
``flash_bwd_dq_reference``): the wrappers use it for a tensor on the CPU
and only there. A CUDA tensor launches the kernel or raises; nothing falls
back. The JAX package's dispatch (its TPU-measured ``_FLASH_MIN_SEQ``,
the ``try``/``except`` fallback and ``DL4J_FLASH_BWD``) is not carried
over: ``SelfAttentionLayer`` calls ``flash_attention`` for every call, and
the plain full-softmax path is
``nn.layers.attention.scaled_dot_product_attention``.

Each wrapper counts its launches in ``LAUNCHES`` (a plain integer per
kernel, incremented once per launch and nowhere else).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_build

# large-finite instead of -inf: -inf scores make the backward emit NaN for
# fully masked rows
_NEG = float(torch.finfo(torch.float32).min) / 2.0
MAX_HEAD_DIM = 128
# key block of the plain forward's online softmax and of the plain
# backward's loop
_REF_BLOCK = 128

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0}
_launch_lock = threading.Lock()
_DTYPES = (torch.float32, torch.bfloat16)


def reset_launch_counts():
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str):
    with _launch_lock:
        LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

def _acc(dtype: torch.dtype) -> torch.dtype:
    """f32, or f64 for f64 inputs (gradient checks)."""
    return torch.promote_types(torch.float32, dtype)


def _heads_first(t: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    return t.to(acc).permute(0, 2, 1, 3)          # (N, H, T, Dh)


def _masked(s, mask, causal: bool, k0: int):
    """Scores (N, H, Tq, bk) of the key block at ``k0`` with masked keys
    (and, causal, keys after the query) set to ``_NEG``."""
    tq, bk = s.shape[2], s.shape[3]
    ok = None
    if mask is not None:
        ok = (mask[:, k0:k0 + bk] > 0)[:, None, None, :]
    if causal:
        kpos = k0 + torch.arange(bk, device=s.device)
        c = kpos[None, :] <= torch.arange(tq, device=s.device)[:, None]
        ok = c if ok is None else ok & c
    return s if ok is None else torch.where(ok, s, _NEG)


def flash_fwd_reference(q, k, v, mask=None, causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in q's dtype (N, Tq, H, Dh), lse f32 (N, H, Tq)): the online
    softmax over key blocks, in f32, with the TPU kernel's rules
    (``_flash_fwd_kernel``)."""
    acc = _acc(q.dtype)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf = (_heads_first(t, acc) for t in (q, k, v))
    n, h, tq, dh = qf.shape
    m = torch.full((n, h, tq, 1), _NEG, dtype=acc, device=q.device)
    l = torch.zeros((n, h, tq, 1), dtype=acc, device=q.device)
    o = torch.zeros((n, h, tq, dh), dtype=acc, device=q.device)
    for k0 in range(0, kf.shape[2], _REF_BLOCK):
        kb = kf[:, :, k0:k0 + _REF_BLOCK]
        s = _masked(qf @ kb.transpose(-1, -2) * scale, mask, causal, k0)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p @ vf[:, :, k0:k0 + _REF_BLOCK]
        m = m_new
    valid = m > _NEG * 0.5
    l_safe = torch.where(l > 0, l, 1.0)
    out = torch.where(valid, o / l_safe, 0.0)
    lse = torch.where(valid, m + torch.log(l_safe), _NEG)[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _bwd_blocks(q, k, v, mask, do, lse, delta, causal):
    """(k0, ds, p, q, dO, the key block) of every key block: the shared
    part of ``_flash_bwd_xla``, in f32."""
    acc = _acc(q.dtype)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf, dof = (_heads_first(t, acc) for t in (q, k, v, do))
    lse4 = lse.to(acc)[..., None]
    delta4 = delta.to(acc)[..., None]
    for k0 in range(0, kf.shape[2], _REF_BLOCK):
        kb = kf[:, :, k0:k0 + _REF_BLOCK]
        s = _masked(qf @ kb.transpose(-1, -2) * scale, mask, causal, k0)
        # fully masked rows carry lse == _NEG: exp(s - lse) degenerates to
        # 1 there; their true probabilities (and grads) are zero
        p = torch.where(lse4 > _NEG * 0.5, torch.exp(s - lse4), 0.0)
        dp = dof @ vf[:, :, k0:k0 + _REF_BLOCK].transpose(-1, -2)
        ds = p * (dp - delta4) * scale
        yield ds, p, qf, dof, kb


def flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta,
                            causal: bool = False):
    """(dk, dv) in k's and v's dtypes: per key block, dv = pᵀ dO and
    dk = dsᵀ q (the dk/dv half of ``_flash_bwd_xla``)."""
    dks, dvs = [], []
    for ds, p, qf, dof, _ in _bwd_blocks(q, k, v, mask, do, lse, delta,
                                         causal):
        dvs.append(p.transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_reference(q, k, v, mask, do, lse, delta,
                           causal: bool = False):
    """dq in q's dtype: the sum over key blocks of ds k (the dq half of
    ``_flash_bwd_xla``)."""
    dq = None
    for ds, _, _, _, kb in _bwd_blocks(q, k, v, mask, do, lse, delta,
                                       causal):
        part = ds @ kb
        dq = part if dq is None else dq + part
    return dq.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _strides(name, what, t):
    """The (n, t, h) strides of an (N, T, H, Dh) view whose last dimension
    is contiguous."""
    if t.stride(3) != 1 and t.shape[3] != 1:
        raise ValueError(f"{name}: {what} needs a contiguous last dimension,"
                         f" got strides {t.stride()}")
    return list(t.stride()[:3])


def _check(name, q, k, v, mask, do=None, lse=None, delta=None):
    """Device, dtype, shape and layout of every kernel argument."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (N, T, H, Dh), got "
                         f"{tuple(q.shape)}")
    n, tq, h, dh = q.shape
    tk = k.shape[1] if k.dim() == 4 else -1
    want = {"q": (n, tq, h, dh), "k": (n, tk, h, dh), "v": (n, tk, h, dh),
            "do": (n, tq, h, dh)}
    for what, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected "
                             f"{q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v and dO must share float32 or "
                            f"bfloat16, got {what} {t.dtype}")
        if tuple(t.shape) != want[what]:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {want[what]}")
    if min(n, tq, tk, h, dh) <= 0 or dh > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the kernel takes 1 <= Dh <= "
                         f"{MAX_HEAD_DIM} and non-empty shapes, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    f32 = {"mask": (mask, (n, tk)), "lse": (lse, (n, h, tq)),
           "delta": (delta, (n, h, tq))}
    for what, (t, shape) in f32.items():
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous float32 "
                             f"{shape} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return n, tq, tk, h, dh


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(name, err, shape):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} at q (N, T, H, Dh) = {shape}")


def _device(name, q):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def vector_loads(*tensors) -> bool:
    """Whether the bf16 kernels may stage these (N, T, H, Dh) views (q, k
    and v for ``flash_fwd``; q, k, v and dO for the backward pair) with
    16-byte loads: Dh a multiple of 8 and every base address and (n, t, h)
    stride a multiple of 16 bytes. The views of the packed (N, T, H, 3, Dh)
    projection pass at Dh 64; the kernels stage with 2-byte loads where
    they do not."""
    vec = 16 // tensors[0].element_size()
    return tensors[0].shape[3] % vec == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % vec == 0 for st in t.stride()[:3])
        for t in tensors)


def flash_fwd(q, k, v, mask=None, causal: bool = False):
    """``flash_fwd_reference`` as one launch of ``csrc/flash_fwd.cu`` for
    CUDA tensors: q (N, Tq, H, Dh), k and v (N, Tk, H, Dh) in one dtype
    (float32 or bfloat16, strided views with a contiguous last
    dimension), mask a contiguous float32 (N, Tk) or None. Returns
    (out, lse) as the plain version does."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, mask, causal)
    _device("flash_fwd", q)
    n, tq, tk, h, dh = _check("flash_fwd", q, k, v, mask)
    out = torch.empty((n, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((n, h, tq), dtype=torch.float32, device=q.device)
    strides = (_strides("flash_fwd", "q", q) + _strides("flash_fwd", "k", k)
               + _strides("flash_fwd", "v", v))
    bf16 = q.dtype == torch.bfloat16        # the f32 body ignores vec
    err = cuda_build.kernel("flash_fwd")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(out), _ptr(lse),
        n, tq, tk, h, dh, int(causal), int(bf16),
        int(bf16 and vector_loads(q, k, v)), *strides,
        cuda_build.current_stream(q.device))
    _raise_on("flash_fwd", err, (n, tq, h, dh))
    _count("flash_fwd")
    return out, lse


def _bwd_args(name, q, k, v, mask, do, lse, delta):
    """(n, tq, tk, h, dh), then the bf16 and vec flags and the strides as
    the C entry points take them."""
    n, tq, tk, h, dh = _check(name, q, k, v, mask, do, lse, delta)
    strides = [s for what, t in (("q", q), ("k", k), ("v", v), ("do", do))
               for s in _strides(name, what, t)]
    bf16 = q.dtype == torch.bfloat16        # the f32 bodies ignore vec
    return (n, tq, tk, h, dh), [int(bf16),
                                int(bf16 and vector_loads(q, k, v, do)),
                                *strides]


def flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal: bool = False):
    """``flash_bwd_dkv_reference`` as one launch of ``csrc/flash_bwd.cu``
    for CUDA tensors: dO in q's dtype and layout rules, lse and delta
    contiguous float32 (N, H, Tq). Returns (dk, dv), contiguous."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta, causal)
    _device("flash_bwd_dkv", q)
    (n, tq, tk, h, dh), flags = _bwd_args("flash_bwd_dkv", q, k, v, mask,
                                          do, lse, delta)
    dk = torch.empty((n, tk, h, dh), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stream = cuda_build.current_stream(q.device)
    err = cuda_build.kernel("flash_bwd_dkv")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dk), _ptr(dv), n, tq, tk, h, dh, int(causal),
        *flags, stream)
    _raise_on("flash_bwd_dkv", err, (n, tq, h, dh))
    _count("flash_bwd_dkv")
    return dk, dv


def flash_bwd_dq(q, k, v, mask, do, lse, delta, causal: bool = False):
    """``flash_bwd_dq_reference`` as one launch of ``csrc/flash_bwd.cu``
    for CUDA tensors (arguments as ``flash_bwd_dkv``). Returns dq,
    contiguous."""
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, mask, do, lse, delta, causal)
    _device("flash_bwd_dq", q)
    (n, tq, tk, h, dh), flags = _bwd_args("flash_bwd_dq", q, k, v, mask,
                                          do, lse, delta)
    dq = torch.empty((n, tq, h, dh), dtype=q.dtype, device=q.device)
    stream = cuda_build.current_stream(q.device)
    err = cuda_build.kernel("flash_bwd_dq")(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(do), _ptr(lse),
        _ptr(delta), _ptr(dq), n, tq, tk, h, dh, int(causal), *flags,
        stream)
    _raise_on("flash_bwd_dq", err, (n, tq, h, dh))
    _count("flash_bwd_dq")
    return dq


# ---------------------------------------------------------------------------
# the differentiable op
# ---------------------------------------------------------------------------

def attention_delta(do, out):
    """delta = rowsum(dO ⊙ O) in f32 (f64 for f64), as (N, H, Tq)."""
    acc = _acc(out.dtype)
    return (do.to(acc) * out.to(acc)).sum(dim=-1).permute(0, 2, 1) \
        .contiguous()


class _FlashAttention(torch.autograd.Function):
    """``_flash_attention``'s custom VJP: the forward saves (q, k, v,
    mask, out, lse); the backward computes delta and launches the dk/dv
    pass, then the dq pass. The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        out, lse = flash_fwd(q, k, v, mask, causal)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        do = dout.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = attention_delta(do, out)
        dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, ctx.causal)
        dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise (flash) attention on (N, T, H, Dh) tensors, differentiable
    in q, k and v; ``mask`` is the (N, T_k) key-validity mask (a key is
    valid where it is > 0). The drop-in for
    ``nn.layers.attention.scaled_dot_product_attention``."""
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    return _FlashAttention.apply(q, k, v, mask, causal)

