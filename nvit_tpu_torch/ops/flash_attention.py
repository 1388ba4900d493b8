"""Flash attention: the CUDA kernels, their plain twins, and the
``autograd.Function``s that join them.

nViT mode (QK-norm): K1 replaces nvit_tpu/ops/flash_attention.py::
_fwd_qknorm_kernel (row-max arm), launched there by ``_fwd_qknorm_call``; K2
replaces ``_bwd_fused_qknorm_kernel``, launched by ``_bwd_qknorm``.  The
kernels are ``csrc/qknorm_attn_fwd.cu`` and ``csrc/qknorm_attn_bwd.cu``.

Baseline mode (plain softmax(q·kᵀ·scale)·v): K7 replaces ``_fwd_kernel``
(launched by ``_fwd``); K8 replaces ``_bwd_fused_kernel`` and K9 the split
``_dq_kernel`` / ``_dkv_kernel``, both launched by ``_bwd``.  The kernels are
``csrc/flash_attn_fwd.cu`` (K7) and ``csrc/flash_attn_bwd.cu`` (K8 and K9:
one tiled backward whose dQ pass keeps either kernel's rounding).  The
kernels' headers say what bounds them on the H100 and how the designs answer
that.

``flash_attention_qknorm`` and ``flash_attention`` take q/k/v as
``[B, H, T, D]`` tensors — any strides with a contiguous last dim, so the
heads can stay views of the fused QKV projection — and are differentiable:

* CUDA tensors launch the kernels (bf16, head dim 32 or 64) or raise;
* CPU tensors run the ``*_ref`` twins, the plain PyTorch versions of the TPU
  kernels' math with their rounding points, forward and backward.

Without autograd (``torch.inference_mode``, ``no_grad``, or no input that
requires grad) the forward computes no lse and saves nothing.
"""

from __future__ import annotations

import ctypes

import torch

NORM_EPS = 1e-30  # ≙ flash_attention.py _NORM_EPS: floors all-zero rows
BLOCK = 64  # K2's tile rows (csrc/qknorm_attn_bwd.cu)


def _norm32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(x/max(‖x‖, eps), max(‖x‖, eps))`` (≙ flash_attention.py:_normed_scaled)."""
    x32 = x.float()
    norm = torch.clamp_min(torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True)), NORM_EPS)
    return x32 / norm, norm


def _normed_scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 ``s ⊙ x/max(‖x‖, eps)``, the multiply order of the TPU kernels."""
    return s * _norm32(x)[0]


def flash_attention_qknorm_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K1: → (o [B, H, T, D] in v.dtype, lse [B, H, T] fp32).

    The TPU kernel's single pass: fp32 norms with the 1e-30 floor, the softmax
    scale folded into q̂ as (s·scale)·qn before the cast, fp32 scores, row-max
    softmax, bf16(P)·V accumulated in fp32, divided by the fp32 row sum."""
    h, d = sqk_eff.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    qhat = _normed_scaled(q, s * scale).to(v.dtype)
    khat = _normed_scaled(k, s).to(v.dtype)
    scores = torch.matmul(qhat.float(), khat.float().transpose(-1, -2))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (pv / l).to(v.dtype)
    lse = (m + torch.log(l)).squeeze(-1)
    return o, lse


def qknorm_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K2 (≙ _bwd_fused_qknorm_kernel, row-max arm) →
    (dq, dk, dv in the inputs' dtypes, dsqk [B, H, D] fp32 per (b, h)).

    The TPU kernel body with its rounding points: q̂_s = bf16((s·scale)·qn),
    k̂ = bf16(s·kn), k̂_s = bf16((s·scale)·kn); P = exp(S − lse); Δ = rowsum
    (dO∘O) in fp32; dS = P·(dP − Δ); bf16(P) and bf16(dS) feed the fp32
    products dV, dk̂, dq̂; dsqk = Σ_t(dq̂⊙qn + dk̂⊙kn); then the justnorm VJP
    divides by the floored norms."""
    h, d = sqk_eff.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    qn, qnorm = _norm32(q)
    kn, knorm = _norm32(k)
    qhat_s = ((s * scale) * qn).to(v.dtype).float()
    khat = (s * kn).to(v.dtype).float()
    khat_s = ((s * scale) * kn).to(v.dtype).float()
    do32 = do.float()
    p = torch.exp(torch.matmul(qhat_s, khat.transpose(-1, -2)) - lse.unsqueeze(-1))
    delta = torch.sum(do32 * o.float(), dim=-1, keepdim=True)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32).to(v.dtype)
    dkhat = torch.matmul(ds.transpose(-1, -2), qhat_s)
    dqhat = torch.matmul(ds, khat_s)
    dsqk = torch.sum(dqhat * qn + dkhat * kn, dim=-2)

    def vjp(dxhat, xn, norm):
        dxn = s * dxhat
        return (dxn - xn * torch.sum(xn * dxn, dim=-1, keepdim=True)) / norm

    return vjp(dqhat, qn, qnorm).to(q.dtype), vjp(dkhat, kn, knorm).to(k.dtype), dv, dsqk


def _check_qkv(q, k, v) -> tuple[int, int, int, int]:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    if q.shape[2] < 1:
        raise ValueError("attention over an empty sequence")
    return tuple(q.shape)


def _check_operands(q, k, v, sqk_eff):
    b, h, t, d = _check_qkv(q, k, v)
    if tuple(sqk_eff.shape) != (h, d):
        raise ValueError(f"sqk_eff must be [H, D] = [{h}, {d}], got {tuple(sqk_eff.shape)}")
    return b, h, t, d


def _check_cuda_bf16(name: str, tensors, d: int) -> None:
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{name} launches a CUDA kernel: all operands must be CUDA tensors")
    if not all(x.dtype == torch.bfloat16 for x in tensors):
        raise ValueError(f"{name} takes bf16 q/k/v, got {[x.dtype for x in tensors]}")
    if d not in (32, 64):
        raise ValueError(f"{name} takes head dim 32 or 64, got {d}")


def _aligned(x: torch.Tensor) -> bool:
    return x.stride(-1) == 1 and not any(st % 8 for st in x.stride()[:3]) and x.data_ptr() % 16 == 0


def _launch_strides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, head, token) element strides the kernel addresses x with; its
    16-byte vector loads need a contiguous last dim and 8-element alignment."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, got strides {x.stride()}")
    if not _aligned(x):
        raise ValueError(f"{name}: strides {x.stride()} / pointer not 16-byte aligned")
    return x.stride(0), x.stride(1), x.stride(2)


def qknorm_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    *, with_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K1 on CUDA tensors → (o [B, H, T, D] bf16, lse [B, H, T] fp32 or
    None).  o is a [B, H, T, D] view of [B, T, H, D] storage, so merging the
    heads afterwards costs no copy.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    b, h, t, d = _check_operands(q, k, v, sqk_eff)
    _check_cuda_bf16("qknorm_attention_fwd", (q, k, v), d)
    if not sqk_eff.is_cuda:
        raise ValueError("qknorm_attention_fwd launches a CUDA kernel: all operands must be CUDA tensors")
    sqk = sqk_eff.to(torch.float32).contiguous()
    o = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(
        *_launch_strides(q, "q"), *_launch_strides(k, "k"), *_launch_strides(v, "v"),
        *_launch_strides(o, "o"),
    )
    lib = load_library("qknorm_attn_fwd")
    fn = lib.nvit_qknorm_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sqk.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, h, t, d, float(scale), strides, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attn_fwd launch failed: cudaError {err}")
    qknorm_attention_fwd.launches += 1
    return o, lse


qknorm_attention_fwd.launches = 0


def qknorm_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA tensors → (dq, dk, dv bf16 [B, H, T, D], dsqk [B, H, D]
    fp32 per (b, h)).  dq/dk/dv are views of ONE [B, T, 3, H, D] buffer.
    ``o``/``lse`` are K1's (``with_lse=True``); ``do`` may be any view with a
    contiguous head dim.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    b, h, t, d = _check_operands(q, k, v, sqk_eff)
    _check_cuda_bf16("qknorm_attention_bwd", (q, k, v, o, do), d)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"o/do must be {tuple(q.shape)} and lse {(b, h, t)}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if not (sqk_eff.is_cuda and lse.is_cuda and lse.dtype == torch.float32):
        raise ValueError("qknorm_attention_bwd takes CUDA sqk_eff and fp32 CUDA lse")
    if not _aligned(do):
        do = do.contiguous()
    sqk = sqk_eff.to(torch.float32).contiguous()
    lse = lse.contiguous()
    grads = torch.empty((b, t, 3, h, d), dtype=torch.bfloat16, device=q.device)
    dq, dk, dv = (grads[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    n_tiles = -(-t // BLOCK)
    delta = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    part = torch.empty((b * h, 2 * n_tiles, d), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(
        st for x, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"),
                           (dq, "dq"), (dk, "dk"), (dv, "dv"))
        for st in _launch_strides(x, name)
    ))
    lib = load_library("qknorm_attn_bwd")
    fn = lib.nvit_qknorm_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), sqk.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        part.data_ptr(), b, h, t, d, float(scale), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"qknorm_attn_bwd launch failed: cudaError {err}")
    qknorm_attention_bwd.launches += 1
    # the per-tile partials summed in a fixed order: deterministic dsqk
    return dq, dk, dv, part.sum(dim=1).reshape(b, h, d)


qknorm_attention_bwd.launches = 0


class FlashQKNormFn(torch.autograd.Function):
    """K1 forward, K2 backward (≙ _flash_qknorm_padded's custom VJP); the
    plain twins on CPU tensors.  Saves q, k, v, o, lse and sqk_eff, as
    ``_flash_qknorm_padded_fwd`` does.  The gradient of ``sqk_eff [H, D]``
    is the per-(b, h) dsqk summed over b — the VJP of the ``s3`` broadcast."""

    @staticmethod
    def forward(ctx, q, k, v, sqk_eff, scale):
        if q.is_cuda:
            o, lse = qknorm_attention_fwd(q, k, v, sqk_eff, scale, with_lse=True)
        else:
            o, lse = flash_attention_qknorm_ref(q, k, v, sqk_eff, scale)
        ctx.save_for_backward(q, k, v, sqk_eff, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, sqk_eff, o, lse = ctx.saved_tensors
        do = do.to(o.dtype)  # ≙ _bwd_qknorm: g.astype(o3.dtype)
        bwd = qknorm_attention_bwd if q.is_cuda else qknorm_attention_bwd_ref
        dq, dk, dv, dsqk = bwd(q, k, v, sqk_eff, ctx.scale, o, lse, do)
        return dq, dk, dv, dsqk.sum(dim=0).to(sqk_eff.dtype), None


def flash_attention_qknorm(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float
) -> torch.Tensor:
    """Fused nViT attention (≙ flash_attention.py:flash_attention_qknorm with
    mode="rowmax") → [B, H, T, D] in v.dtype.  K1/K2 on CUDA tensors, the
    twins on CPU tensors — chosen by where the tensors lie, nothing else."""
    _check_operands(q, k, v, sqk_eff)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, sqk_eff)):
        return FlashQKNormFn.apply(q, k, v, sqk_eff, scale)
    if q.is_cuda:
        return qknorm_attention_fwd(q, k, v, sqk_eff, scale)[0]
    return flash_attention_qknorm_ref(q, k, v, sqk_eff, scale)[0]


# ------------------------------------------------------------ baseline mode
# The JAX package's ``_bwd`` takes the fused single-program backward while
# the padded T is at most this, else the split dq / dk-dv kernels.  The two
# round dq differently (see ``attention_dq_ref``), so the port switches at the
# same T to keep the JAX package's rounding at every length; it picks no tile
# (≙ nvit_tpu/ops/tuning.py FUSED_BWD_MAX_T, whose v5e override is not ported).
FUSED_BWD_MAX_T = 1024


def _scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x · scale`` in x's dtype, as a JAX array times a Python float: the
    weak-typed scale is rounded to x's dtype, the product rounded once."""
    return x * torch.tensor(scale, dtype=x.dtype)


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K7 (≙ _fwd_kernel): → (o [B, H, T, D] in v.dtype, lse
    [B, H, T] fp32).

    q·scale is rounded to the input dtype before the fp32 scores (the TPU
    kernel folds the scale into the q operand); row-max softmax in fp32,
    bf16(P)·V accumulated in fp32 and divided by the fp32 row sum."""
    scores = torch.matmul(_scaled(q, scale).float(), k.float().transpose(-1, -2))
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return (pv / l).to(v.dtype), (m + torch.log(l)).squeeze(-1)


def _probs(qs: torch.Tensor, k: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """fp32 P = exp(qs·kᵀ − lse), recomputed from the forward's statistic."""
    return torch.exp(torch.matmul(qs.float(), k.float().transpose(-1, -2)) - lse.unsqueeze(-1))


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ∘ O) in fp32 → [B, H, T]."""
    return torch.sum(do.float() * o.float(), dim=-1)


def attention_bwd_fused_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K8 (≙ _bwd_fused_kernel) → (dq, dk, dv) in the inputs'
    dtypes.

    qs = bf16(q·scale) and ks = bf16(k·scale) (the scale folded into both
    operands); Δ = rowsum(dO∘O) inside; P = exp(qs·kᵀ − lse), dS = P(dP − Δ);
    then dv = bf16(P)ᵀ·dO, dk = bf16(dS)ᵀ·qs, dq = bf16(dS)·ks in fp32."""
    qs, ks = _scaled(q, scale), _scaled(k, scale)
    do32 = do.float()
    p = _probs(qs, k, lse)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = (p * (dp - attention_delta(o, do).unsqueeze(-1))).to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do32).to(v.dtype)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float()).to(k.dtype)
    dq = torch.matmul(ds, ks.float()).to(q.dtype)
    return dq, dk, dv


def attention_dq_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> torch.Tensor:
    """Plain twin of K9's dQ half (≙ _dq_kernel) → dq in q.dtype.  Δ comes
    from outside; unlike K8, dq = (bf16(dS)·k)·scale with the scale applied
    to the fp32 product, then one cast."""
    p = _probs(_scaled(q, scale), k, lse)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta.unsqueeze(-1))).to(k.dtype).float()
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def attention_dkv_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K9's dK/dV half (≙ _dkv_kernel) → (dk, dv): Pᵀ
    recomputed from lse with qs = bf16(q·scale); dv = bf16(Pᵀ)·dO,
    dk = bf16(dSᵀ)·qs in fp32."""
    qs = _scaled(q, scale)
    pt = _probs(qs, k, lse).transpose(-1, -2)
    dpt = torch.matmul(v.float(), do.float().transpose(-1, -2))
    dst = (pt * (dpt - delta.unsqueeze(-2))).to(q.dtype).float()
    dv = torch.matmul(pt.to(do.dtype).float(), do.float()).to(v.dtype)
    dk = torch.matmul(dst, qs.float()).to(k.dtype)
    return dk, dv


def _bf16_scale(scale: float) -> float:
    """The operand-fold scale the kernels use: rounded to bf16 (``_scaled``)."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, with_lse: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch K7 on CUDA tensors → (o [B, H, T, D] bf16, lse [B, H, T] fp32 or
    None).  o is a [B, H, T, D] view of [B, T, H, D] storage, so merging the
    heads afterwards costs no copy.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    b, h, t, d = _check_qkv(q, k, v)
    _check_cuda_bf16("flash_attention_fwd", (q, k, v), d)
    o = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*(
        st for x, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o")) for st in _launch_strides(x, name)
    ))
    fn = load_library("flash_attn_fwd").nvit_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None, b, h, t, d, _bf16_scale(scale), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _launch_bwd(q, k, v, o, lse, do, delta, scale: float, *, split: bool):
    """One launch of csrc/flash_attn_bwd.cu → (dq, dk, dv) bf16 [B, H, T, D],
    views of ONE [B, T, 3, H, D] buffer.  ``split=False`` is K8 (Δ from o
    and dO in the kernel's first pass, dq = bf16(dS)·bf16(k·scale));
    ``split=True`` is K9 (Δ given, dq = (bf16(dS)·k)·scale in fp32)."""
    from nvit_tpu_torch.ops._build import load_library

    b, h, t, d = _check_qkv(q, k, v)
    name = "attention_bwd_split" if split else "attention_bwd_fused"
    _check_cuda_bf16(name, (q, k, v, do) + (() if split else (o,)), d)
    if do.shape != q.shape or tuple(lse.shape) != (b, h, t):
        raise ValueError(f"do must be {tuple(q.shape)} and lse {(b, h, t)}, got "
                         f"{tuple(do.shape)}, {tuple(lse.shape)}")
    if not (lse.is_cuda and lse.dtype == torch.float32):
        raise ValueError(f"{name} takes an fp32 CUDA lse")
    if not _aligned(do):
        do = do.contiguous()
    if split:
        if tuple(delta.shape) != (b, h, t) or not delta.is_cuda or delta.dtype != torch.float32:
            raise ValueError(f"{name} takes an fp32 CUDA delta of shape {(b, h, t)}")
        delta = delta.contiguous()
        o = do  # not read: Δ is given
    else:
        if o.shape != q.shape:
            raise ValueError(f"o must be {tuple(q.shape)}, got {tuple(o.shape)}")
        delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    grads = torch.empty((b, t, 3, h, d), dtype=torch.bfloat16, device=q.device)
    dq, dk, dv = (grads[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    strides = (ctypes.c_int64 * 24)(*(
        st for x, nm in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do"),
                         (dq, "dq"), (dk, "dk"), (dv, "dv"))
        for st in _launch_strides(x, nm)
    ))
    fn = load_library("flash_attn_bwd").nvit_flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), b, h, t, d,
        _bf16_scale(scale), float(scale), int(split), strides,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd launch failed: cudaError {err}")
    return dq, dk, dv


def attention_bwd_fused(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K8 on CUDA tensors → (dq, dk, dv) bf16, views of one
    [B, T, 3, H, D] buffer.  ``o``/``lse`` are K7's (``with_lse=True``).
    Counts each launch in ``.launches``."""
    out = _launch_bwd(q, k, v, o, lse, do, None, scale, split=False)
    attention_bwd_fused.launches += 1
    return out


attention_bwd_fused.launches = 0


def attention_bwd_split(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K9 (the dK/dV and dQ passes of ``_dkv_kernel`` / ``_dq_kernel``)
    on CUDA tensors → (dq, dk, dv) bf16, views of one [B, T, 3, H, D] buffer;
    ``delta`` is ``attention_delta(o, do)``.  Counts each launch in
    ``.launches``."""
    out = _launch_bwd(q, k, v, None, lse, do, delta, scale, split=True)
    attention_bwd_split.launches += 1
    return out


attention_bwd_split.launches = 0


class FlashAttnFn(torch.autograd.Function):
    """K7 forward; K8 backward, or K9 past ``FUSED_BWD_MAX_T`` (≙
    _flash_padded's custom VJP, which saves q, k, v, o and lse); the plain
    twins on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.is_cuda:
            o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        else:
            o, lse = flash_attention_ref(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale = ctx.scale
        do = do.to(o.dtype)  # ≙ _bwd: g.astype(o3.dtype)
        if q.shape[2] <= FUSED_BWD_MAX_T:
            bwd = attention_bwd_fused if q.is_cuda else attention_bwd_fused_ref
            dq, dk, dv = bwd(q, k, v, o, lse, do, scale)
        else:
            delta = attention_delta(o, do)  # ≙ _bwd:290, outside the kernels
            if q.is_cuda:
                dq, dk, dv = attention_bwd_split(q, k, v, do, lse, delta, scale)
            else:
                dq = attention_dq_ref(q, k, v, do, lse, delta, scale)
                dk, dv = attention_dkv_ref(q, k, v, do, lse, delta, scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Fused non-causal attention (≙ flash_attention.py:flash_attention) →
    [B, H, T, D] in v.dtype; q and k are cast to v.dtype first, as there.
    K7/K8/K9 on CUDA tensors, the twins on CPU tensors — chosen by where the
    tensors lie, nothing else."""
    _check_qkv(q, k, v)
    q, k = q.to(v.dtype), k.to(v.dtype)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttnFn.apply(q, k, v, scale)
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, scale)[0]
    return flash_attention_ref(q, k, v, scale)[0]
