"""QK-norm flash attention: the CUDA kernels K1 (forward) and K2 (backward),
their plain twins, and the ``autograd.Function`` that joins them.

K1 replaces nvit_tpu/ops/flash_attention.py::_fwd_qknorm_kernel (row-max
arm), launched there by ``_fwd_qknorm_call``; K2 replaces
``_bwd_fused_qknorm_kernel``, launched by ``_bwd_qknorm``.  The kernels are
``csrc/qknorm_attn_fwd.cu`` and ``csrc/qknorm_attn_bwd.cu`` (their headers
say what bounds them on the H100 and how the designs answer that).

``flash_attention_qknorm`` takes q/k/v as ``[B, H, T, D]`` tensors — any
strides with a contiguous last dim, so the heads can stay views of the fused
QKV projection — and ``sqk_eff`` ``[H, D]`` fp32, and is differentiable in
all four:

* CUDA tensors launch the kernels (bf16, head dim 32 or 64) or raise;
* CPU tensors run ``flash_attention_qknorm_ref`` / ``qknorm_attention_bwd_ref``,
  the plain PyTorch versions of the TPU kernels' math, forward and backward.

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


def _check_operands(q, k, v, sqk_eff):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, t, d = q.shape
    if tuple(sqk_eff.shape) != (h, d):
        raise ValueError(f"sqk_eff must be [H, D] = [{h}, {d}], got {tuple(sqk_eff.shape)}")
    if t < 1:
        raise ValueError("attention over an empty sequence")
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
