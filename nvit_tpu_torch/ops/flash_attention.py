"""QK-norm flash attention forward: the CUDA kernel K1 and its plain twin.

Replaces nvit_tpu/ops/flash_attention.py::_fwd_qknorm_kernel (row-max arm),
launched there by ``_fwd_qknorm_call`` through ``flash_attention_qknorm``.
The kernel is ``csrc/qknorm_attn_fwd.cu`` (its header says what bounds it on
the H100 and how the design answers that).

``flash_attention_qknorm`` takes q/k/v as ``[B, H, T, D]`` tensors — any
strides with a contiguous last dim, so the heads can stay views of the fused
QKV projection — and ``sqk_eff`` ``[H, D]`` fp32:

* CUDA tensors launch the kernel (bf16, head dim 32 or 64) or raise;
* CPU tensors run ``flash_attention_qknorm_ref``, the plain PyTorch version
  of the TPU kernel's math.  It exists for the CPU path and the tests.

Only the forward is ported; the backward (K2) comes with training.
"""

from __future__ import annotations

import ctypes

import torch

NORM_EPS = 1e-30  # ≙ flash_attention.py _NORM_EPS: floors all-zero rows


def _normed_scaled(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """fp32 ``s ⊙ x/max(‖x‖, eps)`` (≙ flash_attention.py:_normed_scaled)."""
    x32 = x.float()
    norm = torch.clamp_min(torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True)), NORM_EPS)
    return s * (x32 / norm)


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


def _check_operands(q, k, v, sqk_eff):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, H, T, D] shape, got {q.shape}, {k.shape}, {v.shape}")
    b, h, t, d = q.shape
    if tuple(sqk_eff.shape) != (h, d):
        raise ValueError(f"sqk_eff must be [H, D] = [{h}, {d}], got {tuple(sqk_eff.shape)}")
    if t < 1:
        raise ValueError("attention over an empty sequence")
    return b, h, t, d


def _launch_strides(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    """(batch, head, token) element strides the kernel addresses x with; its
    16-byte vector loads need a contiguous last dim and 8-element alignment."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, got strides {x.stride()}")
    if any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
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
    if not all(x.is_cuda for x in (q, k, v, sqk_eff)):
        raise ValueError("qknorm_attention_fwd launches a CUDA kernel: all operands must be CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"K1 takes bf16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (32, 64):
        raise ValueError(f"K1 takes head dim 32 or 64, got {d}")
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


def flash_attention_qknorm(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float
) -> torch.Tensor:
    """Fused nViT attention (≙ flash_attention.py:flash_attention_qknorm with
    mode="rowmax") → [B, H, T, D] in v.dtype.  K1 on CUDA tensors, its twin on
    CPU tensors — chosen by where the tensors lie, nothing else."""
    if q.is_cuda:
        return qknorm_attention_fwd(q, k, v, sqk_eff, scale)[0]
    _check_operands(q, k, v, sqk_eff)
    return flash_attention_qknorm_ref(q, k, v, sqk_eff, scale)[0]
