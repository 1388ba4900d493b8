"""Attention dispatch (≙ nvit_tpu/ops/attention.py).

* ``sdpa`` / ``qknorm_project`` are the plain path — the twins of the JAX
  package's XLA functions, taken when ``flash_attn`` is off;
* ``attention_qknorm(..., use_flash=True)`` is the fused QK-norm kernel K1
  with its backward K2 (K5 for ``bounded_softmax`` "bounded" or "auto"),
  and ``attention(..., use_flash=True)`` the plain
  flash kernel K7 with its backward K8 (K9 past T = 1024)
  (ops/flash_attention.py): launched on CUDA tensors, their plain twins on
  CPU tensors.

The plain path is written out, not handed to PyTorch's fused attention
operator, so it keeps the JAX package's rounding points.
"""

from __future__ import annotations

import torch

from nvit_tpu_torch.core.norms import justnorm
from nvit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_qknorm


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain scaled-dot-product attention (≙ attention.py:sdpa_xla).
    q, k, v: [B, H, T, D]; fp32 logits and softmax, output in v.dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, *, use_flash: bool = False
) -> torch.Tensor:
    """Non-causal multi-head attention with a custom softmax scale, baseline
    mode (≙ attention.py:attention).  q, k, v: [B, H, T, D]."""
    if use_flash:
        return flash_attention(q, k, v, scale)
    return sdpa(q, k, v, scale)


def qknorm_project(
    q: torch.Tensor, k: torch.Tensor, sqk_eff: torch.Tensor, out_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """``s ⊙ justnorm(x)`` per head (≙ attention.py:qknorm_project_xla), in
    its rounding order: justnorm rounds to the input dtype first, then the
    fp32 ``s`` multiplies, then the cast — unlike K1, which keeps qn in fp32."""
    h, d = sqk_eff.shape
    s = sqk_eff.float().reshape(1, h, 1, d)
    return (s * justnorm(q).float()).to(out_dtype), (s * justnorm(k).float()).to(out_dtype)


def attention_qknorm(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sqk_eff: torch.Tensor, scale: float,
    *, use_flash: bool = False, bounded_softmax: str = "rowmax",
) -> torch.Tensor:
    """nViT attention with the per-head hypersphere projection of Q/K
    (≙ attention.py:attention_qknorm).  ``sqk_eff``: [H, D] fp32;
    ``bounded_softmax`` is the fused kernel's stabilizer mode ("rowmax",
    "bounded" or "auto"), which the plain path, exact softmax, ignores."""
    if use_flash:
        return flash_attention_qknorm(q, k, v, sqk_eff, scale, mode=bounded_softmax)
    qh, kh = qknorm_project(q, k, sqk_eff, v.dtype)
    return sdpa(qh, kh, v, scale)
