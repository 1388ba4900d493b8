"""Fused gated MLP forward: the CUDA kernel K3, its plain twin, and the
unfused path (≙ nvit_tpu/ops/gated_mlp.py).

``u ⊙ silu(v)`` where ``[u | v] = x Wᵀ`` and ``W`` is ``[2H, K]`` in torch's
``[out, in]`` layout.  Replaces the TPU kernel
nvit_tpu/ops/gated_mlp.py::_fwd_kernel (has_bias=False), launched there by
``_call`` via ``_fwd`` / ``_gated_core``.  The kernel is
``csrc/gated_mlp_fwd.cu``.

* ``gated_mlp(..., use_kernel=True)``: CUDA tensors launch K3 (bf16,
  K % 16 == 0, H % 64 == 0) or raise; CPU tensors run ``gated_mlp_ref``, the
  TPU kernel's math in plain PyTorch (fp32 accumulate and gate, one cast).
* ``use_kernel=False`` is the unfused chain ``_xla_gated`` mirrors
  (matmul in the input dtype, split, gate), chosen by configuration.

The bias variant (K6) and the backward (K4) are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def gated_mlp_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: fp32 ``u·(v·σ(v))`` over fp32-accumulated ``x Wᵀ``,
    cast once to x.dtype."""
    h = w.shape[0] // 2
    uv = torch.matmul(x.float(), w.float().t())
    u, v = uv[..., :h], uv[..., h:]
    return (u * (v * torch.sigmoid(v))).to(x.dtype)


def gated_mlp_xla(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unfused chain (≙ gated_mlp.py:_xla_gated without bias): the matmul
    output and the gate stay in the input dtype."""
    u, v = torch.chunk(F.linear(x, w), 2, dim=-1)
    return u * F.silu(v)


def gated_mlp_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors: x [..., K] bf16, w [2H, K] bf16 → [..., H]
    bf16.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    if not (x.is_cuda and w.is_cuda):
        raise ValueError("gated_mlp_fwd launches a CUDA kernel: x and w must be CUDA tensors")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"K3 takes bf16 x and w, got {x.dtype}, {w.dtype}")
    *lead, k = x.shape
    if w.dim() != 2 or w.shape[1] != k or w.shape[0] % 2:
        raise ValueError(f"w must be [2H, K={k}], got {tuple(w.shape)}")
    h = w.shape[0] // 2
    if k == 0 or k % 16 or h % 64:
        raise ValueError(f"K3 needs K % 16 == 0 and H % 64 == 0, got K={k}, H={h}")
    x2 = x.reshape(-1, k)
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("K3 takes row-major contiguous x and w")
    n = x2.shape[0]
    if n == 0:
        raise ValueError("K3 got an empty batch")
    if x2.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("K3 needs 16-byte-aligned x and w")
    out = torch.empty((n, h), dtype=torch.bfloat16, device=x.device)
    lib = load_library("gated_mlp_fwd")
    fn = lib.nvit_gated_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), n, k, h,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_mlp_fwd launch failed: cudaError {err}")
    gated_mlp_fwd.launches += 1
    return out.reshape(*lead, h)


gated_mlp_fwd.launches = 0


def gated_mlp(x: torch.Tensor, w: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """``u * silu(v)`` with ``[u | v] = x Wᵀ``; x and w already in the compute
    dtype (the caller casts, as core.layers.linear does).  With
    ``use_kernel``, K3 on CUDA tensors and its twin on CPU tensors."""
    if not use_kernel:
        return gated_mlp_xla(x, w)
    if x.is_cuda:
        return gated_mlp_fwd(x, w)
    return gated_mlp_ref(x, w)
