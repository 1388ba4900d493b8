"""Fused gated MLP: the CUDA kernels K3 (forward) and K4 (backward), their
plain twins, the ``autograd.Function`` that joins them, and the unfused path
(≙ nvit_tpu/ops/gated_mlp.py).

``u ⊙ silu(v)`` where ``[u | v] = x Wᵀ`` and ``W`` is ``[2H, K]`` in torch's
``[out, in]`` layout.  K3 replaces the TPU kernel
nvit_tpu/ops/gated_mlp.py::_fwd_kernel (has_bias=False), launched there by
``_call`` via ``_fwd``; K4 replaces ``_bwd_kernel`` (has_bias=False),
launched by ``_bwd_duv``.  The kernels are ``csrc/gated_mlp_fwd.cu`` and
``csrc/gated_mlp_bwd.cu``.

* ``gated_mlp(..., use_kernel=True)``: CUDA tensors launch K3 and, under
  autograd, K4 (bf16, K % 16 == 0, H % 64 == 0) or raise; CPU tensors run
  ``gated_mlp_ref`` / ``gated_mlp_bwd_ref``, the TPU kernels' math in plain
  PyTorch (fp32 accumulate and gate, one cast).  dx and dW are dense
  products (cuBLAS on the card), as ``_dw_dx`` leaves them to XLA.
* ``use_kernel=False`` is the unfused chain ``_xla_gated`` mirrors
  (matmul in the input dtype, split, gate), chosen by configuration.

The bias variant (K6) is not ported yet.
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


def gated_mlp_duv_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4 (≙ _bwd_kernel): x [n, K], w [2H, K], g [n, H] →
    [du | dv] [n, 2H] in x.dtype, from fp32 u, v recomputed over
    fp32-accumulated ``x Wᵀ`` and the gate's derivatives in fp32."""
    h = w.shape[0] // 2
    uv = torch.matmul(x.float(), w.float().t())
    u, v = uv[..., :h], uv[..., h:]
    g32 = g.float()
    sig = torch.sigmoid(v)
    du = g32 * v * sig
    dv = g32 * u * sig * (1.0 + v * (1.0 - sig))  # d silu(v)/dv = σ·(1 + v·(1 − σ))
    return torch.cat([du, dv], dim=-1).to(x.dtype)


def _dw_dx(x: torch.Tensor, w: torch.Tensor, duv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx [n, K], dW [2H, K]) from duv [n, 2H] (≙ _dw_dx): dx = duv·W is the
    fp32-accumulated du·Wuᵀ + dv·Wvᵀ sum, dW = duvᵀ·x.  On the card two cuBLAS
    GEMMs in the input dtype: fp32 accumulation inside, and fp32 split-K
    reductions only with ``torch.backends.cuda.matmul.
    allow_bf16_reduced_precision_reduction`` off (PyTorch's default is on),
    which ``Trainer`` sets on a card.  On the CPU fp32 products cast once, as
    XLA's ``preferred_element_type=f32``."""
    if x.is_cuda:
        return torch.matmul(duv, w), torch.matmul(duv.t(), x)
    dx = torch.matmul(duv.float(), w.float()).to(x.dtype)
    dw = torch.matmul(duv.float().t(), x.float()).to(w.dtype)
    return dx, dw


def gated_mlp_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of the fused core (≙ _core_bwd: ``_bwd_kernel`` then
    ``_dw_dx``): x [n, K], w [2H, K], g [n, H] → (dx [n, K], dW [2H, K])."""
    return _dw_dx(x, w, gated_mlp_duv_ref(x, w, g.to(x.dtype)))


def gated_mlp_xla(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unfused chain (≙ gated_mlp.py:_xla_gated without bias): the matmul
    output and the gate stay in the input dtype."""
    u, v = torch.chunk(F.linear(x, w), 2, dim=-1)
    return u * F.silu(v)


def _check_kernel_operands(name: str, x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    """→ (n, K, H) of a 2-D x [n, K] and w [2H, K] the kernels take."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError(f"{name} launches a CUDA kernel: x and w must be CUDA tensors")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 x and w, got {x.dtype}, {w.dtype}")
    n, k = x.shape
    if w.dim() != 2 or w.shape[1] != k or w.shape[0] % 2:
        raise ValueError(f"w must be [2H, K={k}], got {tuple(w.shape)}")
    h = w.shape[0] // 2
    if k == 0 or k % 16 or h % 64:
        raise ValueError(f"{name} needs K % 16 == 0 and H % 64 == 0, got K={k}, H={h}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} takes row-major contiguous x and w")
    if n == 0:
        raise ValueError(f"{name} got an empty batch")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte-aligned x and w")
    return n, k, h


def gated_mlp_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3 on CUDA tensors: x [..., K] bf16, w [2H, K] bf16 → [..., H]
    bf16.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    *lead, k = x.shape
    n, k, h = _check_kernel_operands("K3", x.reshape(-1, k), w)
    x2 = x.reshape(n, k)
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


def gated_mlp_bwd_duv(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch K4 on CUDA tensors: x [n, K], w [2H, K], g [n, H], all bf16 →
    [du | dv] [n, 2H] bf16.  Counts each launch in ``.launches``."""
    from nvit_tpu_torch.ops._build import load_library

    n, k, h = _check_kernel_operands("K4", x, w)
    if tuple(g.shape) != (n, h) or g.dtype != torch.bfloat16 or not g.is_cuda:
        raise ValueError(f"K4 takes a bf16 CUDA g of shape {(n, h)}, got {g.dtype} {tuple(g.shape)}")
    g = g.contiguous()
    duv = torch.empty((n, 2 * h), dtype=torch.bfloat16, device=x.device)
    lib = load_library("gated_mlp_bwd")
    fn = lib.nvit_gated_mlp_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x.data_ptr(), w.data_ptr(), g.data_ptr(), duv.data_ptr(), n, k, h,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_mlp_bwd launch failed: cudaError {err}")
    gated_mlp_bwd_duv.launches += 1
    return duv


gated_mlp_bwd_duv.launches = 0


class GatedMLPFn(torch.autograd.Function):
    """K3 forward, K4 + the two dense products backward (≙ _gated_core's
    custom VJP); the plain twins on CPU tensors.  Saves x and w, as
    ``_core_fwd`` does, and casts g to x's dtype first, as ``_core_bwd``."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return gated_mlp_fwd(x2, w) if x2.is_cuda else gated_mlp_ref(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        duv = gated_mlp_bwd_duv(x2, w, g) if x2.is_cuda else gated_mlp_duv_ref(x2, w, g)
        return _dw_dx(x2, w, duv)


def gated_mlp(x: torch.Tensor, w: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """``u * silu(v)`` with ``[u | v] = x Wᵀ``; x and w already in the compute
    dtype (the caller casts, as core.layers.linear does).  With
    ``use_kernel``, K3/K4 on CUDA tensors and their twins on CPU tensors."""
    if not use_kernel:
        return gated_mlp_xla(x, w)
    *lead, k = x.shape
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GatedMLPFn.apply(x.reshape(-1, k), w).reshape(*lead, w.shape[0] // 2)
    if x.is_cuda:
        return gated_mlp_fwd(x, w)
    return gated_mlp_ref(x, w)
