"""Fused gated MLP: the CUDA kernels K3/K6 (forward) and K4/K6 (backward),
their plain twins, the ``autograd.Function`` that joins them, and the
unfused path (≙ nvit_tpu/ops/gated_mlp.py).

``u ⊙ silu(v)`` where ``[u | v] = x Wᵀ (+ b)`` and ``W`` is ``[2H, K]`` in
torch's ``[out, in]`` layout.  K3 replaces the TPU kernel
nvit_tpu/ops/gated_mlp.py::_fwd_kernel with has_bias=False, launched there by
``_call`` via ``_fwd``; K4 replaces ``_bwd_kernel`` (has_bias=False), launched
by ``_bwd_duv``.  K6 is both with has_bias=True (``_gated_core_b``): the same
CUDA sources, ``csrc/gated_mlp_fwd.cu`` and ``csrc/gated_mlp_bwd.cu``, given a
bias pointer, with launch counts of their own (``.launches_bias``).

* ``gated_mlp(..., use_kernel=True)``: CUDA tensors launch K3 (K6 with a
  bias) and, under autograd, K4 (K6's backward) — bf16, K % 16 == 0,
  H % 64 == 0 — or raise; CPU tensors run ``gated_mlp_ref`` /
  ``gated_mlp_bwd_ref``, the TPU kernels' math in plain PyTorch (fp32
  accumulate, bias and gate, one cast).  dx and dW are dense products
  (cuBLAS on the card), as ``_dw_dx`` leaves them to XLA; db is the fp32
  column sum of [du | dv], as ``_core_bwd_b`` takes it.
* ``use_kernel=False`` is the unfused chain ``_xla_gated`` (matmul in the
  input dtype, then the bias, split, gate), chosen by configuration.
* Without autograd the forward is the registered operator
  ``torch.ops.nvit.gated_mlp``, which ``torch.export`` records as a call.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def _uv32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """fp32 ``[u | v]`` over fp32-accumulated ``x Wᵀ``, the bias added in
    fp32 (≙ _uv_tiles)."""
    uv = torch.matmul(x.float(), w.float().t())
    return uv if b is None else uv + b.float()


def gated_mlp_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of K3 (K6 with ``b``): fp32 ``u·(v·σ(v))`` over ``_uv32``,
    cast once to x.dtype."""
    h = w.shape[0] // 2
    uv = _uv32(x, w, b)
    u, v = uv[..., :h], uv[..., h:]
    return (u * (v * torch.sigmoid(v))).to(x.dtype)


def gated_mlp_duv_ref(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain twin of K4 (K6's backward with ``b``; ≙ _bwd_kernel): x [n, K],
    w [2H, K], g [n, H], b [2H] → [du | dv] [n, 2H] in x.dtype, from fp32 u,
    v recomputed as ``_uv32`` and the gate's derivatives in fp32."""
    h = w.shape[0] // 2
    uv = _uv32(x, w, b)
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


def _bias_grad(duv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """db [2H] = the fp32 column sum of [du | dv], cast to b's dtype (≙
    _core_bwd_b's dbu, dbv); no fp32 copy of duv is made."""
    return torch.sum(duv, dim=0, dtype=torch.float32).to(b.dtype)


def gated_mlp_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain backward of the fused core (≙ _core_bwd / _core_bwd_b:
    ``_bwd_kernel`` then ``_dw_dx``): x [n, K], w [2H, K], g [n, H] →
    (dx [n, K], dW [2H, K], db [2H] or None without a bias)."""
    duv = gated_mlp_duv_ref(x, w, g.to(x.dtype), b)
    return (*_dw_dx(x, w, duv), None if b is None else _bias_grad(duv, b))


def gated_mlp_xla(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """The unfused chain (≙ gated_mlp.py:_xla_gated): the matmul output is
    rounded to the input dtype BEFORE the bias, cast to that dtype, is added;
    the gate stays in the input dtype."""
    uv = F.linear(x, w)
    if b is not None:
        uv = uv + b.to(uv.dtype)
    u, v = torch.chunk(uv, 2, dim=-1)
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


def _check_bias(name: str, b: torch.Tensor | None, h: int) -> None:
    if b is None:
        return
    if not (b.is_cuda and b.dtype == torch.bfloat16 and tuple(b.shape) == (2 * h,)):
        raise ValueError(f"{name} takes a bf16 CUDA bias of shape {(2 * h,)}, got "
                         f"{b.dtype} {tuple(b.shape)} on {b.device}")
    if not b.is_contiguous() or b.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte-aligned bias")


def gated_mlp_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K3 (K6 with a bias) on CUDA tensors: x [..., K] bf16, w [2H, K]
    bf16, b [2H] bf16 or None → [..., H] bf16.  Counts each launch in
    ``.launches`` (K3) or ``.launches_bias`` (K6)."""
    from nvit_tpu_torch.ops._build import load_library

    name = "K3" if b is None else "K6"
    *lead, k = x.shape
    n, k, h = _check_kernel_operands(name, x.reshape(-1, k), w)
    _check_bias(name, b, h)
    x2 = x.reshape(n, k)
    out = torch.empty((n, h), dtype=torch.bfloat16, device=x.device)
    fn = load_library("gated_mlp_fwd").nvit_gated_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x2.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), n, k, h,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_mlp_fwd launch failed: cudaError {err}")
    if b is None:
        gated_mlp_fwd.launches += 1
    else:
        gated_mlp_fwd.launches_bias += 1
    return out.reshape(*lead, h)


gated_mlp_fwd.launches = 0
gated_mlp_fwd.launches_bias = 0


def gated_mlp_bwd_duv(
    x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, b: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch K4 (K6's backward with a bias) on CUDA tensors: x [n, K],
    w [2H, K], g [n, H], b [2H] or None, all bf16 → [du | dv] [n, 2H] bf16.
    Counts each launch in ``.launches`` (K4) or ``.launches_bias`` (K6)."""
    from nvit_tpu_torch.ops._build import load_library

    name = "K4" if b is None else "K6 backward"
    n, k, h = _check_kernel_operands(name, x, w)
    _check_bias(name, b, h)
    if tuple(g.shape) != (n, h) or g.dtype != torch.bfloat16 or not g.is_cuda:
        raise ValueError(f"{name} takes a bf16 CUDA g of shape {(n, h)}, got {g.dtype} {tuple(g.shape)}")
    if not g.is_contiguous() or g.data_ptr() % 16:  # the kernel reads g by TMA: 16-byte aligned rows
        g = g.clone(memory_format=torch.contiguous_format)
    duv = torch.empty((n, 2 * h), dtype=torch.bfloat16, device=x.device)
    fn = load_library("gated_mlp_bwd").nvit_gated_mlp_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(), g.data_ptr(),
        duv.data_ptr(), n, k, h, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_mlp_bwd launch failed: cudaError {err}")
    if b is None:
        gated_mlp_bwd_duv.launches += 1
    else:
        gated_mlp_bwd_duv.launches_bias += 1
    return duv


gated_mlp_bwd_duv.launches = 0
gated_mlp_bwd_duv.launches_bias = 0


class GatedMLPFn(torch.autograd.Function):
    """K3 (K6) forward; K4 (K6's backward) + the two dense products and the
    bias's column sum backward (≙ _gated_core's and _gated_core_b's custom
    VJPs); the plain twins on CPU tensors.  Saves x, w and b, as
    ``_core_fwd(_b)`` does, and casts g to x's dtype first, as ``_core_bwd``."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w, b)
        return gated_mlp_fwd(x2, w, b) if x2.is_cuda else gated_mlp_ref(x2, w, b)

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        g = g.to(x2.dtype)
        duv = gated_mlp_bwd_duv(x2, w, g, b) if x2.is_cuda else gated_mlp_duv_ref(x2, w, g, b)
        return (*_dw_dx(x2, w, duv), None if b is None else _bias_grad(duv, b))


def gated_mlp(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *, use_kernel: bool = True
) -> torch.Tensor:
    """``u * silu(v)`` with ``[u | v] = x Wᵀ (+ b)``; x and w already in the
    compute dtype (the caller casts, as core.layers.linear does), the bias
    cast to x's dtype here (≙ _gated_dispatch).  With ``use_kernel``, K3/K4
    (K6 with a bias) on CUDA tensors and their twins on CPU tensors."""
    if b is not None:
        b = b.to(x.dtype)
    if not use_kernel:
        return gated_mlp_xla(x, w, b)
    *lead, k = x.shape
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, b)):
        return GatedMLPFn.apply(x.reshape(-1, k), w, b).reshape(*lead, w.shape[0] // 2)
    return torch.ops.nvit.gated_mlp(x, w, b)


# The serving forward as a ``torch.library`` operator, so ``torch.export``
# records it as a call (ckpt/aot.py): the CUDA key launches K3 (K6 with a
# bias) or raises, the CPU key runs the twin; the fake implementation gives
# the output without storage, so the checks and the launch count run only
# when the program executes (as ops/flash_attention.py's operators).
@torch.library.custom_op("nvit::gated_mlp", mutates_args=(), device_types="cpu")
def gated_mlp_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """K3 (K6) forward; on CPU tensors its twin."""
    return gated_mlp_ref(x, w, b)


@gated_mlp_op.register_kernel("cuda")
def _gated_mlp_cuda(x, w, b):
    return gated_mlp_fwd(x, w, b)


@gated_mlp_op.register_fake
def _gated_mlp_fake(x, w, b):
    return x.new_empty((*x.shape[:-1], w.shape[0] // 2))
