"""Residual updates of the nViT hypersphere geometry, with the JAX package's
analytic backwards (≙ nvit_tpu/core/residual.py:43-133).

Same rounding points as the JAX package: the norms reduce in fp32, and the
intermediate values are rounded to the input dtype.  Each is a
``torch.autograd.Function`` whose backward saves only the primal inputs and
recomputes the forward chain in the forward's dtype chain, then forms every
gradient in one fp32 pass:

    out = N(res),  res = a + lr·(b−a),  a = N(h),  b = N(h_up),  lr = |α·c|
    dres = (g − out·(out⊙g))/‖res‖            (justnorm VJP)
    da   = dres·(1−lr)        db = dres·lr
    dα   = c·sign(α·c)·Σ_rows dres⊙(b−a)      (summed over every row)
    dh   = (da − a·(a⊙da))/‖h‖,  dh_up = (db − b·(b⊙db))/‖h_up‖

Dispatch, the port's rule: CUDA tensors launch the fused kernels of
``ops/residual.py`` (``csrc/residual.cu``: one pass a forward and one a
backward, at these rounding points), which take bf16 and fp32 and raise on
any other dtype; CPU tensors, float64 included, run the plain chains below
(``*_ref``), the twins the card tests hold the kernels against.  Without
autograd the forwards are the registered operators
``torch.ops.nvit.slerp_residual`` and ``torch.ops.nvit.norm_skip``, which
``torch.export`` records as calls.
"""

from __future__ import annotations

import torch

from nvit_tpu_torch.core.norms import acc32, justnorm
from nvit_tpu_torch.ops import residual as kernels


def _norm32(x32: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))


def _slerp_chain(h, h_update, lr):
    """The forward's dtype chain → (a, b, res), each in the inputs' dtype."""
    a = justnorm(h)
    b = justnorm(h_update)
    return a, b, a + lr.to(a.dtype) * (b - a)


def slerp_residual_ref(h: torch.Tensor, h_update: torch.Tensor, alpha: torch.Tensor, c: float) -> torch.Tensor:
    """The plain forward: ``N(N(h) + lr·(N(h_update) − N(h)))``, lr = |α·c|."""
    return justnorm(_slerp_chain(h, h_update, torch.abs(acc32(alpha) * c))[2])


def slerp_residual_bwd_ref(h, h_update, alpha, c, g):
    """The plain backward → (dh, dh_update, dα) in the inputs' dtypes."""
    ac = acc32(alpha) * c
    lr = torch.abs(ac)
    a, b, res = _slerp_chain(h, h_update, lr)  # the primal's rounding

    g32, a32, b32, res32 = (acc32(x) for x in (g, a, b, res))
    n_res = _norm32(res32)
    out32 = res32 / n_res
    dres = (g32 - out32 * torch.sum(out32 * g32, dim=-1, keepdim=True)) / n_res
    da = dres * (1.0 - lr)
    db = dres * lr
    d_lr = torch.sum((dres * (b32 - a32)).reshape(-1, alpha.shape[-1]), dim=0)
    d_alpha = (d_lr * c * torch.sign(ac)).to(alpha.dtype)

    n_h = _norm32(acc32(h))
    n_hu = _norm32(acc32(h_update))
    dh = (da - a32 * torch.sum(a32 * da, dim=-1, keepdim=True)) / n_h
    dhu = (db - b32 * torch.sum(b32 * db, dim=-1, keepdim=True)) / n_hu
    return dh.to(h.dtype), dhu.to(h_update.dtype), d_alpha


def _slerp_fwd(h, h_update, alpha, c):
    if h.is_cuda:
        return kernels.slerp_fwd(h.contiguous(), h_update.contiguous(), alpha.float().contiguous(), c)
    return slerp_residual_ref(h, h_update, alpha, c)


class SlerpResidualFn(torch.autograd.Function):
    """``norm(norm(h) + lr·(norm(h_update) − norm(h)))`` (≙ slerp_residual)."""

    @staticmethod
    def forward(ctx, h, h_update, alpha, c):
        ctx.save_for_backward(h, h_update, alpha)
        ctx.c = c
        return _slerp_fwd(h, h_update, alpha, c)

    @staticmethod
    def backward(ctx, g):
        h, h_update, alpha = ctx.saved_tensors
        if not h.is_cuda:
            return (*slerp_residual_bwd_ref(h, h_update, alpha, ctx.c, g), None)
        dh, dhu, d_alpha = kernels.slerp_bwd(h.contiguous(), h_update.contiguous(), alpha.float().contiguous(),
                                             ctx.c, g.contiguous())
        return dh, dhu, d_alpha.to(alpha.dtype), None


def slerp_residual(
    h: torch.Tensor,
    h_update: torch.Tensor,
    alpha: torch.Tensor,
    alpha_init_value: float,
    alpha_init_scaling: float,
) -> torch.Tensor:
    """``norm(norm(h) + lr·(norm(h_update) − norm(h)))`` with the per-channel
    ``lr = |alpha · init_value/init_scaling|`` (fp32, cast to h's dtype)."""
    c = alpha_init_value / alpha_init_scaling
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, h_update, alpha)):
        return SlerpResidualFn.apply(h, h_update, alpha, c)
    return torch.ops.nvit.slerp_residual(h, h_update, alpha, c)


def norm_skip_ref(h_new: torch.Tensor, h: torch.Tensor, skip_param: torch.Tensor) -> torch.Tensor:
    """The plain forward: ``N(h_new · skip_param + h)``."""
    return justnorm(h_new * skip_param.to(h_new.dtype) + h)


def norm_skip_bwd_ref(h_new, h, skip_param, g):
    """The plain backward → (d_h_new, dh, d_skip) in the inputs' dtypes."""
    res32 = acc32(h_new * skip_param.to(h_new.dtype) + h)
    g32 = acc32(g)
    n_res = _norm32(res32)
    out32 = res32 / n_res
    dres = (g32 - out32 * torch.sum(out32 * g32, dim=-1, keepdim=True)) / n_res
    d_skip = torch.sum(dres * acc32(h_new)).reshape(skip_param.shape).to(skip_param.dtype)
    d_hnew = (dres * acc32(skip_param)).to(h_new.dtype)
    return d_hnew, dres.to(h.dtype), d_skip


def _norm_skip_fwd(h_new, h, skip_param):
    if h.is_cuda:
        return kernels.norm_skip_fwd(h_new.contiguous(), h.contiguous(), skip_param.float().reshape(1))
    return norm_skip_ref(h_new, h, skip_param)


class NormSkipFn(torch.autograd.Function):
    """``norm(h_new · skip_param + h)`` (≙ norm_skip); d_skip sums over every
    element, as ``_norm_skip_bwd``."""

    @staticmethod
    def forward(ctx, h_new, h, skip_param):
        ctx.save_for_backward(h_new, h, skip_param)
        return _norm_skip_fwd(h_new, h, skip_param)

    @staticmethod
    def backward(ctx, g):
        h_new, h, skip_param = ctx.saved_tensors
        if not h.is_cuda:
            return norm_skip_bwd_ref(h_new, h, skip_param, g)
        d_hnew, dh, d_skip = kernels.norm_skip_bwd(h_new.contiguous(), h.contiguous(),
                                                   skip_param.float().reshape(1), g.contiguous())
        return d_hnew, dh, d_skip.reshape(skip_param.shape).to(skip_param.dtype)


def norm_skip(h_new: torch.Tensor, h: torch.Tensor, skip_param: torch.Tensor) -> torch.Tensor:
    """``norm(h_new · skip_param + h)`` — the outer skip around every block."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h_new, h, skip_param)):
        return NormSkipFn.apply(h_new, h, skip_param)
    return torch.ops.nvit.norm_skip(h_new, h, skip_param)


# The forwards as ``torch.library`` operators, so ``torch.export`` records
# them as calls (ckpt/aot.py): the CUDA key launches the kernel, the CPU
# key runs the chain; the fake implementation gives the output without
# storage (as ops/gated_mlp.py's operator).
@torch.library.custom_op("nvit::slerp_residual", mutates_args=(), device_types="cpu")
def slerp_residual_op(h: torch.Tensor, h_update: torch.Tensor, alpha: torch.Tensor, c: float) -> torch.Tensor:
    """The SLERP forward; on CPU tensors its twin."""
    return slerp_residual_ref(h, h_update, alpha, c)


@slerp_residual_op.register_kernel("cuda")
def _slerp_residual_cuda(h, h_update, alpha, c):
    return _slerp_fwd(h, h_update, alpha, c)


@slerp_residual_op.register_fake
def _slerp_residual_fake(h, h_update, alpha, c):
    return h.new_empty(h.shape, dtype=torch.promote_types(h.dtype, h_update.dtype))


@torch.library.custom_op("nvit::norm_skip", mutates_args=(), device_types="cpu")
def norm_skip_op(h_new: torch.Tensor, h: torch.Tensor, skip_param: torch.Tensor) -> torch.Tensor:
    """The outer skip's forward; on CPU tensors its twin."""
    return norm_skip_ref(h_new, h, skip_param)


@norm_skip_op.register_kernel("cuda")
def _norm_skip_cuda(h_new, h, skip_param):
    return _norm_skip_fwd(h_new, h, skip_param)


@norm_skip_op.register_fake
def _norm_skip_fake(h_new, h, skip_param):
    return h.new_empty(h.shape, dtype=torch.promote_types(h_new.dtype, h.dtype))
