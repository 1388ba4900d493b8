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

These are plain PyTorch, not kernels.
"""

from __future__ import annotations

import torch

from nvit_tpu_torch.core.norms import acc32, justnorm


def _norm32(x32: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x32 * x32, dim=-1, keepdim=True))


def _slerp_chain(h, h_update, lr):
    """The forward's dtype chain → (a, b, res), each in the inputs' dtype."""
    a = justnorm(h)
    b = justnorm(h_update)
    return a, b, a + lr.to(a.dtype) * (b - a)


class SlerpResidualFn(torch.autograd.Function):
    """``norm(norm(h) + lr·(norm(h_update) − norm(h)))`` (≙ slerp_residual)."""

    @staticmethod
    def forward(ctx, h, h_update, alpha, c):
        ctx.save_for_backward(h, h_update, alpha)
        ctx.c = c
        lr = torch.abs(acc32(alpha) * c)
        return justnorm(_slerp_chain(h, h_update, lr)[2])

    @staticmethod
    def backward(ctx, g):
        h, h_update, alpha = ctx.saved_tensors
        c = ctx.c
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
        return dh.to(h.dtype), dhu.to(h_update.dtype), d_alpha, None


def slerp_residual(
    h: torch.Tensor,
    h_update: torch.Tensor,
    alpha: torch.Tensor,
    alpha_init_value: float,
    alpha_init_scaling: float,
) -> torch.Tensor:
    """``norm(norm(h) + lr·(norm(h_update) − norm(h)))`` with the per-channel
    ``lr = |alpha · init_value/init_scaling|`` (fp32, cast to h's dtype)."""
    return SlerpResidualFn.apply(h, h_update, alpha, alpha_init_value / alpha_init_scaling)


class NormSkipFn(torch.autograd.Function):
    """``norm(h_new · skip_param + h)`` (≙ norm_skip); d_skip sums over every
    element, as ``_norm_skip_bwd``."""

    @staticmethod
    def forward(ctx, h_new, h, skip_param):
        ctx.save_for_backward(h_new, h, skip_param)
        return justnorm(h_new * skip_param.to(h_new.dtype) + h)

    @staticmethod
    def backward(ctx, g):
        h_new, h, skip_param = ctx.saved_tensors
        res32 = acc32(h_new * skip_param.to(h_new.dtype) + h)
        g32 = acc32(g)
        n_res = _norm32(res32)
        out32 = res32 / n_res
        dres = (g32 - out32 * torch.sum(out32 * g32, dim=-1, keepdim=True)) / n_res
        d_skip = torch.sum(dres * acc32(h_new)).reshape(skip_param.shape).to(skip_param.dtype)
        d_hnew = (dres * acc32(skip_param)).to(h_new.dtype)
        return d_hnew, dres.to(h.dtype), d_skip


def norm_skip(h_new: torch.Tensor, h: torch.Tensor, skip_param: torch.Tensor) -> torch.Tensor:
    """``norm(h_new · skip_param + h)`` — the outer skip around every block."""
    return NormSkipFn.apply(h_new, h, skip_param)
