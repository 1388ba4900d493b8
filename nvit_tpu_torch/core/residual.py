"""Residual updates of the nViT hypersphere geometry — forwards only
(≙ nvit_tpu/core/residual.py:54-59 and :112-114).

Same rounding points as the JAX package: the norms reduce in fp32, and the
intermediate values are rounded to the input dtype.  The analytic backwards
(``jax.custom_vjp`` there) come with the training slice.
"""

from __future__ import annotations

import torch

from nvit_tpu_torch.core.norms import justnorm


def slerp_residual(
    h: torch.Tensor,
    h_update: torch.Tensor,
    alpha: torch.Tensor,
    alpha_init_value: float,
    alpha_init_scaling: float,
) -> torch.Tensor:
    """``norm(norm(h) + lr·(norm(h_update) − norm(h)))`` with the per-channel
    ``lr = |alpha · init_value/init_scaling|`` (fp32, cast to h's dtype)."""
    lr = torch.abs(alpha.float() * (alpha_init_value / alpha_init_scaling))
    a = justnorm(h)
    b = justnorm(h_update)
    res = a + lr.to(a.dtype) * (b - a)
    return justnorm(res)


def norm_skip(h_new: torch.Tensor, h: torch.Tensor, skip_param: torch.Tensor) -> torch.Tensor:
    """``norm(h_new · skip_param + h)`` — the outer skip around every block."""
    res = h_new * skip_param.to(h_new.dtype) + h
    return justnorm(res)
