"""Normalization primitives (≙ nvit_tpu/core/norms.py).

All norms reduce in float32 and cast back, with the same rounding points as
the JAX package: ``justnorm`` returns the input dtype, ``rms_norm`` and
``layer_norm`` promote through the fp32 weight multiply.  ``justnorm`` (and
the residual updates built on it) reduce float64 inputs in float64, so their
backwards can be held against ``torch.autograd.gradcheck``.
"""

from __future__ import annotations

import torch


def acc32(x: torch.Tensor) -> torch.Tensor:
    """x in its reduction dtype: float32, or float64 for a float64 x."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def justnorm(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """L2-normalize along ``dim``: fp32 sums, original dtype out.

    ``eps=0`` divides by the bare norm, as the reference does."""
    x32 = acc32(x)
    norm = torch.sqrt(torch.sum(x32 * x32, dim=dim, keepdim=True))
    if eps:
        norm = torch.clamp_min(norm, eps)
    return (x32 / norm).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize in fp32, cast back to the input dtype, THEN multiply by the
    fp32 weight (the multiply promotes, as in torch and the JAX package)."""
    x32 = x.float()
    ms = torch.mean(x32 * x32, dim=-1, keepdim=True)
    xnorm = (x32 * torch.reciprocal(torch.sqrt(ms + eps))).to(x.dtype)
    return xnorm * weight


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics; ``y`` is rounded to the input dtype
    before the affine, and the result has the promoted dtype of ``x`` and
    ``weight`` (≙ norms.py:53)."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))
    out_dtype = torch.promote_types(x.dtype, weight.dtype)
    return (y.to(x.dtype) * weight + bias).to(out_dtype)
