"""The optimizer's learning-rate schedule (≙ nvit_tpu/models/schedules.py:18-35).

``kohonen_lr`` comes with the SOM (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from nvit_tpu_torch.configs.schema import OptimizerConfig


def cosine_lr(opt: OptimizerConfig, step: int | torch.Tensor) -> torch.Tensor:
    """Warmup → cosine decay → min_lr, as an fp32 0-d tensor computed in the
    JAX package's fp32 operation order.  ``decay_lr=False`` returns the
    constant base LR."""
    step = torch.as_tensor(step, dtype=torch.float32)
    base, mn = opt.learning_rate, opt.min_lr
    if not opt.decay_lr:
        return torch.full_like(step, base)
    warm = float(opt.warmup_iters)
    decay = float(opt.lr_decay_iters)
    warmup_lr = base * step / max(warm, 1.0)
    ratio = torch.clamp((step - warm) / max(decay - warm, 1.0), 0.0, 1.0)
    coeff = 0.5 * (1.0 + torch.cos(math.pi * ratio))
    cos_lr = mn + coeff * (base - mn)
    return torch.where(step < warm, warmup_lr, torch.where(step > decay, mn, cos_lr))
