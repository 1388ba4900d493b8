"""The learning-rate schedules (≙ nvit_tpu/models/schedules.py): the
optimizer's ``cosine_lr`` and the Kohonen map's ``kohonen_lr``, both fp32
0-d tensors computed in the JAX package's fp32 operation order."""

from __future__ import annotations

import math

import torch

from nvit_tpu_torch.configs.schema import OptimizerConfig, ViTConfig


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


def kohonen_lr(cfg: ViTConfig, step: int | torch.Tensor) -> torch.Tensor:
    """The Kohonen map's rate: linear warmup from min_lr → cosine decay →
    min_lr; with the scheduler off the constant ``kohonen_alpha``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    if not cfg.kohonen_scheduler_enabled:
        return torch.full_like(step, cfg.kohonen_alpha)
    warm = float(cfg.kohonen_scheduler_warmup_steps)
    decay = float(cfg.kohonen_scheduler_decay_steps)
    mn, mx = cfg.kohonen_scheduler_min_lr, cfg.kohonen_alpha
    warmup_lr = mn + (mx - mn) * (step / max(warm, 1.0))
    ratio = torch.clamp((step - warm) / max(decay - warm, 1.0), 0.0, 1.0)
    coeff = 0.5 * (1.0 + torch.cos(math.pi * ratio))
    cos_lr = mn + coeff * (mx - mn)
    return torch.where(step < warm, warmup_lr, torch.where(step > decay, mn, cos_lr))
