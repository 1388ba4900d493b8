"""On-device preprocessing (≙ nvit_tpu/data/augment.py:19-44): normalize,
and the training-time AutoAugment dispatch, which is not ported yet."""

from __future__ import annotations

import torch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → fp32 in [-1, 1]  (≙ ToTensor + Normalize(mean=0.5, std=0.5))."""
    return images_u8.to(torch.float32) * (2.0 / 255.0) - 1.0


def preprocess(images_u8: torch.Tensor, *, train: bool = False, auto_augment: bool = True) -> torch.Tensor:
    """AutoAugment (train only, on uint8) → normalize.  AutoAugment raises:
    it is not in this slice (ROADMAP.md, 'AutoAugment')."""
    if train and auto_augment:
        raise NotImplementedError(
            "AutoAugment is not ported yet (ROADMAP.md, 'AutoAugment'); "
            "set data.augmentation.auto_augment=false"
        )
    return normalize(images_u8)
