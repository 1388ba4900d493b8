"""Serving-side preprocessing (≙ nvit_tpu/data/augment.py:19-21).

Training augmentation (AutoAugment) comes with the training slice.
"""

from __future__ import annotations

import torch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → fp32 in [-1, 1]  (≙ ToTensor + Normalize(mean=0.5, std=0.5))."""
    return images_u8.to(torch.float32) * (2.0 / 255.0) - 1.0
