"""On-device preprocessing (≙ nvit_tpu/data/augment.py): AutoAugment on
the uint8 batch for training, then the normalization to [-1, 1]."""

from __future__ import annotations

import torch

from nvit_tpu_torch.data.autoaugment import auto_augment_batch


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → fp32 in [-1, 1]  (≙ ToTensor + Normalize(mean=0.5, std=0.5))."""
    return images_u8.to(torch.float32) * (2.0 / 255.0) - 1.0


def preprocess(
    images_u8: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    train: bool = False,
    dataset: str = "cifar10",
    auto_augment: bool = True,
    row0: int = 0,
    batch: int | None = None,
) -> torch.Tensor:
    """AutoAugment (train only, on uint8, with the dataset's policy, drawn
    from ``generator`` for rows ``row0 …`` of a global batch of ``batch``)
    → normalize.  Without a generator nothing is augmented, as the JAX
    package's ``preprocess`` without a key."""
    if train and auto_augment and generator is not None:
        images_u8 = auto_augment_batch(images_u8, generator, dataset=dataset, row0=row0, batch=batch)
    return normalize(images_u8)
