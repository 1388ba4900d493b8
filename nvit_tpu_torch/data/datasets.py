"""Datasets (≙ nvit_tpu/data/datasets.py): the in-memory ``ArrayDataset``
and the deterministic synthetic data.

Images are CHW uint8 [0, 255]; normalization runs on the device
(``data/augment.py``).  Only ``synthetic`` is ported: CIFAR, ImageNet and
digits raise until the data slice (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

# elements of int64 noise drawn at once by make_synthetic (~64 MB)
_NOISE_CHUNK = 1 << 23


@dataclass
class ArrayDataset:
    """In-memory dataset: images uint8 [N, C, H, W], labels int32 [N]."""

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    name: str = "array"

    def __len__(self) -> int:
        return len(self.images)


def make_synthetic(
    *, num_examples: int = 2048, image_size: int = 32, num_classes: int = 100, seed: int = 0
) -> ArrayDataset:
    """Deterministic synthetic data with class-dependent structure, so models
    can overfit it — the same arrays as the JAX package's from the same seed.

    The JAX package draws the noise for all images in one call and adds it to
    ``base[labels]`` in int64 (about 11 GB of intermediates at 224 px and
    4096 images).  Here the noise is drawn in chunks of images: the legacy
    ``RandomState.randint`` stream draws element by element, so the values
    are unchanged (tests/test_torch_train.py holds them equal)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=num_examples).astype(np.int32)
    base = rng.randint(0, 255, size=(num_classes, 3, image_size, image_size)).astype(np.int16)
    images = np.empty((num_examples, 3, image_size, image_size), dtype=np.uint8)
    rows = max(1, _NOISE_CHUNK // (3 * image_size * image_size))
    for i in range(0, num_examples, rows):
        n = min(rows, num_examples - i)
        noise = rng.randint(-30, 30, size=(n, 3, image_size, image_size)).astype(np.int16)
        images[i:i + n] = np.clip(base[labels[i:i + n]] + noise, 0, 255)
    return ArrayDataset(images=images, labels=labels, num_classes=num_classes, name="synthetic")


def load_dataset(
    dataset: str,
    data_dir: str | Path,
    *,
    train: bool = True,
    image_size: int = 32,
    num_classes: int = 100,
) -> ArrayDataset:
    """Dataset dispatch (≙ datasets.py:load_dataset); ``synthetic`` only."""
    d = dataset.lower()
    if d == "synthetic":
        return make_synthetic(
            num_examples=4096 if train else 1024,
            image_size=image_size,
            num_classes=num_classes,
            seed=0 if train else 1,
        )
    if d in ("cifar10", "cifar100", "imagenet", "digits"):
        raise NotImplementedError(
            f"dataset={dataset!r}: only 'synthetic' is ported so far (ROADMAP.md, "
            "'datasets and the data pipeline')"
        )
    raise ValueError(f"Unknown dataset: {dataset}")
