"""Input pipeline (≙ nvit_tpu/data/pipeline.py:36-72): seeded per-epoch
shuffling, host batching of in-memory arrays, and the upload of uint8
batches to the device (normalization runs there, data/augment.py)."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from nvit_tpu_torch.data.datasets import ArrayDataset

Batch = tuple[np.ndarray, np.ndarray]  # (images u8 [B, C, H, W], labels i32 [B])


def epoch_indices(n: int, *, epoch: int, seed: int, shuffle: bool) -> np.ndarray:
    """Per-epoch index order (≙ pipeline.py:epoch_indices on one host)."""
    return np.random.RandomState(seed + epoch).permutation(n) if shuffle else np.arange(n)


def iterate_array(
    ds: ArrayDataset, *, batch_size: int, epoch: int = 0, seed: int = 42,
    shuffle: bool = True, drop_last: bool = True, start_batch: int = 0,
) -> Iterator[Batch]:
    """Host batches of ``ds`` in the epoch's order; ``start_batch`` skips the
    first batches (a mid-epoch resume)."""
    idx = epoch_indices(len(ds), epoch=epoch, seed=seed, shuffle=shuffle)
    end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
    for start in range(max(0, start_batch) * batch_size, end, batch_size):
        sel = idx[start:start + batch_size]
        yield ds.images[sel], ds.labels[sel]


def to_device(batch: Batch, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Upload one host batch: uint8 images (a quarter of the fp32 bytes) and
    int64 labels; from pinned memory without blocking on a CUDA device."""
    imgs, labels = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    if device.type == "cuda":
        imgs, labels = imgs.pin_memory(), labels.pin_memory()
    return imgs.to(device, non_blocking=True), labels.to(device, torch.int64, non_blocking=True)
