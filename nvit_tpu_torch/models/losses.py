"""The losses and accuracy (≙ nvit_tpu/models/losses.py): cross-entropy,
mse, top-k accuracy, and the Kohonen terms — Huber quantization, the
consistency of the two maps' representations and the maps' smoothness.

The Kohonen norms are collapse-safe: a node pulled to exactly 0 gets a zero
gradient, not NaN (``_safe_norm``, ``_safe_unit``: the double ``where``).
``map_smoothness`` takes each node's 8 grid neighbours with ``torch.roll``
over the [m, n, d] view of the codebook (a grid of exactly m·n nodes): the
same neighbours as ``neighbor_indices``, with a deterministic backward where
a gather's would be a scatter-add.
"""

from __future__ import annotations

import numpy as np
import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels, in fp32 whatever the
    logit dtype."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - picked)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    diff = pred.float() - target.float()
    return torch.mean(diff * diff)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """(top-1 %, top-k %); k clamps to the number of classes."""
    maxk = min(k, logits.shape[-1])
    pred = torch.topk(logits.float(), maxk, dim=-1).indices
    correct = pred == labels.long()[..., None]
    top1 = torch.mean(correct[..., 0].float()) * 100.0
    topk = torch.mean(torch.any(correct, dim=-1).float()) * 100.0
    return top1, topk


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Mean Huber loss (delta 1), in fp32."""
    diff = pred.float() - target.float()
    abs_diff = torch.abs(diff)
    quad = 0.5 * diff * diff
    lin = delta * (abs_diff - 0.5 * delta)
    return torch.mean(torch.where(abs_diff <= delta, quad, lin))


def _safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """‖x‖ along ``dim``, with a zero gradient where it is exactly 0."""
    d2 = torch.sum(x * x, dim=dim)
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))), torch.zeros_like(d2))


def _safe_unit(x: torch.Tensor) -> torch.Tensor:
    """x/‖x‖ (the norm floored at 1e-12), 0 with a zero gradient at x = 0."""
    n = _safe_norm(x)[..., None]
    pos = n > 0
    num = torch.where(pos, x, torch.zeros_like(x))
    denom = torch.where(pos, torch.clamp(n, min=1e-12), torch.ones_like(n))
    return num / denom


def consistency_loss(local_repr: torch.Tensor, global_repr: torch.Tensor) -> torch.Tensor:
    """1 − the mean cosine similarity of the two representations."""
    ln = _safe_unit(local_repr.float())
    gn = _safe_unit(global_repr.float())
    return 1.0 - torch.mean(torch.sum(ln * gn, dim=-1))


# the 8-neighbourhood on the grid, (row, col) steps in neighbor_indices' order
NEIGHBOR_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def neighbor_indices(indices: torch.Tensor, grid_m: int, grid_n: int) -> torch.Tensor:
    """indices [...] → their 8 neighbours [..., 8] on the m×n grid (index =
    row·n + col), wrapping modulo (m, n)."""
    off = torch.from_numpy(np.array(NEIGHBOR_OFFSETS, dtype=np.int64)).to(indices.device)
    nrow = torch.remainder(indices[..., None] // grid_n + off[:, 0], grid_m)
    ncol = torch.remainder(indices[..., None] % grid_n + off[:, 1], grid_n)
    return nrow * grid_n + ncol


def map_smoothness(nodes: torch.Tensor, indices: torch.Tensor, grid_m: int, grid_n: int) -> torch.Tensor:
    """Mean over the BMUs of the mean distance from the BMU's node to its 8
    neighbours': the per-node table [N] weighted by each node's BMU count."""
    n_nodes = nodes.shape[0]
    cur = nodes.float()
    grid = cur.reshape(grid_m, grid_n, -1)
    dists = [_safe_norm(cur - torch.roll(grid, (-dr, -dc), dims=(0, 1)).reshape(n_nodes, -1))
             for dr, dc in NEIGHBOR_OFFSETS]
    table = torch.mean(torch.stack(dists, dim=-1), dim=-1)  # [N]
    idx = indices.reshape(-1)
    # a scatter, not bincount: no read-back of the indices to the host
    counts = torch.zeros(n_nodes, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx)).float()
    return torch.sum(counts * table) / idx.shape[0]


def smoothness_loss(local_nodes: torch.Tensor, local_indices: torch.Tensor, global_nodes: torch.Tensor,
                    global_indices: torch.Tensor, grid_m: int, grid_n: int) -> torch.Tensor:
    """The two maps' smoothness terms, summed."""
    return (map_smoothness(local_nodes, local_indices, grid_m, grid_n)
            + map_smoothness(global_nodes, global_indices, grid_m, grid_n))
