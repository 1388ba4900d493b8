"""Classification losses and accuracy (≙ nvit_tpu/models/losses.py:18-40,
:146).  The Kohonen losses come with the SOM (ROADMAP.md)."""

from __future__ import annotations

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
