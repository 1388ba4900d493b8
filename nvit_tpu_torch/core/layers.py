"""The linear-layer casting contract (≙ nvit_tpu/core/layers.py:43-85).

Weights use torch's ``nn.Linear`` layout ``[out, in]``.  Plain projections
stay ``F.linear`` (cuBLAS on the card), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    *,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x @ wᵀ (+ b)``.  With ``compute_dtype`` set, x and w are cast before
    the matmul and the output stays in the compute dtype; the bias is cast to
    the output dtype.  Without it, no cast happens anywhere."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = F.linear(x, w)
    if b is not None:
        y = y + (b.to(y.dtype) if compute_dtype is not None else b)
    return y


def concat_linears(parts: list[tuple[torch.Tensor, torch.Tensor | None]]):
    """Fuse linears that share an input (the QKV / KV projections) into one
    wider projection: out-axis concatenation of weights and biases, i.e.
    dim 0 in the ``[out, in]`` layout.  → (w, b or None)."""
    w = torch.cat([p[0] for p in parts], dim=0)
    b = torch.cat([p[1] for p in parts]) if parts[0][1] is not None else None
    return w, b
