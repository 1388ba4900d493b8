"""Post-step weight renormalization for nViT (≙ nvit_tpu/ops/renorm.py).

After every optimizer step in nViT mode the self-attention ``Block``
matrices are L2-renormalized, keeping every weight vector on the unit
hypersphere: Q/K/V/c_fc along their input dimension, the two output
projections along their output dimension.  The cross-attention, the patch
embeds and the head are left alone, as in the JAX package.

The axes are flipped for torch's ``[out, in]`` layout (the JAX package keeps
``[in, out]``): ``dim=1`` normalizes over the input features.  The norms
compute in fp32 and cast back.
"""

from __future__ import annotations

import re

import torch

# weight name → dim to normalize, in torch's [out, in] layout
RENORM_AXES: dict[str, int] = {
    "query": 1,
    "key": 1,
    "value": 1,
    "c_fc": 1,
    "att_c_proj": 0,
    "mlp_c_proj": 0,
}

_BLOCK_WEIGHT = re.compile(r"^transformer\.h\.\d+\.(\w+)\.weight$")


def renorm_dim(name: str) -> int | None:
    """The renorm dim of the ``ViT`` parameter ``name``, or None when it is
    not a self-attention Block matrix (≙ optim.py:_renorm_axis_of)."""
    m = _BLOCK_WEIGHT.match(name)
    return RENORM_AXES.get(m.group(1)) if m else None


def justnorm_weight(w: torch.Tensor, dim: int) -> torch.Tensor:
    """fp32 ``w / ‖w‖`` along ``dim``, cast back to w's dtype."""
    w32 = w.float()
    return (w32 / torch.sqrt(torch.sum(w32 * w32, dim=dim, keepdim=True))).to(w.dtype)
