"""The fused AdamW + hypersphere-renorm update (≙ nvit_tpu/train/optim.py:
``init_fused_adamw`` :77-88, ``decay_mask`` :34-36 and
``fused_adamw_renorm_update`` :150-223), over the ``ViT``'s named parameters.

Per parameter, in the JAX package's fp32 operation order: global-norm clip
scale ``where(gnorm < clip, 1, clip/gnorm)`` → AdamW moments → bias
correction at ``t = count + 1`` → decayed update (eps 1e-8) → apply with
``lr = cosine_lr(count)`` on the 0-based count → (nViT) renorm of the Block
matrices in fp32.  Parameters and moments are updated in place (the JAX
package returns new trees), which keeps one copy of each on the device.

bf16 moments and their stochastic-rounding dither (optim.py:91-133) are not
ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from nvit_tpu_torch.configs import OptimizerConfig
from nvit_tpu_torch.models.schedules import cosine_lr
from nvit_tpu_torch.ops.renorm import justnorm_weight, renorm_dim

_ADAM_EPS = 1e-8

# ViT parameters whose JAX leaf has another rank than the torch tensor: the
# patch embeds are Conv2d [d, C, p, p] here and [C·p·p, d] matrices there
# (models/patch.py applies them as matmuls)
_JAX_LEAF_NDIM = {"local_patch_embed.weight": 2, "global_patch_embed.1.weight": 2}


def decay_mask(named_params) -> dict[str, bool]:
    """True for parameters that receive weight decay: those whose JAX leaf
    has ndim ≥ 2 (≙ optim.py:decay_mask)."""
    return {name: _JAX_LEAF_NDIM.get(name, p.dim()) >= 2 for name, p in named_params}


@dataclass
class FusedAdamWState:
    count: int  # number of updates applied so far
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def init_fused_adamw(named_params, moments_dtype: str = "float32") -> FusedAdamWState:
    """Zero fp32 moments for every parameter."""
    if moments_dtype != "float32":
        raise NotImplementedError(
            f"moments_dtype={moments_dtype!r}: bf16 moments with stochastic rounding are not "
            "ported yet (ROADMAP.md, 'bf16 moments')"
        )
    named = list(named_params)
    zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named}  # noqa: E731
    return FusedAdamWState(count=0, mu=zeros(), nu=zeros())


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ Σ x²) over the tensors, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tensors))


@torch.no_grad()
def fused_adamw_renorm_update(
    opt_cfg: OptimizerConfig,
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: FusedAdamWState,
    *,
    renorm: bool,
) -> FusedAdamWState:
    """Apply one fused AdamW(+renorm) step to ``params`` in place → the new state."""
    b1, b2, wd = opt_cfg.beta1, opt_cfg.beta2, opt_cfg.weight_decay
    device = next(iter(params.values())).device
    gscale = None
    if opt_cfg.grad_clip:
        gnorm = global_norm(grads.values())
        clip = torch.tensor(opt_cfg.grad_clip, dtype=torch.float32, device=device)
        gscale = torch.where(gnorm < clip, torch.ones_like(clip), clip / gnorm)

    lr = cosine_lr(opt_cfg, state.count).to(device)
    t = torch.tensor(state.count + 1, dtype=torch.float32)
    bc1 = (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)).to(device)
    bc2 = (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)).to(device)
    decay = decay_mask(params.items())

    for name, p in params.items():
        g = grads[name]
        if gscale is not None:
            g = g * gscale.to(g.dtype)
        m = b1 * state.mu[name] + (1.0 - b1) * g
        v = b2 * state.nu[name] + (1.0 - b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS)
        if decay[name]:
            upd = upd + wd * p.to(upd.dtype)
        new_p = p - lr.to(p.dtype) * upd.to(p.dtype)
        dim = renorm_dim(name) if renorm else None
        if dim is not None:
            new_p = justnorm_weight(new_p.float(), dim).to(p.dtype)
        p.copy_(new_p)
        state.mu[name].copy_(m)
        state.nu[name].copy_(v)
    return FusedAdamWState(count=state.count + 1, mu=state.mu, nu=state.nu)
