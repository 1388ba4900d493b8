"""The fused AdamW + hypersphere-renorm update (≙ nvit_tpu/train/optim.py:
``init_fused_adamw`` :77-88, ``decay_mask`` :34-36 and
``fused_adamw_renorm_update`` :150-223), over the ``ViT``'s named parameters.

Per parameter, in the JAX package's fp32 operation order: global-norm clip
scale ``where(gnorm < clip, 1, clip/gnorm)`` → AdamW moments → bias
correction at ``t = count + 1`` → decayed update (eps 1e-8) → apply with
``lr = cosine_lr(count)`` on the 0-based count → (nViT) renorm of the Block
matrices in fp32.  Parameters and moments are updated in place (the JAX
package returns new trees), which keeps one copy of each on the device.

bf16 moments (``optimizer.moments_dtype="bfloat16"``, ≙ optim.py:77-133,
:180-201): the moments are read to fp32, the update computes in fp32, and
the new moments are stored back with stochastic rounding — 16 dither bits
added below the bf16 mantissa, then truncated.  The bits are those of the
JAX package, bit for bit: ``fmix32`` of the element's index in the JAX
leaf's layout (``ckpt.convert.jax_order``: linear weights ``[in, out]``,
the patch embeds fan-in first) under ``sr_dither="hash"``, or threefry
bits of ``fold_in(fold_in(PRNGKey(0x51AB), count), 2·pid + salt)`` under
``"threefry"``, where ``pid`` is ``crc32`` of the leaf's JAX path.  So the
dither depends on (count, leaf, mu/nu) alone: a resumed run rounds as a
straight one.  The uint32 arithmetic runs on int64 tensors masked to 32
bits, its products wrapping mod 2⁶⁴.  The store is plain PyTorch, about 60
launches a parameter under "hash" (~380 under "threefry").

On a rank that holds pieces of the trunk (``layout``, a sharded
``parallel/mesh.Mesh``) the update runs on the pieces: the clip scale
comes from the caller's norm of the WHOLE gradient (``grad_norm``), the
same on every rank; a piece's dither reads its elements' indices in the
whole JAX leaf, so the ranks round as one card does; the renorm's axis is
whole in every piece.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Mapping

import torch

from nvit_tpu_torch.ckpt.convert import jax_order, jax_path
from nvit_tpu_torch.ckpt.tree import threefry2x32
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
    """Zero moments for every parameter, in fp32 or, with ``"bfloat16"``, in
    bf16 (stored with stochastic rounding by the update)."""
    if moments_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moments_dtype must be 'float32' or 'bfloat16', got {moments_dtype!r}")
    dtype = getattr(torch, moments_dtype)
    named = list(named_params)
    zeros = lambda: {n: torch.zeros_like(p, dtype=dtype) for n, p in named}  # noqa: E731
    return FusedAdamWState(count=0, mu=zeros(), nu=zeros())


# ------------------------------------------------ stochastic rounding to bf16
_M32 = 0xFFFFFFFF
_PHI32 = 0x9E3779B9
_SR_KEY = (0, 0x51AB)  # PRNGKey(0x51AB)


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a params path: ``['blocks'][0]['c_fc']['w']``."""
    return "".join(f"[{k!r}]" for k in path)


def leaf_salt(name: str) -> int:
    """The JAX package's per-leaf salt ``pid``: crc32 of the leaf's keystr,
    30 bits (≙ optim.py:197)."""
    return zlib.crc32(keystr(jax_path(name)).encode()) & 0x3FFFFFFF


def fmix32(x):
    """murmur3's 32-bit finalizer on an int or an int64 tensor of uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def jax_index(name: str, shape, local_patch: int, device) -> torch.Tensor:
    """int64 tensor of ``shape`` (the parameter ``name``'s): each element's
    row-major index in the JAX leaf, the index the hash dither reads."""
    idx = torch.empty(shape, dtype=torch.int64, device=device)
    view = jax_order(name, idx, local_patch)
    view.copy_(torch.arange(idx.numel(), device=device).view(view.shape))
    return idx


def sr_with_bits(x32: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fp32 → bf16 with the low 16 of the dither bits ``r`` added below the
    bf16 mantissa, then truncated (≙ optim.py:_sr_with_bits); non-finite
    values take XLA's plain cast — ±inf as they are, NaN as its sign and the
    quiet NaN 0x7FC0 (PyTorch's cast gives other NaN bits, and not the same
    on the CPU and the card).  The int32 sum cannot overflow for a finite x."""
    xi = x32.view(torch.int32)
    y = (xi + (r & 0xFFFF).to(torch.int32)) & -0x10000
    nonfinite = (xi & -0x800000) | (torch.isnan(x32).to(torch.int32) << 22)
    y = torch.where(torch.isfinite(x32), y, nonfinite)
    return (y >> 16).to(torch.int16).view(torch.bfloat16)


def sr_store(opt_cfg: OptimizerConfig, count: int, name: str, index: torch.Tensor):
    """(x32, salt) → bf16: the SR store of the moment ``salt`` (0 mu, 1 nu)
    of parameter ``name`` at update ``count``; ``index`` is ``jax_index``'s.
    "hash": fmix32((index · φ32) ^ seed), the seed mixing (count, pid, salt)
    (≙ optim.py:sr_bf16_hash); "threefry": ``jax.random.bits``'s bits under
    ``jax_threefry_partitionable``, x0 ^ x1 of threefry(key, (0, index))
    (≙ optim.py:sr_bf16)."""
    pid = leaf_salt(name)
    if opt_cfg.sr_dither == "hash":
        mixed = (index * _PHI32) & _M32
        return lambda x, salt: sr_with_bits(
            x, fmix32(mixed ^ fmix32((count & _M32) ^ (((2 * pid + salt) * _PHI32) & _M32))))
    base = threefry2x32(_SR_KEY, (0, count & _M32))  # fold_in(PRNGKey(0x51AB), count)

    def threefry_store(x, salt):
        x0, x1 = threefry2x32(threefry2x32(base, (0, 2 * pid + salt)), (0, index))
        return sr_with_bits(x, x0 ^ x1)

    return threefry_store


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
    grad_norm: torch.Tensor | None = None,
    layout=None,
) -> FusedAdamWState:
    """Apply one fused AdamW(+renorm) step to ``params`` in place → the new
    state.  ``grad_norm``: the clip's norm, default the norm of ``grads``;
    ``layout``: the ``Mesh`` whose pieces ``params`` are."""
    b1, b2, wd = opt_cfg.beta1, opt_cfg.beta2, opt_cfg.weight_decay
    device = next(iter(params.values())).device
    gscale = None
    if opt_cfg.grad_clip:
        gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
        clip = torch.tensor(opt_cfg.grad_clip, dtype=torch.float32, device=device)
        gscale = torch.where(gnorm < clip, torch.ones_like(clip), clip / gnorm)

    lr = cosine_lr(opt_cfg, state.count).to(device)
    t = torch.tensor(state.count + 1, dtype=torch.float32)
    bc1 = (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), t)).to(device)
    bc2 = (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), t)).to(device)
    decay = decay_mask(params.items())
    local_patch = params["local_patch_embed.weight"].shape[-1]

    for name, p in params.items():
        g = grads[name]
        if gscale is not None:
            g = g * gscale.to(g.dtype)
        m, v = state.mu[name], state.nu[name]
        store = None
        if m.dtype == torch.bfloat16:
            if layout is None:
                index = jax_index(name, p.shape, local_patch, device)
            else:
                index = layout.take(name, jax_index(name, layout.full_shape(name, p.shape), local_patch, device))
            store = sr_store(opt_cfg, state.count, name, index)
            m, v, g = m.float(), v.float(), g.float()
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + _ADAM_EPS)
        if decay[name]:
            upd = upd + wd * p.to(upd.dtype)
        new_p = p - lr.to(p.dtype) * upd.to(p.dtype)
        dim = renorm_dim(name) if renorm else None
        if dim is not None:
            new_p = justnorm_weight(new_p.float(), dim).to(p.dtype)
        p.copy_(new_p)
        state.mu[name].copy_(m if store is None else store(m, 0))
        state.nu[name].copy_(v if store is None else store(v, 1))
    return FusedAdamWState(count=state.count + 1, mu=state.mu, nu=state.nu)
