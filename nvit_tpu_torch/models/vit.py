"""The nViT classifier (≙ nvit_tpu/models/vit.py, non-Kohonen forward), in
nViT and baseline (``use_nvit=False``) mode.

``ViT`` carries the reference ``state_dict`` layout — the keys
``nvit_tpu/ckpt/torch_interop.py::state_dict_from_params`` emits, minus the
unused nViT ``rmsnorm_att/mlp`` weights in nViT mode, plus the baseline
blocks' ``rmsnorm_att/mlp`` weights (which that function drops) in baseline
mode — so converted JAX parameters load with ``load_state_dict(strict=True)``.
``forward`` returns the logits: dual patch embed → shared cross-attention →
blocks with the outer ``norm_skip`` (both modes) → mean-pool → LayerNorm
head (no compute dtype) → the ``sz`` scale (nViT only; baseline has no
``sz``).
``forward_train`` also returns the aux losses (the reconstruction term,
reported but not weighted into the loss without Kohonen); ``total_loss``,
``num_params`` and ``estimate_flops_per_iter`` follow vit.py.

Under ``remat`` (``system.remat``) the cross-attention and every block but
the last ``remat_skip`` are recomputed in the backward (≙ vit.py:138-141,
:197-207, ``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``):
``torch.utils.checkpoint`` with a selective policy that saves the outputs
of the unbatched products (``aten.mm``, ``aten.addmm``: the projections)
and recomputes the rest.  The attention and gated-MLP kernels are no such
product, on either side: their forwards run again in the recompute, as
the JAX package's ``pallas_call``s do.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.core.layers import linear
from nvit_tpu_torch.core.norms import layer_norm
from nvit_tpu_torch.core.residual import norm_skip
from nvit_tpu_torch.models.losses import cross_entropy, mse_loss
from nvit_tpu_torch.models.blocks import Block, CrossAttentionBlock, init_linear
from nvit_tpu_torch.models.patch import (
    extract_overlapping_patches,
    global_embed_permutation,
    reflect_pad,
    space_to_depth,
)


# the products whose outputs remat saves: the unbatched ones (≙ JAX's
# dots_with_no_batch_dims_saveable); batched products (bmm) are recomputed
_SAVED_UNDER_REMAT = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_UNDER_REMAT else CheckpointPolicy.PREFER_RECOMPUTE


def rematerialized(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` whose activations, but for the saved
    products, are recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(_dots_saveable), **kwargs)


def check_supported(cfg: ViTConfig) -> None:
    cfg.validate()
    if cfg.use_kohonen:
        raise NotImplementedError(
            "use_kohonen=True: the Kohonen SOM is not ported yet (ROADMAP.md queue 1, 'Kohonen')"
        )


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device: torch.device | str):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, c = cfg.n_embd, cfg.channels
        lp, gp = cfg.local_patch_size, cfg.global_patch_size
        pad = (gp - lp) // 2
        # Conv2d modules hold the weights in the reference layout; the forward
        # applies them as matmuls over extracted patches (models/patch.py)
        self.local_patch_embed = nn.Conv2d(c, d, lp, stride=lp, device=device)
        self.global_patch_embed = nn.Sequential(
            nn.ReflectionPad2d(pad), nn.Conv2d(c, d, gp, stride=lp, device=device)
        )
        self.local_pos_embed = nn.Parameter(torch.empty(1, cfg.n_patches, d, device=device))
        self.global_pos_embed = nn.Parameter(torch.empty(1, cfg.n_patches, d, device=device))
        self.cross_attention = CrossAttentionBlock(cfg, device=device)
        self.reconstruction_head = nn.Sequential(
            nn.Linear(d, lp * lp * c, bias=True, device=device), nn.Tanh()
        )
        self.transformer = nn.ModuleDict(
            {"h": nn.ModuleList([Block(cfg, device=device) for _ in range(cfg.n_layer)])}
        )
        self.mlp_head = nn.Sequential(
            nn.LayerNorm(d, device=device), nn.Linear(d, cfg.num_classes, device=device)
        )
        if cfg.use_nvit:
            self.sz = nn.Parameter(torch.empty(cfg.num_classes, device=device))
        perm = global_embed_permutation(c, gp, lp)
        self.register_buffer(
            "global_embed_perm", torch.from_numpy(perm).to(device), persistent=False
        )

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> "ViT":
        """Fresh weights with init_vit's distributions (≙ vit.py:63-96), drawn
        from ``g`` (a generator on the parameters' device)."""
        cfg = self.cfg
        for conv in (self.local_patch_embed, self.global_patch_embed[1]):
            fan_in = cfg.channels * conv.kernel_size[0] * conv.kernel_size[1]
            bound = 1.0 / math.sqrt(fan_in)
            conv.weight.uniform_(-bound, bound, generator=g)
            conv.bias.uniform_(-bound, bound, generator=g)
        self.local_pos_embed.zero_()
        self.global_pos_embed.zero_()
        self.cross_attention.init_weights(g)
        init_linear(self.reconstruction_head[0], g, 0.02)
        for blk in self.transformer["h"]:
            blk.init_weights(g)
        self.mlp_head[0].weight.fill_(1.0)
        self.mlp_head[0].bias.zero_()
        init_linear(self.mlp_head[1], g, 0.02)
        if cfg.use_nvit:
            self.sz.fill_(cfg.sz_init_value)
        return self

    def embed_patches(
        self, img: torch.Tensor, *, compute_dtype: torch.dtype | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dual patch embedding + position embeddings → ([B,T,d], [B,T,d])
        (≙ vit.py:embed_patches)."""
        cfg = self.cfg
        d, lp, gp = cfg.n_embd, cfg.local_patch_size, cfg.global_patch_size
        conv_l, conv_g = self.local_patch_embed, self.global_patch_embed[1]
        local = linear(space_to_depth(img, lp), conv_l.weight.reshape(d, -1), conv_l.bias,
                       compute_dtype=compute_dtype)
        global_px = extract_overlapping_patches(reflect_pad(img, (gp - lp) // 2), gp, lp)
        w_global = conv_g.weight.reshape(d, -1)[:, self.global_embed_perm]
        global_ = linear(global_px, w_global, conv_g.bias, compute_dtype=compute_dtype)
        local = local + self.local_pos_embed.to(local.dtype)
        global_ = global_ + self.global_pos_embed.to(global_.dtype)
        return local, global_

    def _trunk(self, img: torch.Tensor, compute_dtype: torch.dtype | None, remat: bool = False,
               remat_skip: int = 0) -> torch.Tensor:
        """Embeddings → shared cross-attention → blocks with the outer
        ``norm_skip`` → patches [B, T, d]; under ``remat`` the
        cross-attention and all blocks but the last ``remat_skip`` are
        recomputed in the backward."""
        local, global_ = self.embed_patches(img, compute_dtype=compute_dtype)
        if remat:
            patches = rematerialized(self.cross_attention, local, global_, compute_dtype=compute_dtype)
        else:
            patches = self.cross_attention(local, global_, compute_dtype=compute_dtype)
        blocks = self.transformer["h"]
        for i, blk in enumerate(blocks):
            if remat and i < len(blocks) - remat_skip:
                out = rematerialized(blk, patches, compute_dtype=compute_dtype)
            else:
                out = blk(patches, compute_dtype=compute_dtype)
            patches = norm_skip(out, patches, blk.skip_param)
        return patches

    def _head(self, patches: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = torch.mean(patches, dim=1)
        norm, head = self.mlp_head[0], self.mlp_head[1]
        # the head runs without a compute dtype, exactly as vit.py:211
        logits = linear(layer_norm(x, norm.weight, norm.bias), head.weight, head.bias)
        if not cfg.use_nvit:
            return logits
        sz_eff = self.sz * (cfg.sz_init_value / cfg.sz_init_scaling)
        return logits.float() * sz_eff

    def forward(self, img: torch.Tensor, *, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """img [B, C, H, W] fp32 → logits [B, num_classes] fp32."""
        return self._head(self._trunk(img, compute_dtype))

    def forward_train(
        self, img: torch.Tensor, *, compute_dtype: torch.dtype | None = None, remat: bool = False,
        remat_skip: int = 0,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """→ (logits, aux losses) (≙ vit_apply with train=True, non-Kohonen):
        aux holds ``reconstruction``, the mse of tanh(reconstruction_head
        (patches)) against the raw pixel patches (vit.py:215-217).
        ``remat`` / ``remat_skip``: see the module docstring."""
        patches = self._trunk(img, compute_dtype, remat, remat_skip)
        rec = self.reconstruction_head[0]
        reconstructed = torch.tanh(linear(patches, rec.weight, rec.bias, compute_dtype=compute_dtype))
        target = space_to_depth(img, self.cfg.local_patch_size)
        return self._head(patches), {"reconstruction": mse_loss(reconstructed, target)}


def total_loss(
    cfg: ViTConfig,
    consistency_weight: float,
    smoothness_weight: float,
    logits: torch.Tensor,
    labels: torch.Tensor,
    aux: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """CE + weighted aux losses (≙ vit.py:total_loss).  Without Kohonen the
    loss is the cross-entropy alone and ``reconstruction`` is only reported."""
    if cfg.use_kohonen:
        raise NotImplementedError("the Kohonen losses come with the SOM (ROADMAP.md, 'Kohonen SOM')")
    class_loss = cross_entropy(logits, labels)
    terms = {"class_loss": class_loss, "reconstruction": aux["reconstruction"], "total_loss": class_loss}
    return class_loss, terms


def num_params(model: nn.Module) -> int:
    """Parameter count (≙ vit.py:num_params — the same leaves as init_vit)."""
    return sum(p.numel() for p in model.parameters())


def estimate_flops_per_iter(cfg: ViTConfig, n_params: int, fwdbwd_per_iter: int = 1) -> float:
    """FLOPs per image and iteration (≙ vit.py:estimate_flops_per_iter):
    flops/token = 6N + 12·L·H·Q·T, flops/iter = flops/token · T · fwdbwd."""
    L_, H, Q = cfg.n_layer, cfg.n_head, cfg.head_dim
    T = cfg.n_patches
    flops_per_token = 6 * n_params + 12 * L_ * H * Q * T
    return float(flops_per_token * T * fwdbwd_per_iter)
