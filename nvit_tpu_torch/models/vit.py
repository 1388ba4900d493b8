"""The nViT classifier (≙ nvit_tpu/models/vit.py, non-Kohonen forward).

``ViT`` carries the reference ``state_dict`` layout — exactly the keys
``nvit_tpu/ckpt/torch_interop.py::state_dict_from_params`` emits, minus the
unused nViT ``rmsnorm_att/mlp`` weights — so converted JAX parameters load
with ``load_state_dict(strict=True)``.  ``forward`` returns the logits:
dual patch embed → shared cross-attention → blocks with the outer
``norm_skip`` → mean-pool → LayerNorm head (no compute dtype) → ``sz`` scale.
The reconstruction head's parameters exist for the ``state_dict``; its
output is a training loss term only and is not computed here.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.core.layers import linear
from nvit_tpu_torch.core.norms import layer_norm
from nvit_tpu_torch.core.residual import norm_skip
from nvit_tpu_torch.models.blocks import Block, CrossAttentionBlock, init_linear
from nvit_tpu_torch.models.patch import (
    extract_overlapping_patches,
    global_embed_permutation,
    reflect_pad,
    space_to_depth,
)


def check_supported(cfg: ViTConfig) -> None:
    cfg.validate()
    if cfg.use_kohonen:
        raise NotImplementedError(
            "use_kohonen=True: the Kohonen SOM is not ported yet (ROADMAP.md queue 1, 'Kohonen')"
        )
    if not cfg.use_nvit:
        raise NotImplementedError(
            "use_nvit=False: baseline mode is not ported yet (ROADMAP.md queue 1, "
            "'baseline + K7/K8/K9')"
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

    def forward(self, img: torch.Tensor, *, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """img [B, C, H, W] fp32 → logits [B, num_classes] fp32."""
        cfg = self.cfg
        local, global_ = self.embed_patches(img, compute_dtype=compute_dtype)
        patches = self.cross_attention(local, global_, compute_dtype=compute_dtype)
        for blk in self.transformer["h"]:
            patches = norm_skip(blk(patches, compute_dtype=compute_dtype), patches, blk.skip_param)
        x = torch.mean(patches, dim=1)
        norm, head = self.mlp_head[0], self.mlp_head[1]
        # the head runs without a compute dtype, exactly as vit.py:211
        logits = linear(layer_norm(x, norm.weight, norm.bias), head.weight, head.bias)
        sz_eff = self.sz * (cfg.sz_init_value / cfg.sz_init_scaling)
        return logits.float() * sz_eff
