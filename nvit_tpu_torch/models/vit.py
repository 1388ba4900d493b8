"""The nViT classifier (≙ nvit_tpu/models/vit.py), in nViT and baseline
(``use_nvit=False``) mode, with or without the Kohonen SOM.

``ViT`` carries the reference ``state_dict`` layout — the keys and order of
``nvit_tpu/ckpt/torch_interop.py::state_dict_from_params`` /
``reference_state_dict_order``, minus the unused nViT ``rmsnorm_att/mlp``
weights in nViT mode, plus the baseline blocks' ``rmsnorm_att/mlp`` weights
(which that function drops) in baseline mode — so converted JAX parameters
load with ``load_state_dict(strict=True)``.  ``forward`` returns the logits:
dual patch embed → the cross-attention fusion → blocks with the outer
``norm_skip`` (both modes) → mean-pool → LayerNorm head (no compute dtype)
→ the ``sz`` scale (nViT only; baseline has no ``sz``).

The fusion without Kohonen is one pass of the shared cross-attention over
(local, global).  With Kohonen (≙ vit.py:146-186) each stream's BMU
representation comes from its own map (``local_kohonen``,
``global_kohonen``: two maps of ``kohonen_nodes // 2``), and the shared
cross-attention runs three times: (local repr, local), (global repr,
global), then the two results.  ``map_balance`` is created, as in the
reference, and read nowhere.

``forward_train`` returns (logits, aux losses, SOM info): aux holds the
``reconstruction`` term (weighted into the loss only with Kohonen) and,
with Kohonen, ``kohonen_consistency``, ``kohonen_smoothness``,
``local_quantization`` and ``global_quantization``; the SOM info holds the
BMU indices and, under ``hebbian``, the two maps' Hebbian deltas, computed
against the current nodes for the train step to add after the update.
``total_loss``, ``num_params`` and ``estimate_flops_per_iter`` follow vit.py.

An int8 model (``ops.quant.quantize_vit``) holds ``QuantLinear`` modules in
place of its linears and patch-embedding convs; the forwards pass their
``QuantParams`` weights to ``core.layers.linear`` as they pass float ones
(≙ vit.py:102, 108, 211, 215).

Under ``remat`` (``system.remat``) each cross-attention pass and every block
but the last ``remat_skip`` are recomputed in the backward (≙ vit.py:138-141,
:197-207, ``jax.checkpoint`` with ``dots_with_no_batch_dims_saveable``):
``torch.utils.checkpoint`` with a selective policy that saves the outputs
of the unbatched products (``aten.mm``, ``aten.addmm``: the projections)
and recomputes the rest.  The attention and gated-MLP kernels are no such
product, on either side: their forwards run again in the recompute, as
the JAX package's ``pallas_call``s do.  The BMU search and the Hebbian
delta stay outside the recomputed regions.
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
from nvit_tpu_torch.models import losses as L
from nvit_tpu_torch.models.blocks import Block, CrossAttentionBlock, init_linear
from nvit_tpu_torch.models.patch import (
    extract_overlapping_patches,
    global_embed_permutation,
    reflect_pad,
    space_to_depth,
)
from nvit_tpu_torch.models.schedules import kohonen_lr
from nvit_tpu_torch.ops.quant import QuantLinear
from nvit_tpu_torch.som.kohonen import KohonenMap, KohonenSpec, bmu, hebbian_delta, make_spec, neighborhood_kernel


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


def kohonen_spec(cfg: ViTConfig) -> KohonenSpec:
    """Each map's geometry: half the node budget.  With the Kohonen
    scheduler on, the map's alpha is ``kohonen_scheduler_min_lr`` (the
    schedule multiplies it), else ``kohonen_alpha``."""
    alpha = cfg.kohonen_scheduler_min_lr if cfg.kohonen_scheduler_enabled else cfg.kohonen_alpha
    return make_spec(cfg.n_embd, cfg.kohonen_nodes // 2, alpha=alpha)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, *, device: torch.device | str):
        super().__init__()
        cfg.validate()
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
        if cfg.use_kohonen:
            # registered here and below to keep the reference's state_dict order
            self.map_balance = nn.Parameter(torch.empty((), device=device))
        if cfg.use_nvit:
            self.sz = nn.Parameter(torch.empty(cfg.num_classes, device=device))
        if cfg.use_kohonen:
            spec = kohonen_spec(cfg)
            self.local_kohonen = KohonenMap(spec, device=device)
            self.global_kohonen = KohonenMap(spec, device=device)
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
        if cfg.use_kohonen:
            self.local_kohonen.init_weights(g)
            self.global_kohonen.init_weights(g)
            self.map_balance.fill_(cfg.map_balance_weight)
        return self

    def embed_patches(
        self, img: torch.Tensor, *, compute_dtype: torch.dtype | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dual patch embedding + position embeddings → ([B,T,d], [B,T,d])
        (≙ vit.py:embed_patches)."""
        cfg = self.cfg
        d, lp, gp = cfg.n_embd, cfg.local_patch_size, cfg.global_patch_size
        conv_l, conv_g = self.local_patch_embed, self.global_patch_embed[1]
        # an int8 embed (ops/quant.py) holds its fan-in in this order already
        w_local, w_global = conv_l.weight, conv_g.weight
        if not isinstance(conv_l, QuantLinear):
            w_local = w_local.reshape(d, -1)
            w_global = w_global.reshape(d, -1)[:, self.global_embed_perm]
        local = linear(space_to_depth(img, lp), w_local, conv_l.bias, compute_dtype=compute_dtype)
        global_px = extract_overlapping_patches(reflect_pad(img, (gp - lp) // 2), gp, lp)
        global_ = linear(global_px, w_global, conv_g.bias, compute_dtype=compute_dtype)
        local = local + self.local_pos_embed.to(local.dtype)
        global_ = global_ + self.global_pos_embed.to(global_.dtype)
        return local, global_

    def _cross(self, a: torch.Tensor, b: torch.Tensor, compute_dtype, remat: bool) -> torch.Tensor:
        if remat:
            return rematerialized(self.cross_attention, a, b, compute_dtype=compute_dtype)
        return self.cross_attention(a, b, compute_dtype=compute_dtype)

    def _fuse(self, local: torch.Tensor, global_: torch.Tensor, compute_dtype, remat: bool, *,
              step: int | torch.Tensor = 0, hebbian: bool = False, aux: dict | None = None,
              som_info: dict | None = None) -> torch.Tensor:
        """The cross-attention fusion of the two streams → patches [B, T, d].
        With Kohonen: the BMU search on both maps, the three passes, the
        Kohonen aux losses into ``aux`` and the indices (and, under
        ``hebbian``, the deltas at ``step``) into ``som_info`` when given."""
        cfg = self.cfg
        if not cfg.use_kohonen:
            return self._cross(local, global_, compute_dtype, remat)
        maps = (self.local_kohonen, self.global_kohonen)
        (local_repr, local_idx), (global_repr, global_idx) = (
            bmu(k.nodes, x) for k, x in zip(maps, (local, global_)))
        if som_info is not None:
            som_info.update(local_indices=local_idx, global_indices=global_idx)
            if hebbian and cfg.kohonen_hebbian != "off":
                spec = maps[0].spec
                kernel = neighborhood_kernel(spec, local.device)
                lr = kohonen_lr(cfg, step)  # fp32 on the host, like the optimizer's
                # "reference": the all-sample delta over T, the reference's per-step magnitude
                heb_lr = lr / local.shape[-2] if cfg.kohonen_hebbian == "reference" else lr
                for name, k, x, idx in (("local_delta", maps[0], local, local_idx),
                                        ("global_delta", maps[1], global_, global_idx)):
                    som_info[name] = hebbian_delta(k.nodes, kernel, x, idx, heb_lr, spec.alpha)
        local_new = self._cross(local_repr, local, compute_dtype, remat)
        global_new = self._cross(global_repr, global_, compute_dtype, remat)
        if aux is not None:
            m, n = maps[0].spec.m, maps[0].spec.n
            aux["kohonen_consistency"] = L.consistency_loss(local_repr, global_repr)
            aux["kohonen_smoothness"] = L.smoothness_loss(maps[0].nodes, local_idx, maps[1].nodes,
                                                          global_idx, m, n)
            aux["local_quantization"] = L.huber_loss(local_repr, local)
            aux["global_quantization"] = L.huber_loss(global_repr, global_)
        return self._cross(local_new, global_new, compute_dtype, remat)

    def _trunk(self, img: torch.Tensor, compute_dtype: torch.dtype | None, remat: bool = False,
               remat_skip: int = 0, **fuse) -> torch.Tensor:
        """Embeddings → the fusion → blocks with the outer ``norm_skip`` →
        patches [B, T, d]; under ``remat`` the cross-attention passes and all
        blocks but the last ``remat_skip`` are recomputed in the backward."""
        local, global_ = self.embed_patches(img, compute_dtype=compute_dtype)
        patches = self._fuse(local, global_, compute_dtype, remat, **fuse)
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
        self, img: torch.Tensor, *, step: int | torch.Tensor = 0, hebbian: bool = True,
        compute_dtype: torch.dtype | None = None, remat: bool = False, remat_skip: int = 0,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """→ (logits, aux losses, SOM info) (≙ vit_apply; ``hebbian`` is its
        ``train``): aux holds ``reconstruction``, the mse of
        tanh(reconstruction_head(patches)) against the raw pixel patches
        (vit.py:215-217), and the Kohonen terms; see the module docstring."""
        aux: dict[str, torch.Tensor] = {}
        som_info: dict[str, torch.Tensor] = {}
        patches = self._trunk(img, compute_dtype, remat, remat_skip, step=step, hebbian=hebbian,
                              aux=aux, som_info=som_info)
        rec = self.reconstruction_head[0]
        reconstructed = torch.tanh(linear(patches, rec.weight, rec.bias, compute_dtype=compute_dtype))
        target = space_to_depth(img, self.cfg.local_patch_size)
        aux["reconstruction"] = L.mse_loss(reconstructed, target)
        return self._head(patches), aux, som_info


def total_loss(
    cfg: ViTConfig,
    consistency_weight: float,
    smoothness_weight: float,
    logits: torch.Tensor,
    labels: torch.Tensor,
    aux: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """CE + weighted aux losses (≙ vit.py:total_loss), in its order.  Without
    Kohonen the loss is the cross-entropy alone and ``reconstruction`` is
    only reported."""
    class_loss = L.cross_entropy(logits, labels)
    loss = class_loss
    terms = {"class_loss": class_loss}
    if cfg.use_kohonen:
        loss = loss + consistency_weight * aux["kohonen_consistency"]
        loss = loss + smoothness_weight * aux["kohonen_smoothness"]
        loss = loss + cfg.local_quantization_weight * aux["local_quantization"]
        loss = loss + cfg.global_quantization_weight * aux["global_quantization"]
        loss = loss + cfg.reconstruction_weight * aux["reconstruction"]
        terms.update(aux)
    else:
        terms["reconstruction"] = aux["reconstruction"]
    terms["total_loss"] = loss
    return loss, terms


def num_params(model: nn.Module) -> int:
    """Parameter count (≙ vit.py:num_params — the same leaves as init_vit)."""
    return sum(p.numel() for p in model.parameters())


def estimate_flops_per_iter(cfg: ViTConfig, n_params: int, fwdbwd_per_iter: int = 1,
                            model_parallel: int = 1) -> float:
    """FLOPs per image and iteration (≙ vit.py:estimate_flops_per_iter):
    flops/token = 6N + 12·L·H·Q·T, flops/iter = flops/token · T · fwdbwd.
    A tensor-parallel rank's: N its share of the parameters (the caller's),
    H/M heads."""
    L_, H, Q = cfg.n_layer, cfg.n_head // model_parallel, cfg.head_dim
    T = cfg.n_patches
    flops_per_token = 6 * n_params + 12 * L_ * H * Q * T
    return float(flops_per_token * T * fwdbwd_per_iter)
