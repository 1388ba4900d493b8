"""Transformer blocks (≙ nvit_tpu/models/blocks.py), in both modes:

* **nViT** — no pre-norm; per-head QK-norm attention scaled by ``sqk``
  (K1/K2), softmax scale sqrt(d_head); the ``suv``-folded gated MLP; SLERP
  residuals with learned per-channel rates;
* **baseline** (``use_nvit=False``) — RMSNorm before attention and MLP, plain
  flash attention (K7/K8/K9) with scale 1/sqrt(d_head), the gated MLP
  unscaled, and additive residuals onto the NORMED input (``h = x + h_att``
  with ``x = rms_norm(h)``, blocks.py:162, :195); the cross-attention
  RMS-normalises both streams and has no residual at all (:227-229).

``Block`` and ``CrossAttentionBlock`` hold their parameters under the
reference ``state_dict`` names (``query.weight`` ``[out, in]``, ``sqk``,
``rmsnorm_att.weight``, …) and apply them with the JAX package's casting and
rounding contract.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.core.layers import concat_linears, linear
from nvit_tpu_torch.core.norms import rms_norm
from nvit_tpu_torch.core.residual import slerp_residual
from nvit_tpu_torch.ops.attention import attention, attention_qknorm
from nvit_tpu_torch.ops.gated_mlp import gated_mlp

# fixed (init_value, init_scaling) constants of the learned scale vectors
# (≙ blocks.py:40-44; the scaling of alpha and sqk is config.base_scale)
ATTN_ALPHA_INIT_VALUE = 0.05
MLP_ALPHA_INIT_VALUE = 0.05
SQK_INIT_VALUE = 1.0
SUV_INIT_VALUE = 1.0
SUV_INIT_SCALING = 1.0

# ``gated_mlp_kernel: auto`` takes the fused kernel iff n_embd ≤ this.  The
# value is the JAX package's v5e crossover (ops/tuning.py); it has not been
# measured on the H100 yet (ROADMAP.md).
GATED_MLP_AUTO_MAX_EMBD = 768


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, C] → [B, H, T, D] as a view (no copy)."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] → [B, T, C]; free when x is a view of [B, T, H, D] storage."""
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)


class SplitFusedHeads(torch.autograd.Function):
    """A fused projection [B, T, n·C] → n head views [B, H, T, D] (≙ split
    into n chunks, then ``split_heads``).  The backward returns the n head
    gradients as the fused gradient WITHOUT a copy when they are the
    adjacent views of one [B, T, n, H, D] buffer — what K2 writes dq, dk, dv
    into — and concatenates them otherwise."""

    @staticmethod
    def forward(ctx, x, n, n_head):
        b, t, c = x.shape
        ctx.dims = (b, t, n, n_head, c // (n * n_head))
        heads = x.view(*ctx.dims)
        return tuple(heads[:, :, i].permute(0, 2, 1, 3) for i in range(n))

    @staticmethod
    def backward(ctx, *grads):
        b, t, n, h, d = ctx.dims
        g0 = grads[0]
        fused_strides = (t * n * h * d, d, n * h * d, 1)
        if all(g is not None and g.dtype == g0.dtype and g.stride() == fused_strides
               and g.untyped_storage().data_ptr() == g0.untyped_storage().data_ptr()
               and g.storage_offset() == g0.storage_offset() + i * h * d
               for i, g in enumerate(grads)):
            return g0.as_strided((b, t, n * h * d), (t * n * h * d, n * h * d, 1)), None, None
        zeros = lambda: torch.zeros((b, h, t, d), dtype=g0.dtype, device=g0.device)  # noqa: E731
        return torch.cat([merge_heads(zeros() if g is None else g) for g in grads], dim=-1), None, None


def use_mlp_kernel(cfg: ViTConfig) -> bool:
    """Resolve ``gated_mlp_kernel`` (≙ blocks.py:_use_mlp_kernel): flash_attn
    gates every kernel path; "auto" keys on the width."""
    if not cfg.flash_attn:
        return False
    if cfg.gated_mlp_kernel == "auto":
        return cfg.n_embd <= GATED_MLP_AUTO_MAX_EMBD
    return cfg.gated_mlp_kernel == "on"


def sqk_eff(sqk: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Effective per-head sqk [H, D] fp32: ``sqk · init_value/base_scale``."""
    return (sqk.float() * (SQK_INIT_VALUE / cfg.base_scale)).reshape(cfg.n_head, cfg.head_dim)


def gated_linear(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, *,
    compute_dtype: torch.dtype | None, use_kernel: bool,
) -> torch.Tensor:
    """``u * silu(v)`` over ``x Wᵀ (+ b)`` with linear's casting contract
    (≙ blocks.py:_gated_linear); w is [2H, K]."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
        b = b.to(compute_dtype) if b is not None else None
    if b is not None:
        if use_kernel:
            raise NotImplementedError(
                "the gated-MLP bias kernel (K6) is not ported yet (ROADMAP.md); "
                "use bias=False or gated_mlp_kernel='off'"
            )
        u, v = torch.chunk(torch.nn.functional.linear(x, w, b), 2, dim=-1)
        return u * torch.nn.functional.silu(v)
    return gated_mlp(x, w, use_kernel=use_kernel)


def _scale_vector(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d, dtype=torch.float32, device=device))


class RMSNorm(nn.Module):
    """The baseline's RMS norm with an fp32 per-channel ``weight``
    (≙ core/norms.py:rms_norm, whose rounding it keeps)."""

    def __init__(self, d: int, *, device):
        super().__init__()
        self.weight = _scale_vector(d, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight)


class Block(nn.Module):
    """Self-attention block (≙ blocks.py:init_block, block_apply)."""

    def __init__(self, cfg: ViTConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        kw = dict(bias=cfg.bias, device=device)
        self.query = nn.Linear(d, d, **kw)
        self.key = nn.Linear(d, d, **kw)
        self.value = nn.Linear(d, d, **kw)
        self.att_c_proj = nn.Linear(d, d, **kw)
        self.c_fc = nn.Linear(d, 2 * 4 * d, **kw)
        self.mlp_c_proj = nn.Linear(4 * d, d, **kw)
        self.skip_param = nn.Parameter(torch.empty(1, device=device))
        if cfg.use_nvit:
            self.attn_alpha = _scale_vector(d, device)
            self.mlp_alpha = _scale_vector(d, device)
            self.sqk = _scale_vector(d, device)
            self.suv = _scale_vector(2 * 4 * d, device)
        else:
            self.rmsnorm_att = RMSNorm(d, device=device)
            self.rmsnorm_mlp = RMSNorm(d, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        cfg = self.cfg
        c_proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)
        for lin, std in ((self.query, 0.02), (self.key, 0.02), (self.value, 0.02),
                         (self.att_c_proj, c_proj_std), (self.c_fc, 0.02),
                         (self.mlp_c_proj, c_proj_std)):
            init_linear(lin, g, std)
        self.skip_param.fill_(1.0)
        if not cfg.use_nvit:
            self.rmsnorm_att.weight.fill_(1.0)
            self.rmsnorm_mlp.weight.fill_(1.0)
            return
        for p in (self.attn_alpha, self.mlp_alpha, self.sqk):
            p.fill_(cfg.base_scale)
        self.suv.fill_(SUV_INIT_SCALING)

    def forward(self, h: torch.Tensor, *, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Block output WITHOUT the outer norm_skip (the ViT loop applies it)."""
        cfg, dt = self.cfg, compute_dtype
        nvit = cfg.use_nvit
        x = h if nvit else self.rmsnorm_att(h)
        # fused QKV: one matmul reads x once (≙ blocks.py:140-142)
        w_qkv, b_qkv = concat_linears([(m.weight, m.bias) for m in (self.query, self.key, self.value)])
        qkv = linear(x, w_qkv, b_qkv, compute_dtype=dt)
        q, k, v = SplitFusedHeads.apply(qkv, 3, cfg.n_head)
        if nvit:
            att = attention_qknorm(
                q, k, v, sqk_eff(self.sqk, cfg), math.sqrt(cfg.head_dim),
                use_flash=cfg.flash_attn, bounded_softmax=cfg.bounded_softmax,
            )
        else:
            att = attention(q, k, v, 1.0 / math.sqrt(cfg.head_dim), use_flash=cfg.flash_attn)
        h_att = linear(merge_heads(att), self.att_c_proj.weight, self.att_c_proj.bias, compute_dtype=dt)
        if nvit:
            h = slerp_residual(h, h_att, self.attn_alpha, ATTN_ALPHA_INIT_VALUE, cfg.base_scale)
        else:
            h = x + h_att

        x = h if nvit else self.rmsnorm_mlp(h)
        w_fc, b_fc = self.c_fc.weight, self.c_fc.bias
        if nvit:
            # weight-side suv fold: suv·(x Wᵀ) ≡ x (suv ⊙ W)ᵀ, so scale the ROWS
            # of the [2H, K] weight in fp32 before the cast (≙ blocks.py:174-186)
            suv = self.suv * ((SUV_INIT_VALUE / SUV_INIT_SCALING) * math.sqrt(cfg.n_embd))
            w_fc = w_fc * suv[:, None]
            b_fc = b_fc * suv if b_fc is not None else None
        x_mlp = gated_linear(x, w_fc, b_fc, compute_dtype=dt, use_kernel=use_mlp_kernel(cfg))
        h_mlp = linear(x_mlp, self.mlp_c_proj.weight, self.mlp_c_proj.bias, compute_dtype=dt)
        if nvit:
            return slerp_residual(h, h_mlp, self.mlp_alpha, MLP_ALPHA_INIT_VALUE, cfg.base_scale)
        return x + h_mlp


class CrossAttentionBlock(nn.Module):
    """Q from the local stream, K/V from the global stream, gated output
    projection (≙ blocks.py:cross_attention_apply); nViT SLERPs toward
    ``local``, baseline RMS-normalises both streams first and adds no
    residual."""

    def __init__(self, cfg: ViTConfig, *, device: torch.device | str):
        super().__init__()
        self.cfg = cfg
        d = cfg.n_embd
        kw = dict(bias=cfg.bias, device=device)
        self.q_local = nn.Linear(d, d, **kw)
        self.k_global = nn.Linear(d, d, **kw)
        self.v_global = nn.Linear(d, d, **kw)
        self.proj = nn.Linear(d, 2 * d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        if cfg.use_nvit:
            self.attn_alpha = _scale_vector(d, device)
            self.sqk = _scale_vector(d, device)
        else:
            self.local_norm = RMSNorm(d, device=device)
            self.global_norm = RMSNorm(d, device=device)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        for lin in (self.q_local, self.k_global, self.v_global, self.proj, self.out_proj):
            init_linear(lin, g, 0.02)
        if self.cfg.use_nvit:
            self.attn_alpha.fill_(self.cfg.base_scale)
            self.sqk.fill_(self.cfg.base_scale)
        else:
            self.local_norm.weight.fill_(1.0)
            self.global_norm.weight.fill_(1.0)

    def forward(
        self, local: torch.Tensor, global_: torch.Tensor, *, compute_dtype: torch.dtype | None = None
    ) -> torch.Tensor:
        cfg, dt = self.cfg, compute_dtype
        nvit = cfg.use_nvit
        local_in = local
        if not nvit:
            local, global_ = self.local_norm(local), self.global_norm(global_)
        q = split_heads(linear(local, self.q_local.weight, self.q_local.bias, compute_dtype=dt), cfg.n_head)
        # fused KV: both read the global stream (≙ blocks.py:234-236)
        w_kv, b_kv = concat_linears([(m.weight, m.bias) for m in (self.k_global, self.v_global)])
        kv = linear(global_, w_kv, b_kv, compute_dtype=dt)
        k, v = (split_heads(t, cfg.n_head) for t in torch.chunk(kv, 2, dim=-1))
        if nvit:
            att = attention_qknorm(
                q, k, v, sqk_eff(self.sqk, cfg), math.sqrt(cfg.head_dim),
                use_flash=cfg.flash_attn, bounded_softmax=cfg.bounded_softmax,
            )
        else:
            att = attention(q, k, v, 1.0 / math.sqrt(cfg.head_dim), use_flash=cfg.flash_attn)
        out = gated_linear(merge_heads(att), self.proj.weight, self.proj.bias,
                           compute_dtype=dt, use_kernel=use_mlp_kernel(cfg))
        out = linear(out, self.out_proj.weight, self.out_proj.bias, compute_dtype=dt)
        if nvit:
            return slerp_residual(local_in, out, self.attn_alpha, ATTN_ALPHA_INIT_VALUE, cfg.base_scale)
        return out


def init_linear(lin: nn.Linear, g: torch.Generator, std: float) -> None:
    """normal(0, std) weight and zero bias (≙ core/layers.py:init_linear)."""
    lin.weight.normal_(0.0, std, generator=g)
    if lin.bias is not None:
        lin.bias.zero_()
