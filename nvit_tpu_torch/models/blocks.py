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

A ``Block`` may hold one rank's shard (``Block.shard_``, the layout of
``parallel/mesh.py``): n_head/M heads of q/k/v and the rank's u and v rows
of c_fc, on which K1/K2 (K5, K7/K8) and K3/K4 (K6) run unchanged.  Its
forward is the same pieces either way — ``attn_partial`` / ``mlp_partial``
up to the output projection, ``attn_output`` / ``mlp_output`` after it —
with the Megatron pair around each partial under TP (``parallel/tensor.py``:
f before, g after; the output projections' biases added once, after the
sum), and each FSDP piece gathered at its use.  ``sqk`` and ``suv`` stay
whole on every rank and are read at the rank's heads and rows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.core.layers import concat_linears, linear
from nvit_tpu_torch.core.norms import rms_norm
from nvit_tpu_torch.core.residual import slerp_residual
from nvit_tpu_torch.ops.attention import attention, attention_qknorm
from nvit_tpu_torch.ops.flash_attention import bounded_arm
from nvit_tpu_torch.ops.gated_mlp import gated_mlp
from nvit_tpu_torch.ops.quant import QuantParams
from nvit_tpu_torch.parallel.mesh import Axis, block_param_specs, pairs_of, split
from nvit_tpu_torch.parallel.tensor import enter_model, gather_data, reduce_model

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
    (≙ blocks.py:_gated_linear); w is [2H, K].  With a bias the kernel path
    is K6, the plain path rounds ``x Wᵀ`` before adding it.  An int8 ``w``
    runs the int8 linear and gates in the compute dtype, without K3/K6."""
    if isinstance(w, QuantParams):
        u, v = torch.chunk(linear(x, w, b, compute_dtype=compute_dtype), 2, dim=-1)
        return u * F.silu(v)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
        b = b.to(compute_dtype) if b is not None else None
    return gated_mlp(x, w, b, use_kernel=use_kernel)


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
        self.tp: Axis | None = None  # the model axis, when the block is a TP shard
        self.fsdp: Axis | None = None  # the data axis, when its shards are FSDP pieces

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

    # ------------------------------------------------ tensor parallelism, FSDP
    @torch.no_grad()
    def shard_(self, model: Axis, data: Axis | None = None) -> "Block":
        """Keep this rank's pieces of the block (``parallel/mesh.py``'s
        layout): model shard ``model.rank`` of ``model.world`` — its
        n_head/M heads of q/k/v, its u and v rows of c_fc, its input columns
        of the output projections — and, with ``data`` (FSDP), data piece
        ``data.rank`` of that; the replicated vectors stay whole.  The
        forward then reduces over ``model`` and gathers over ``data``."""
        for name, dim in block_param_specs(self.cfg.use_nvit, self.cfg.bias).items():
            if dim is None:
                continue
            module, _, attr = name.rpartition(".")
            lin = getattr(self, module)
            piece = split(getattr(lin, attr), dim, model.rank, model.world, pairs_of(name))
            if data is not None:
                piece = split(piece, dim, data.rank, data.world)
            # a copy: a contiguous slice would be a view that keeps the whole alive
            setattr(lin, attr, nn.Parameter(piece.clone(memory_format=torch.contiguous_format)))
        self.tp = model if model.world > 1 else None
        self.fsdp = data
        return self

    def _weight(self, lin: nn.Linear, dim: int):
        """``lin``'s weight for the product: under FSDP its model shard,
        gathered over the data axis."""
        w = lin.weight
        return w if self.fsdp is None or isinstance(w, QuantParams) else gather_data(w, dim, self.fsdp)

    def _col_bias(self, lin: nn.Linear) -> torch.Tensor | None:
        b = lin.bias
        return b if b is None or self.fsdp is None else gather_data(b, 0, self.fsdp)

    def _row_product(self, x: torch.Tensor, lin: nn.Linear, dt) -> torch.Tensor:
        """x Wᵀ of an output projection: under TP the rank's partial sum,
        without the bias (``_row_bias`` adds it once, after the sum)."""
        return linear(x, self._weight(lin, 1), lin.bias if self.tp is None else None, compute_dtype=dt)

    def _row_bias(self, y: torch.Tensor, lin: nn.Linear, dt) -> torch.Tensor:
        if self.tp is None or lin.bias is None:
            return y
        return y + (lin.bias.to(y.dtype) if dt is not None else lin.bias)

    def _heads(self) -> int:
        return self.cfg.n_head // (1 if self.tp is None else self.tp.world)

    def _sqk(self) -> tuple[torch.Tensor, str]:
        """(the rank's heads' sqk_eff, the softmax mode): under TP "auto"
        takes the arm the WHOLE model's sqk picks (≙ the one-device gate),
        read here on the host, so every shard takes the same one."""
        cfg = self.cfg
        s, mode = sqk_eff(self.sqk, cfg), cfg.bounded_softmax
        if self.tp is None:
            return s, mode
        if mode == "auto":
            mode = "bounded" if bounded_arm(s.detach(), math.sqrt(cfg.head_dim), "auto") else "rowmax"
        return split(s, 0, self.tp.rank, self.tp.world), mode

    def _suv(self) -> torch.Tensor:
        return self.suv if self.tp is None else split(self.suv, 0, self.tp.rank, self.tp.world, pairs=2)

    # ------------------------------------------------------------- the pieces
    def attn_input(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.cfg.use_nvit else self.rmsnorm_att(h)

    def attn_partial(self, x: torch.Tensor, dt) -> torch.Tensor:
        """The attention branch up to its output projection; under TP on
        the rank's heads, a partial sum without the bias."""
        cfg = self.cfg
        # fused QKV: one matmul reads x once (≙ blocks.py:140-142)
        w_qkv, b_qkv = concat_linears([(self._weight(m, 0), self._col_bias(m))
                                       for m in (self.query, self.key, self.value)])
        qkv = linear(x, w_qkv, b_qkv, compute_dtype=dt)
        q, k, v = SplitFusedHeads.apply(qkv, 3, self._heads())
        if cfg.use_nvit:
            s, mode = self._sqk()
            att = attention_qknorm(q, k, v, s, math.sqrt(cfg.head_dim), use_flash=cfg.flash_attn,
                                   bounded_softmax=mode)
        else:
            att = attention(q, k, v, 1.0 / math.sqrt(cfg.head_dim), use_flash=cfg.flash_attn)
        return self._row_product(merge_heads(att), self.att_c_proj, dt)

    def attn_output(self, h: torch.Tensor, x: torch.Tensor, y: torch.Tensor, dt) -> torch.Tensor:
        h_att = self._row_bias(y, self.att_c_proj, dt)
        if self.cfg.use_nvit:
            return slerp_residual(h, h_att, self.attn_alpha, ATTN_ALPHA_INIT_VALUE, self.cfg.base_scale)
        return x + h_att

    def mlp_input(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.cfg.use_nvit else self.rmsnorm_mlp(h)

    def mlp_partial(self, x: torch.Tensor, dt) -> torch.Tensor:
        """The gated MLP up to its output projection; under TP on the
        rank's u|v columns, a partial sum without the bias."""
        cfg = self.cfg
        w_fc, b_fc = self._weight(self.c_fc, 0), self._col_bias(self.c_fc)
        if cfg.use_nvit:
            # weight-side suv fold: suv·(x Wᵀ) ≡ x (suv ⊙ W)ᵀ, so scale the ROWS
            # of the [2H, K] weight in fp32 before the cast (≙ blocks.py:174-186);
            # an int8 weight takes it into its per-output scale, exactly
            suv = self._suv() * ((SUV_INIT_VALUE / SUV_INIT_SCALING) * math.sqrt(cfg.n_embd))
            if isinstance(w_fc, QuantParams):
                w_fc = QuantParams(w_fc.wq, w_fc.scale * suv)
            else:
                w_fc = w_fc * suv[:, None]
            b_fc = b_fc * suv if b_fc is not None else None
        x_mlp = gated_linear(x, w_fc, b_fc, compute_dtype=dt, use_kernel=use_mlp_kernel(cfg))
        return self._row_product(x_mlp, self.mlp_c_proj, dt)

    def mlp_output(self, h: torch.Tensor, x: torch.Tensor, y: torch.Tensor, dt) -> torch.Tensor:
        h_mlp = self._row_bias(y, self.mlp_c_proj, dt)
        if self.cfg.use_nvit:
            return slerp_residual(h, h_mlp, self.mlp_alpha, MLP_ALPHA_INIT_VALUE, self.cfg.base_scale)
        return x + h_mlp

    def _enter(self, x: torch.Tensor, dt) -> torch.Tensor:
        """f in front of a column-parallel region, on the compute-dtype input."""
        if self.tp is None:
            return x
        return enter_model(x.to(dt) if dt is not None else x, self.tp)

    def _reduce(self, y: torch.Tensor) -> torch.Tensor:
        """g after a row-parallel product: the partial sums summed over the model axis."""
        return y if self.tp is None else reduce_model(y, self.tp)

    def forward(self, h: torch.Tensor, *, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        """Block output WITHOUT the outer norm_skip (the ViT loop applies it)."""
        dt = compute_dtype
        x = self.attn_input(h)
        h = self.attn_output(h, x, self._reduce(self.attn_partial(self._enter(x, dt), dt)), dt)
        x = self.mlp_input(h)
        return self.mlp_output(h, x, self._reduce(self.mlp_partial(self._enter(x, dt), dt)), dt)


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
