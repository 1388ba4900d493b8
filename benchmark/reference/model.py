"""The plain reference: nViT and the baseline ViT written out in float32
PyTorch from the model's equations, with the training step's loss, backward,
clip, AdamW and renorm.

It imports nothing of the program under test.  It reads a configuration's
``model`` and ``optimizer`` sections as plain dicts and a ``state_dict``
(name → tensor) laid out as the reference checkpoints are: ``Conv2d``
patch embeds ``[d, C, k, k]``, linears ``[out, in]``.

The equations (nViT: arXiv:2410.01131's normalized transformer on the dual
8/16 patch streams; the baseline: pre-RMSNorm blocks):

* pixels ``x = u8 · 2/255 − 1``; local tokens ``conv(x, W_l, stride 8)``,
  global tokens ``conv(reflect_pad(x, 4), W_g, kernel 16, stride 8)``, each
  flattened row-major to ``[B, T, d]`` plus its position embedding;
* the cross-attention: queries from the local stream, keys and values from
  the global stream, the gated projection ``u · silu(v)`` and the output
  projection.  nViT: ``q̂ = sqk_eff ⊙ q/‖q‖`` per head (and ``k̂``), softmax
  scale ``sqrt(D)``, then ``slerp(local, out)``; the baseline RMS-normalises
  both streams first, scale ``1/sqrt(D)``, no residual;
* each block, nViT: ``h ← slerp(h, attn(h))``, ``h ← slerp(h, mlp(h))`` with
  ``slerp(h, u) = N(N(h) + |α·c|·(N(u) − N(h)))``, ``c = 0.05/base_scale``,
  the MLP's ``[u | v]`` scaled by ``suv · sqrt(d)``; the baseline:
  ``x = rms(h)``, ``h = x + attn(x)``, ``x = rms(h)``, ``h = x + mlp(x)``;
  both then ``h ← N(block(h) · skip + h)``;
* the head: mean over tokens, LayerNorm, linear; nViT multiplies by
  ``sz · sz_init_value/sz_init_scaling``; the loss is the cross-entropy; the
  reconstruction ``mse(tanh(h W_rᵀ + b_r), patches(x))`` is reported;
* the update: global-norm clip, AdamW (bias-corrected, eps 1e-8, decay on
  tensors of two or more dims) at the cosine schedule's rate for the
  0-based count, then, in nViT, each block matrix renormalised along its
  embedding axis.

``quant`` (default none) is applied to every operand of every product, the
forward's and the backward's: to each product's inputs, which its backward
uses as saved, and to the gradient that enters its backward.  The
lower-precision control passes the fp8 quantiser of ``fp8_quant``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

# constants of the nViT equations (learned-scale initial values and their scalings)
ALPHA_INIT_VALUE = 0.05
SQK_INIT_VALUE = 1.0
SUV_INIT_VALUE = 1.0
SUV_INIT_SCALING = 1.0
ADAM_EPS = 1e-8
RMS_EPS = 1e-6
LN_EPS = 1e-5

Quant = Callable[[torch.Tensor], torch.Tensor] | None

# block matrices renormalised after each nViT update → the axis normalised
# in the [out, in] layout: the input axis of q/k/v/c_fc, the output axis of
# the two output projections
RENORM = {"query": 1, "key": 1, "value": 1, "c_fc": 1, "att_c_proj": 0, "mlp_c_proj": 0}


def tokens(m: dict) -> int:
    return (m["image_size"] // m["local_patch_size"]) ** 2


def layout(m: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """Every parameter as (name, shape, init, value): init "normal" (std
    ``value``), "uniform" (±``value``) or "const" (filled with ``value``) —
    the initial distributions of training from scratch."""
    d, c, n = m["n_embd"], m["channels"], m["num_classes"]
    lp, gp, L = m["local_patch_size"], m["global_patch_size"], m["n_layer"]
    nvit, bias, t = m["use_nvit"], m["bias"], tokens(m)
    out: list[tuple[str, tuple[int, ...], str, float]] = []

    def lin(name, o, i, std):
        out.append((f"{name}.weight", (o, i), "normal", std))
        if bias:
            out.append((f"{name}.bias", (o,), "const", 0.0))

    for name, k in (("local_patch_embed", lp), ("global_patch_embed.1", gp)):
        bound = 1.0 / math.sqrt(c * k * k)
        out.append((f"{name}.weight", (d, c, k, k), "uniform", bound))
        out.append((f"{name}.bias", (d,), "uniform", bound))
    out.append(("local_pos_embed", (1, t, d), "const", 0.0))
    out.append(("global_pos_embed", (1, t, d), "const", 0.0))
    if nvit:
        out.append(("sz", (n,), "const", m["sz_init_value"]))
    for name, o in (("q_local", d), ("k_global", d), ("v_global", d), ("proj", 2 * d), ("out_proj", d)):
        lin(f"cross_attention.{name}", o, d, 0.02)
    if nvit:
        out.append(("cross_attention.attn_alpha", (d,), "const", m["base_scale"]))
        out.append(("cross_attention.sqk", (d,), "const", m["base_scale"]))
    else:
        out.append(("cross_attention.local_norm.weight", (d,), "const", 1.0))
        out.append(("cross_attention.global_norm.weight", (d,), "const", 1.0))
    out.append(("reconstruction_head.0.weight", (lp * lp * c, d), "normal", 0.02))
    out.append(("reconstruction_head.0.bias", (lp * lp * c,), "const", 0.0))
    proj_std = 0.02 / math.sqrt(2 * L)
    for i in range(L):
        p = f"transformer.h.{i}"
        for name, o, inp, std in (("query", d, d, 0.02), ("key", d, d, 0.02), ("value", d, d, 0.02),
                                  ("att_c_proj", d, d, proj_std), ("c_fc", 8 * d, d, 0.02),
                                  ("mlp_c_proj", d, 4 * d, proj_std)):
            lin(f"{p}.{name}", o, inp, std)
        out.append((f"{p}.skip_param", (1,), "const", 1.0))
        if nvit:
            for name in ("attn_alpha", "mlp_alpha", "sqk"):
                out.append((f"{p}.{name}", (d,), "const", m["base_scale"]))
            out.append((f"{p}.suv", (8 * d,), "const", SUV_INIT_SCALING))
        else:
            out.append((f"{p}.rmsnorm_att.weight", (d,), "const", 1.0))
            out.append((f"{p}.rmsnorm_mlp.weight", (d,), "const", 1.0))
    out.append(("mlp_head.0.weight", (d,), "const", 1.0))
    out.append(("mlp_head.0.bias", (d,), "const", 0.0))
    out.append(("mlp_head.1.weight", (n, d), "normal", 0.02))
    out.append(("mlp_head.1.bias", (n,), "const", 0.0))
    return out


# ---------------------------------------------------------------- the forward
def _q(x: torch.Tensor, quant: Quant) -> torch.Tensor:
    """A product's input, quantised; the gradient passes straight through."""
    return x if quant is None else x + (quant(x) - x).detach()


class _GradQuant(torch.autograd.Function):
    """The identity; its backward hands on the quantised incoming gradient."""

    @staticmethod
    def forward(ctx, y, quant):
        ctx.quant = quant
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.quant(g), None


def _out(y: torch.Tensor, quant: Quant) -> torch.Tensor:
    """A product's output: the gradient that enters the product's backward
    is quantised."""
    return y if quant is None else _GradQuant.apply(y, quant)


def _linear(x, w, b, quant: Quant):
    y = _out(_q(x, quant) @ _q(w, quant).t(), quant)
    return y if b is None else y + b


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + RMS_EPS) * w


def _slerp(h, u, alpha, base_scale):
    rate = torch.abs(alpha * (ALPHA_INIT_VALUE / base_scale))
    a, b = _unit(h), _unit(u)
    return _unit(a + rate * (b - a))


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def _attention(m: dict, q, k, v, sqk, quant: Quant) -> torch.Tensor:
    """[B, T, d] q, k, v → [B, T, d]: per-head softmax attention; nViT
    normalises q and k per head and scales them by ``sqk_eff``."""
    nh = m["n_head"]
    dh = m["n_embd"] // nh
    q, k, v = (_heads(t, nh) for t in (q, k, v))
    if m["use_nvit"]:
        s = (sqk * (SQK_INIT_VALUE / m["base_scale"])).reshape(1, nh, 1, dh)
        q, k = s * _unit(q), s * _unit(k)
        scale = math.sqrt(dh)
    else:
        scale = 1.0 / math.sqrt(dh)
    p = torch.softmax(_out(_q(q, quant) @ _q(k, quant).transpose(-1, -2), quant) * scale, dim=-1)
    o = _out(_q(p, quant) @ _q(v, quant), quant)
    return o.transpose(1, 2).reshape(q.shape[0], -1, m["n_embd"])


def _gated(x, w, b, quant: Quant, scale: torch.Tensor | None = None):
    uv = _linear(x, w, b, quant)
    if scale is not None:
        uv = uv * scale
    u, v = uv.chunk(2, dim=-1)
    return u * F.silu(v)


def _p(sd: dict, name: str):
    return sd.get(name)


def embed(m: dict, sd: dict, x: torch.Tensor, quant: Quant = None):
    lp, gp = m["local_patch_size"], m["global_patch_size"]
    pad = (gp - lp) // 2
    loc = _out(F.conv2d(_q(x, quant), _q(sd["local_patch_embed.weight"], quant), sd["local_patch_embed.bias"],
                        stride=lp), quant)
    xg = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    glo = _out(F.conv2d(_q(xg, quant), _q(sd["global_patch_embed.1.weight"], quant), sd["global_patch_embed.1.bias"],
                        stride=lp), quant)
    loc = loc.flatten(2).transpose(1, 2) + sd["local_pos_embed"]
    glo = glo.flatten(2).transpose(1, 2) + sd["global_pos_embed"]
    return loc, glo


def cross_attention(m: dict, sd: dict, loc, glo, quant: Quant = None):
    p = "cross_attention."
    nvit = m["use_nvit"]
    loc_in = loc
    if not nvit:
        loc, glo = _rms(loc, sd[p + "local_norm.weight"]), _rms(glo, sd[p + "global_norm.weight"])
    q = _linear(loc, sd[p + "q_local.weight"], _p(sd, p + "q_local.bias"), quant)
    k = _linear(glo, sd[p + "k_global.weight"], _p(sd, p + "k_global.bias"), quant)
    v = _linear(glo, sd[p + "v_global.weight"], _p(sd, p + "v_global.bias"), quant)
    att = _attention(m, q, k, v, sd.get(p + "sqk"), quant)
    out = _gated(att, sd[p + "proj.weight"], _p(sd, p + "proj.bias"), quant)
    out = _linear(out, sd[p + "out_proj.weight"], _p(sd, p + "out_proj.bias"), quant)
    if nvit:
        return _slerp(loc_in, out, sd[p + "attn_alpha"], m["base_scale"])
    return out


def block(m: dict, sd: dict, i: int, h, quant: Quant = None):
    """Block ``i`` without the outer skip."""
    p = f"transformer.h.{i}."
    nvit = m["use_nvit"]
    x = h if nvit else _rms(h, sd[p + "rmsnorm_att.weight"])
    q, k, v = (_linear(x, sd[p + n + ".weight"], _p(sd, p + n + ".bias"), quant) for n in ("query", "key", "value"))
    att = _linear(_attention(m, q, k, v, sd.get(p + "sqk"), quant), sd[p + "att_c_proj.weight"],
                  _p(sd, p + "att_c_proj.bias"), quant)
    h = _slerp(h, att, sd[p + "attn_alpha"], m["base_scale"]) if nvit else x + att
    x = h if nvit else _rms(h, sd[p + "rmsnorm_mlp.weight"])
    scale = sd[p + "suv"] * (SUV_INIT_VALUE / SUV_INIT_SCALING * math.sqrt(m["n_embd"])) if nvit else None
    mlp = _gated(x, sd[p + "c_fc.weight"], _p(sd, p + "c_fc.bias"), quant, scale)
    mlp = _linear(mlp, sd[p + "mlp_c_proj.weight"], _p(sd, p + "mlp_c_proj.bias"), quant)
    return _slerp(h, mlp, sd[p + "mlp_alpha"], m["base_scale"]) if nvit else x + mlp


def trunk(m: dict, sd: dict, x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    loc, glo = embed(m, sd, x, quant)
    h = cross_attention(m, sd, loc, glo, quant)
    for i in range(m["n_layer"]):
        out = block(m, sd, i, h, quant)
        h = _unit(out * sd[f"transformer.h.{i}.skip_param"] + h)
    return h


def head(m: dict, sd: dict, h: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    pooled = F.layer_norm(h.mean(dim=1), (m["n_embd"],), sd["mlp_head.0.weight"], sd["mlp_head.0.bias"], LN_EPS)
    logits = _linear(pooled, sd["mlp_head.1.weight"], sd["mlp_head.1.bias"], quant)
    if m["use_nvit"]:
        logits = logits * (sd["sz"] * (m["sz_init_value"] / m["sz_init_scaling"]))
    return logits


def pixels(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.float() * (2.0 / 255.0) - 1.0


def logits(m: dict, sd: dict, images_u8: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """uint8 [B, C, H, W] → fp32 logits [B, classes]."""
    return head(m, sd, trunk(m, sd, pixels(images_u8), quant), quant)


def losses(m: dict, sd: dict, images_u8, labels, quant: Quant = None) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (cross-entropy, reconstruction mse), each a mean over its rows."""
    x = pixels(images_u8)
    h = trunk(m, sd, x, quant)
    lp = m["local_patch_size"]
    rec = torch.tanh(_linear(h, sd["reconstruction_head.0.weight"], sd["reconstruction_head.0.bias"], quant))
    target = F.unfold(x, lp, stride=lp).transpose(1, 2)
    return F.cross_entropy(head(m, sd, h, quant), labels.long()), F.mse_loss(rec, target)


# ------------------------------------------------------------- the training step
def cosine_lr(o: dict, count: int) -> float:
    base, mn = o["learning_rate"], o["min_lr"]
    if not o["decay_lr"]:
        return base
    warm, decay = o["warmup_iters"], o["lr_decay_iters"]
    if count < warm:
        return base * count / max(warm, 1)
    if count > decay:
        return mn
    ratio = min(max((count - warm) / max(decay - warm, 1), 0.0), 1.0)
    return mn + 0.5 * (1.0 + math.cos(math.pi * ratio)) * (base - mn)


def renorm_dim(name: str) -> int | None:
    parts = name.split(".")
    if len(parts) == 5 and parts[:2] == ["transformer", "h"] and parts[4] == "weight":
        return RENORM.get(parts[3])
    return None


def grads(m: dict, sd: dict, images_u8, labels, rows: int, quant: Quant = None):
    """(mean loss, mean reconstruction, gradients of the mean loss), the
    batch taken ``rows`` at a time so that the activations fit."""
    b = images_u8.shape[0]
    names = list(sd)
    leaves = [sd[n].detach().requires_grad_() for n in names]
    live = dict(zip(names, leaves))
    total = [torch.zeros_like(t) for t in leaves]
    loss = rec = 0.0
    for r in range(0, b, rows):
        ce, mse = losses(m, live, images_u8[r:r + rows], labels[r:r + rows], quant)
        share = images_u8[r:r + rows].shape[0] / b
        gs = torch.autograd.grad(ce * share, leaves, allow_unused=True)
        for acc, g in zip(total, gs):
            if g is not None:
                acc.add_(g)
        loss += ce.item() * share
        rec += mse.item() * share
    return loss, rec, dict(zip(names, total))


@torch.no_grad()
def update(m: dict, o: dict, sd: dict, g: dict, mu: dict, nu: dict, count: int) -> dict:
    """Clip + AdamW (+ renorm) in place → the clipped gradients."""
    gnorm = torch.sqrt(sum(t.pow(2).sum() for t in g.values()))
    clip = o["grad_clip"]
    scale = 1.0 if not clip or gnorm.item() < clip else clip / gnorm.item()
    lr = cosine_lr(o, count)
    b1, b2 = o["beta1"], o["beta2"]
    bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
    clipped = {}
    for n, p in sd.items():
        gi = g[n] * scale
        clipped[n] = gi
        mu[n].mul_(b1).add_(gi, alpha=1.0 - b1)
        nu[n].mul_(b2).add_(gi * gi, alpha=1.0 - b2)
        upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + ADAM_EPS)
        if p.dim() >= 2:
            upd = upd + o["weight_decay"] * p
        p.sub_(lr * upd)
        dim = renorm_dim(n) if m["use_nvit"] else None
        if dim is not None:
            p.div_(p.norm(dim=dim, keepdim=True))
    return clipped


def train_steps(m: dict, o: dict, sd0: dict, batches, rows: int, quant: Quant = None) -> dict:
    """The first ``len(batches)`` steps from ``sd0`` (not modified) →
    {"loss": [...], "reconstruction": [...], "grad_norm": {leaf: ‖g₁‖ after
    the clip}, "delta_norm": {leaf: ‖p_n − p_0‖}}."""
    sd = {n: t.detach().clone().float() for n, t in sd0.items()}
    mu = {n: torch.zeros_like(t) for n, t in sd.items()}
    nu = {n: torch.zeros_like(t) for n, t in sd.items()}
    out: dict = {"loss": [], "reconstruction": []}
    for count, (images, labels) in enumerate(batches):
        loss, rec, g = grads(m, sd, images, labels, rows, quant)
        out["loss"].append(loss)
        out["reconstruction"].append(rec)
        clipped = update(m, o, sd, g, mu, nu, count)
        if count == 0:
            out["grad_norm"] = {n: t.norm().item() for n, t in clipped.items()}
        del g, clipped
    out["delta_norm"] = {n: (sd[n] - sd0[n].float()).norm().item() for n in sd}
    return out


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 round trip (the amax mapped to 448)."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s
