"""The yardstick's arithmetic: the chip's published peaks, a kernel call's
operations and bytes, and the model's FLOPs per image counted from the
configuration's shapes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (no sparsity), at the full
700 W power limit.  The bound of a call is ``max(ops / peak, bytes / HBM
rate)``; operations and bytes count the work the call's function needs,
each input byte read once and each output byte written once, whatever
kernel computes it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2
FP32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """Least seconds the chip could take for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_fwd(b: int, h: int, t: int, d: int, qknorm: bool) -> tuple[float, float]:
    """(ops, bytes) of one attention forward: q·kᵀ and p·v; q, k, v read,
    the output written (bf16), and for QK-norm the fp32 [H, D] scales."""
    return 4.0 * b * h * t * t * d, 4.0 * b * h * t * d * BF16 + (h * d * FP32 if qknorm else 0)


def attention_bwd(b: int, h: int, t: int, d: int, qknorm: bool) -> tuple[float, float]:
    """(ops, bytes) of one attention backward: 2.5 × the forward's products
    (the recomputed scores, dV, dP, dQ, dK); q, k, v, o, dO read, dq, dk, dv
    written (bf16), the fp32 row statistics read, for QK-norm the scales
    read and their gradient written."""
    extra = h * d * FP32 + b * h * d * FP32 if qknorm else 0
    return 10.0 * b * h * t * t * d, 8.0 * b * h * t * d * BF16 + b * h * t * FP32 + extra


def gated_fwd(n: int, k: int, hidden: int) -> tuple[float, float]:
    """(ops, bytes) of ``u · silu(v)`` over ``[u | v] = x Wᵀ``: x [n, k], W
    [2·hidden, k] read, the [n, hidden] product written (bf16)."""
    return 4.0 * n * k * hidden, (n * k + 2 * hidden * k + n * hidden) * BF16


def gated_bwd(n: int, k: int, hidden: int) -> tuple[float, float]:
    """(ops, bytes) of ``[du | dv]`` from x, W and the output's gradient:
    the product recomputed; x, W, g read, [du | dv] written (bf16)."""
    return 4.0 * n * k * hidden, (n * k + 2 * hidden * k + 3 * n * hidden) * BF16


def attention_calls(model: dict) -> int:
    """Attention calls per forward: the cross-attention and each block."""
    return model["n_layer"] + 1


def mlp_calls(model: dict) -> list[tuple[int, int]]:
    """The gated products per forward as (k, hidden): the cross-attention's
    proj at hidden d, each block's c_fc at hidden 4d."""
    d = model["n_embd"]
    return [(d, d)] + [(d, 4 * d)] * model["n_layer"]


def _tokens(model: dict) -> int:
    return (model["image_size"] // model["local_patch_size"]) ** 2


def attention_bound_s(model: dict, images: int, backward: bool) -> float:
    """Σ bound of one forward's (and its backward's) attention calls over ``images`` rows."""
    h, t = model["n_head"], _tokens(model)
    d = model["n_embd"] // h
    qk = model["use_nvit"]
    one = bound_s(*attention_fwd(images, h, t, d, qk))
    if backward:
        one += bound_s(*attention_bwd(images, h, t, d, qk))
    return attention_calls(model) * one


def mlp_bound_s(model: dict, images: int, backward: bool) -> float:
    n = images * _tokens(model)
    total = 0.0
    for k, hidden in mlp_calls(model):
        total += bound_s(*gated_fwd(n, k, hidden))
        if backward:
            total += bound_s(*gated_bwd(n, k, hidden))
    return total


def forward_products(model: dict) -> dict[str, float]:
    """FLOPs per image of every product of the training forward, by part:
    the two patch embeds, the cross-attention block (projections and both
    attention products), the blocks, the reconstruction head and the
    classifier head."""
    d, t, c = model["n_embd"], _tokens(model), model["channels"]
    lp, gp, L = model["local_patch_size"], model["global_patch_size"], model["n_layer"]
    mm = lambda rows, k, n: 2.0 * rows * k * n  # noqa: E731
    attn = 4.0 * t * t * d
    return {
        "embed_local": mm(t, c * lp * lp, d),
        "embed_global": mm(t, c * gp * gp, d),
        "cross_attention": mm(t, d, d) + mm(t, d, 2 * d) + attn + mm(t, d, 2 * d) + mm(t, d, d),
        "blocks": L * (mm(t, d, 3 * d) + attn + mm(t, d, d) + mm(t, d, 8 * d) + mm(t, 4 * d, d)),
        "reconstruction_head": mm(t, d, lp * lp * c),
        "classifier_head": mm(1, d, model["num_classes"]),
    }


def train_flops_per_image(model: dict) -> float:
    """Model FLOPs of one image's training step: the forward, and twice it
    for the backward (input and weight gradients) on the loss's path, but
    for the patch embeds, whose input needs no gradient (weight gradient
    only), and the reconstruction head, which is off the loss's path (its
    forward only).  Recompute is not counted."""
    f = forward_products(model)
    embeds = f["embed_local"] + f["embed_global"]
    on_path = f["cross_attention"] + f["blocks"] + f["classifier_head"]
    return 3.0 * on_path + 2.0 * embeds + f["reconstruction_head"]


def serve_flops_per_image(model: dict) -> float:
    """Model FLOPs of one image's serving forward (no reconstruction head)."""
    f = forward_products(model)
    return sum(v for k, v in f.items() if k != "reconstruction_head")
