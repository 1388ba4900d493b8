"""AutoAugment on the device (≙ nvit_tpu/data/autoaugment.py): the
published CIFAR-10 and ImageNet policies (Cubuk et al., 2019), 25
sub-policies of two (op, probability, magnitude bin) stages each, applied
to a uint8 [B, C, H, W] batch.

The random draw and the application are apart:

* ``draw`` takes, per image, one sub-policy, two coins and two signs from a
  host ``torch.Generator`` (``step_generator`` seeds it from the run key and
  the step, so a resumed run augments as a straight one does);
* ``plan`` turns them into each stage's op (identity where the coin
  fails) and signed magnitude, on the host;
* ``apply_plan`` runs the ops on the device, each on the images that drew
  it (host-known index sets, uploaded once per batch: no device→host
  sync), in fp32 on [0, 255], then rounds, clips and casts to uint8.

The ops keep the JAX package's arithmetic: nearest-neighbour sampling
rounds half away from zero and fills with 0 outside the image, with the
centre-origin coordinates of ``_affine_warp`` in its order; rotation's cos
and sin in fp32; contrast blends with the mean of the rounded grayscale;
sharpness blends with PIL's SMOOTH kernel, border pixels kept; equalize is
PIL's integer LUT (``step = (npix − last_count) // 255``).  Sums run in
another order than XLA's, so a pixel can land one apart after rounding
(tests/test_torch_autoaugment.py states the share).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# --- op ids ----------------------------------------------------------------
(
    OP_IDENTITY,
    OP_SHEAR_X,
    OP_SHEAR_Y,
    OP_TRANSLATE_X,
    OP_TRANSLATE_Y,
    OP_ROTATE,
    OP_BRIGHTNESS,
    OP_COLOR,
    OP_CONTRAST,
    OP_SHARPNESS,
    OP_POSTERIZE,
    OP_SOLARIZE,
    OP_AUTOCONTRAST,
    OP_EQUALIZE,
    OP_INVERT,
) = range(15)
NUM_OPS = 15

_NAME_TO_OP = {
    "identity": OP_IDENTITY, "shearx": OP_SHEAR_X, "sheary": OP_SHEAR_Y,
    "translatex": OP_TRANSLATE_X, "translatey": OP_TRANSLATE_Y, "rotate": OP_ROTATE,
    "brightness": OP_BRIGHTNESS, "color": OP_COLOR, "contrast": OP_CONTRAST,
    "sharpness": OP_SHARPNESS, "posterize": OP_POSTERIZE, "solarize": OP_SOLARIZE,
    "autocontrast": OP_AUTOCONTRAST, "equalize": OP_EQUALIZE, "invert": OP_INVERT,
}
_SIGNED = {OP_SHEAR_X, OP_SHEAR_Y, OP_TRANSLATE_X, OP_TRANSLATE_Y, OP_ROTATE,
           OP_BRIGHTNESS, OP_COLOR, OP_CONTRAST, OP_SHARPNESS}
_GEOMETRIC = (OP_SHEAR_X, OP_SHEAR_Y, OP_TRANSLATE_X, OP_TRANSLATE_Y, OP_ROTATE)

# --- published policies (Cubuk et al. 2019, Tables 7 and 8) -----------------
CIFAR10_POLICY = [
    (("invert", 0.1, 7), ("contrast", 0.2, 6)),
    (("rotate", 0.7, 2), ("translatex", 0.3, 9)),
    (("sharpness", 0.8, 1), ("sharpness", 0.9, 3)),
    (("sheary", 0.5, 8), ("translatey", 0.7, 9)),
    (("autocontrast", 0.5, 8), ("equalize", 0.9, 2)),
    (("sheary", 0.2, 7), ("posterize", 0.3, 7)),
    (("color", 0.4, 3), ("brightness", 0.6, 7)),
    (("sharpness", 0.3, 9), ("brightness", 0.7, 9)),
    (("equalize", 0.6, 5), ("equalize", 0.5, 1)),
    (("contrast", 0.6, 7), ("sharpness", 0.6, 5)),
    (("color", 0.7, 7), ("translatex", 0.5, 8)),
    (("equalize", 0.3, 7), ("autocontrast", 0.4, 8)),
    (("translatey", 0.4, 3), ("sharpness", 0.2, 6)),
    (("brightness", 0.9, 6), ("color", 0.2, 8)),
    (("solarize", 0.5, 2), ("invert", 0.0, 3)),
    (("equalize", 0.2, 0), ("autocontrast", 0.6, 0)),
    (("equalize", 0.2, 8), ("equalize", 0.6, 4)),
    (("color", 0.9, 9), ("equalize", 0.6, 6)),
    (("autocontrast", 0.8, 4), ("solarize", 0.2, 8)),
    (("brightness", 0.1, 3), ("color", 0.7, 0)),
    (("solarize", 0.4, 5), ("autocontrast", 0.9, 3)),
    (("translatey", 0.9, 9), ("translatey", 0.7, 9)),
    (("autocontrast", 0.9, 2), ("solarize", 0.8, 3)),
    (("equalize", 0.8, 8), ("invert", 0.1, 3)),
    (("translatey", 0.7, 9), ("autocontrast", 0.9, 1)),
]

IMAGENET_POLICY = [
    (("posterize", 0.4, 8), ("rotate", 0.6, 9)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
    (("posterize", 0.6, 7), ("posterize", 0.6, 6)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("equalize", 0.4, 4), ("rotate", 0.8, 8)),
    (("solarize", 0.6, 3), ("equalize", 0.6, 7)),
    (("posterize", 0.8, 5), ("equalize", 1.0, 2)),
    (("rotate", 0.2, 3), ("solarize", 0.6, 8)),
    (("equalize", 0.6, 8), ("posterize", 0.4, 6)),
    (("rotate", 0.8, 8), ("color", 0.4, 0)),
    (("rotate", 0.4, 9), ("equalize", 0.6, 2)),
    (("equalize", 0.0, 7), ("equalize", 0.8, 8)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("rotate", 0.8, 8), ("color", 1.0, 2)),
    (("color", 0.8, 8), ("solarize", 0.8, 7)),
    (("sharpness", 0.4, 7), ("invert", 0.6, 8)),
    (("shearx", 0.6, 5), ("equalize", 1.0, 9)),
    (("color", 0.4, 0), ("equalize", 0.6, 3)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
]

_POLICIES = {"cifar10": CIFAR10_POLICY, "cifar100": CIFAR10_POLICY, "imagenet": IMAGENET_POLICY,
             "synthetic": CIFAR10_POLICY, "digits": CIFAR10_POLICY}


def policy_arrays(policy) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (op ids int32 [P, 2], probabilities fp32 [P, 2], magnitude bins int32 [P, 2])."""
    ops = np.array([[_NAME_TO_OP[a[0]], _NAME_TO_OP[b[0]]] for a, b in policy], np.int32)
    probs = np.array([[a[1], b[1]] for a, b in policy], np.float32)
    mags = np.array([[a[2], b[2]] for a, b in policy], np.int32)
    return ops, probs, mags


def magnitude_table(size: int) -> np.ndarray:
    """(op, bin) → unsigned magnitude, fp32 [15, 10] (≙ autoaugment.py:
    _magnitude; translate scaled by the image size), in the fp32 arithmetic
    the JAX package's jitted augmentation runs: XLA turns ``bin / 9`` into
    ``bin · (1/9)`` and folds each constant factor into it, ``bin · (c ·
    (1/9))``, which differs from the eager ``c · (bin / 9)`` in the last
    bit of some entries."""
    f32 = np.float32
    k = np.arange(10, dtype=f32)
    ninth = f32(1.0 / 9.0)

    def scaled(c: float) -> np.ndarray:
        return k * f32(f32(c) * ninth)

    shear = scaled(0.3)
    translate = scaled((150.0 / 331.0) * size)
    rotate = scaled(30.0)
    enhance = scaled(0.9)
    posterize = f32(8.0) - np.round(scaled(4.0))  # bits 8..4
    solarize = f32(255.0) * (f32(1.0) - k * ninth)  # threshold 255..0
    zero = np.zeros(10, f32)
    return np.stack([zero, shear, shear, translate, translate, rotate, enhance, enhance, enhance,
                     enhance, posterize, solarize, zero, zero, zero]).astype(f32)


# --- the draw ----------------------------------------------------------------
_MASK64 = (1 << 64) - 1


def step_seed(rng: np.ndarray, step: int) -> int:
    """The 64-bit seed of a step's draw: the run key's two uint32 words as
    one 64-bit word, XOR ``step · 0x9E3779B97F4A7C15``, through splitmix64's
    finalizer (z ^= z >> 30; z *= 0xBF58476D1CE4E5B9; z ^= z >> 27;
    z *= 0x94D049BB133111EB; z ^= z >> 31), all mod 2⁶⁴."""
    words = np.asarray(rng, dtype=np.uint32).reshape(-1)
    z = ((int(words[0]) << 32) | int(words[1])) ^ ((int(step) * 0x9E3779B97F4A7C15) & _MASK64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_generator(rng: np.ndarray, step: int) -> torch.Generator:
    """A host generator seeded by ``step_seed(rng, step)`` (≙ the JAX
    trainer's ``fold_in(state.rng, step)``; the bits differ from JAX's)."""
    return torch.Generator().manual_seed(step_seed(rng, step))


@dataclass
class Decisions:
    """Per image: the sub-policy [B], two coins in [0, 1) [B, 2], two signs ±1 [B, 2]."""

    policy: np.ndarray
    coins: np.ndarray
    signs: np.ndarray


def draw(batch: int, generator: torch.Generator, *, num_policies: int = 25) -> Decisions:
    """One sub-policy, two coins and two signs per image (≙ _augment_one's
    draws: randint, uniform, bernoulli(0.5) → +1)."""
    pol = torch.randint(0, num_policies, (batch,), generator=generator)
    coins = torch.rand((batch, 2), generator=generator)
    signs = torch.where(torch.rand((batch, 2), generator=generator) < 0.5, 1.0, -1.0)
    return Decisions(pol.numpy(), coins.numpy(), signs.numpy().astype(np.float32))


def plan(dec: Decisions, dataset: str, size: int) -> tuple[np.ndarray, np.ndarray]:
    """→ (op int64 [B, 2], signed magnitude fp32 [B, 2]): each stage's op,
    identity where its coin is not below the probability (≙ _augment_one)."""
    ops, probs, bins = policy_arrays(_POLICIES[dataset.lower()])
    table = magnitude_table(size)
    op = ops[dec.policy]
    mag = table[op, bins[dec.policy]]
    mag = np.where(np.isin(op, sorted(_SIGNED)), dec.signs * mag, mag).astype(np.float32)
    op = np.where(dec.coins < probs[dec.policy], op, OP_IDENTITY).astype(np.int64)
    return op, mag


# --- the ops, batched: x fp32 [n, C, H, W] on [0, 255], v fp32 [n] ----------
def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, exactly (≙ lax.round; ``torch.round``
    rounds half to even)."""
    t = torch.trunc(x)
    return t + torch.where((x - t).abs() >= 0.5, torch.sign(x), torch.zeros_like(x))


def _affine_warp(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Inverse affine ``inv`` [n, 2, 3] about the image centre, nearest
    sampling, 0 outside (≙ _affine_warp with map_coordinates(order=0,
    mode="constant"))."""
    n, c, h, w = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=x.device) - (w - 1) / 2.0
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    a = inv[:, :, :, None, None]
    src_x = a[:, 0, 0] * xx + a[:, 0, 1] * yy + a[:, 0, 2] + (w - 1) / 2.0
    src_y = a[:, 1, 0] * xx + a[:, 1, 1] * yy + a[:, 1, 2] + (h - 1) / 2.0
    ix = _round_half_away(src_x).to(torch.int64)
    iy = _round_half_away(src_y).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(n, 1, h * w).expand(n, c, h * w)
    out = x.reshape(n, c, h * w).gather(2, flat).reshape(n, c, h, w)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def _geometric(x: torch.Tensor, op: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Shear, translate and rotate in one warp: each image's inverse map
    from its op and magnitude (≙ _shear_x … _rotate; rotate's cos and sin
    in fp32 of the angle as the jitted JAX package computes ``v·π/180``:
    ``v · (π · (1/180))``, XLA's folding)."""
    rad = v * float(np.float32(np.float32(math.pi) * np.float32(1.0 / 180.0)))
    cos, sin = torch.cos(rad), torch.sin(rad)
    one, zero = torch.ones_like(v), torch.zeros_like(v)

    def entry(default, *cases):
        for k, value in cases:
            default = torch.where(op == k, value, default)
        return default

    inv = torch.stack([
        entry(one, (OP_ROTATE, cos)), entry(zero, (OP_SHEAR_X, v), (OP_ROTATE, sin)),
        entry(zero, (OP_TRANSLATE_X, -v)),
        entry(zero, (OP_SHEAR_Y, v), (OP_ROTATE, -sin)), entry(one, (OP_ROTATE, cos)),
        entry(zero, (OP_TRANSLATE_Y, -v)),
    ], dim=-1).reshape(-1, 2, 3)
    return _affine_warp(x, inv)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601-2 luma (PIL ``convert("L")``) → [n, 1, H, W]."""
    return (0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2])[:, None]


def _blend(a: torch.Tensor, b: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL's enhance: b + factor·(a − b), clipped to [0, 255]."""
    return torch.clamp(b + factor[:, None, None, None] * (a - b), 0.0, 255.0)


def _brightness(x, v):
    return _blend(x, torch.zeros_like(x), 1.0 + v)


def _color(x, v):
    return _blend(x, _grayscale(x).expand_as(x), 1.0 + v)


def _contrast(x, v):
    mean = torch.round(_grayscale(x)).mean(dim=(1, 2, 3), keepdim=True)
    return _blend(x, mean.expand_as(x), 1.0 + v)


_SMOOTH = ((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0))  # PIL's SMOOTH, over 13


def _sharpness(x, v):
    """Blend with PIL's SMOOTH of the interior; the border keeps its pixels."""
    h, w = x.shape[-2:]
    weights = torch.tensor(_SMOOTH, dtype=torch.float32) / 13.0
    inner = torch.zeros_like(x[..., 1:-1, 1:-1])
    for dy in range(3):
        for dx in range(3):
            inner = inner + weights[dy, dx].item() * x[..., dy:dy + h - 2, dx:dx + w - 2]
    smooth = x.clone()
    smooth[..., 1:-1, 1:-1] = inner
    return _blend(x, smooth, 1.0 + v)


def _posterize(x, bits):
    q = torch.pow(2.0, 8.0 - bits)[:, None, None, None]
    return torch.clamp(torch.floor(x / q) * q, 0.0, 255.0)


def _solarize(x, thr):
    return torch.where(x >= thr[:, None, None, None], 255.0 - x, x)


def _autocontrast(x, _v):
    lo = x.amin(dim=(2, 3), keepdim=True)
    hi = x.amax(dim=(2, 3), keepdim=True)
    # a true division: ``255.0 / t`` is torch's reciprocal times 255, one ulp off
    scale = torch.full_like(lo, 255.0) / torch.clamp_min(hi - lo, 1e-6)
    return torch.where(hi > lo, torch.clamp((x - lo) * scale, 0.0, 255.0), x)


def _equalize(x, _v):
    """PIL ``ImageOps.equalize`` per channel, in integers: the histogram by
    scatter-add, ``step = (npix − count of the last occupied bin) // 255``,
    ``lut = (step // 2 + exclusive cumsum) // step``; a channel with step 0
    keeps its pixels."""
    n, c, h, w = x.shape
    vals = torch.clamp(torch.round(x), 0, 255).to(torch.int64).reshape(n * c, h * w)
    hist = torch.zeros((n * c, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, vals, torch.ones_like(vals))
    bins = torch.arange(256, device=x.device)
    last = torch.where(hist > 0, bins, -1).amax(dim=1, keepdim=True)
    step = (h * w - hist.gather(1, last)) // 255
    cum = torch.cumsum(hist, dim=1) - hist
    lut = torch.clamp((step // 2 + cum) // torch.clamp_min(step, 1), 0, 255)
    eq = lut.gather(1, vals).to(torch.float32).reshape(n, c, h, w)
    return torch.where((step == 0).reshape(n, c, 1, 1), x, eq)


def _invert(x, _v):
    return 255.0 - x


_PHOTOMETRIC = {
    OP_BRIGHTNESS: _brightness, OP_COLOR: _color, OP_CONTRAST: _contrast,
    OP_SHARPNESS: _sharpness, OP_POSTERIZE: _posterize, OP_SOLARIZE: _solarize,
    OP_AUTOCONTRAST: _autocontrast, OP_EQUALIZE: _equalize, OP_INVERT: _invert,
}


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array → a tensor on ``device``; to a card from pinned memory
    without blocking, so the host does not wait for the device."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def apply_ops(x: torch.Tensor, op: np.ndarray, mag: np.ndarray) -> torch.Tensor:
    """One stage: image i of ``x`` (fp32 [n, C, H, W] on [0, 255]) through
    op ``op[i]`` at magnitude ``mag[i]`` (host arrays) → fp32, a new tensor
    (≙ vmap of _apply_op).  Each op runs on the images that drew it."""
    op = np.asarray(op, dtype=np.int64)
    mag = np.asarray(mag, dtype=np.float32)
    groups = [(k, np.nonzero(np.isin(op, k))[0]) for k in (_GEOMETRIC, *_PHOTOMETRIC)]
    groups = [(k, idx) for k, idx in groups if len(idx)]
    out = x.clone()
    if not groups:
        return out
    # each group's indices, ops and magnitudes, aligned, uploaded once per stage
    order = np.concatenate([idx for _, idx in groups])
    d_idx, d_op, d_mag = (_upload(a, x.device) for a in (order, op[order], mag[order]))
    start = 0
    for k, idx in groups:
        sl = slice(start, start + len(idx))
        start += len(idx)
        sub = x.index_select(0, d_idx[sl])
        if k is _GEOMETRIC:
            res = _geometric(sub, d_op[sl], d_mag[sl])
        else:
            res = _PHOTOMETRIC[k](sub, d_mag[sl])
        out.index_copy_(0, d_idx[sl], res)
    return out


def apply_plan(images_u8: torch.Tensor, op: np.ndarray, mag: np.ndarray) -> torch.Tensor:
    """Both stages of ``plan`` on a uint8 batch, then round, clip, uint8."""
    x = images_u8.to(torch.float32)
    for stage in range(op.shape[1]):
        x = apply_ops(x, op[:, stage], mag[:, stage])
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def auto_augment_batch(images_u8: torch.Tensor, generator: torch.Generator, *,
                       dataset: str = "cifar10", row0: int = 0, batch: int | None = None) -> torch.Tensor:
    """AutoAugment a uint8 [B, C, H, W] batch with the dataset's policy,
    drawing from ``generator`` (≙ autoaugment.py:auto_augment_batch).
    ``images_u8`` are rows ``row0 … row0 + B − 1`` of a global batch of
    ``batch`` images (default B): the draw is the global batch's, so an
    image's augmentation does not depend on how many ranks share it (≙ JAX
    augmenting the assembled global batch)."""
    policy = _POLICIES[dataset.lower()]
    n = images_u8.shape[0]
    dec = draw(n if batch is None else batch, generator, num_policies=len(policy))
    rows = slice(row0, row0 + n)
    dec = Decisions(dec.policy[rows], dec.coins[rows], dec.signs[rows])
    op, mag = plan(dec, dataset, images_u8.shape[-1])
    return apply_plan(images_u8, op, mag)
