"""Weights and inputs drawn from ``--seed`` on the device, in a few large
calls, handed alike to the program and to the reference.

The seed's streams are kept apart by ``stream_seed``: the weights, the
image pool and the labels, the arrivals, the sample that is checked, each
data rank's rows.
"""

from __future__ import annotations

import hashlib

import torch
import torch.nn.functional as F

from benchmark.reference.model import layout


def stream_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of ``seed`` (any size of integer)."""
    h = hashlib.sha256(repr((int(seed), *parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device: torch.device | str, seed: int, *parts) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *parts))
    return g


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """fp32 ``state_dict`` with training's initial distributions: one normal
    and one uniform draw for all leaves, sliced and scaled."""
    spec = layout(model)
    g = generator(device, seed, "weights")
    sizes = {kind: sum(_numel(s) for _, s, k, _ in spec if k == kind) for kind in ("normal", "uniform")}
    normal = torch.randn(sizes["normal"], generator=g, device=device)
    uniform = torch.rand(sizes["uniform"], generator=g, device=device)
    ofs = {"normal": 0, "uniform": 0}
    sd = {}
    for name, shape, kind, value in spec:
        n = _numel(shape)
        if kind == "const":
            sd[name] = torch.full(shape, float(value), device=device)
            continue
        raw = (normal if kind == "normal" else uniform)[ofs[kind]:ofs[kind] + n].view(shape)
        ofs[kind] += n
        sd[name] = raw * value if kind == "normal" else (raw * 2.0 - 1.0) * value
    return sd


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def make_images(n: int, size: int, channels: int, g: torch.Generator, device) -> torch.Tensor:
    """uint8 [n, C, size, size]: a smooth colour field (a 7 × 7 grid of random
    colours, upsampled) of random contrast and brightness under fine noise,
    so that images differ in what a classifier sees and not in noise alone."""
    coarse = torch.rand((n, channels, 7, 7), generator=g, device=device)
    field = F.interpolate(coarse, size=(size, size), mode="bilinear", align_corners=False)
    contrast = torch.rand((n, 1, 1, 1), generator=g, device=device) * 0.8 + 0.2
    bright = torch.rand((n, 1, 1, 1), generator=g, device=device) * (1.0 - contrast)
    noise = torch.rand((n, channels, size, size), generator=g, device=device) * 0.2 - 0.1
    img = (field * contrast + bright + noise).clamp_(0.0, 1.0)
    return (img * 255.0).round_().to(torch.uint8)
