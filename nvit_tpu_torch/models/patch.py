"""Dual patch embedding as matmuls (≙ nvit_tpu/models/patch.py:24-79).

* local: stride == kernel ⇒ space-to-depth reshape + one matmul;
* global: kernel 2× stride over a centred reflection pad ⇒ each window is a
  2×2 group of neighbouring space-to-depth blocks (slices + one concat).

The weights keep the reference's Conv2d layout ``[d, C, k, k]`` (the
``state_dict`` contract).  The local weight flattens straight onto the
``(C, ph, pw)`` token layout; the global weight's fan-in is permuted onto the
2×2-block-major layout by ``global_embed_permutation``.  Being matmuls, the
embeds follow the matmul TF32 setting (off by default in PyTorch), not
cuDNN's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] → [B, T, C·p·p] with per-token layout (C, ph, pw)."""
    b, c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, p, p]
    return x.reshape(b, gh * gw, c * patch * patch)


def extract_overlapping_patches(img: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """[B, C, H, W] → [B, T, C·k·k] windows of ``kernel`` at ``stride``.

    For kernel == 2·stride (the model's 16/8 case) the feature layout is
    2×2-block-major, each block (C, s, s), exactly as the JAX package lays it
    out.  Other shapes use im2col (``F.unfold``), whose (C, kh, kw) order is
    the conv's own."""
    b = img.shape[0]
    if kernel == 2 * stride:
        x = space_to_depth(img, stride)
        gh = img.shape[2] // stride
        gw = img.shape[3] // stride
        x = x.reshape(b, gh, gw, -1)
        g = torch.cat(
            [x[:, :-1, :-1], x[:, :-1, 1:], x[:, 1:, :-1], x[:, 1:, 1:]], dim=-1
        )  # [B, gh-1, gw-1, 4·C·s·s]
        return g.reshape(b, (gh - 1) * (gw - 1), -1)
    return F.unfold(img, kernel_size=kernel, stride=stride).transpose(1, 2)


def reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflection-pad H and W (≙ torch nn.ReflectionPad2d)."""
    if pad == 0:
        return img
    return F.pad(img, (pad, pad, pad, pad), mode="reflect")


def global_embed_permutation(channels: int, kernel: int, stride: int) -> np.ndarray:
    """``perm[our_feature] = conv_flat_index``: maps a Conv2d's flattened
    ``(C, kh, kw)`` fan-in onto extract_overlapping_patches' layout.
    Identity unless kernel == 2·stride.  (≙ the mapping of
    nvit_tpu/ckpt/torch_interop.py:82-103.)"""
    if kernel != 2 * stride:
        return np.arange(channels * kernel * kernel, dtype=np.int64)
    s = stride
    blk_i, blk_j, c, ph, pw = np.meshgrid(
        np.arange(2), np.arange(2), np.arange(channels), np.arange(s), np.arange(s),
        indexing="ij",
    )
    # our index runs over (block = 2i + j, c, ph, pw) in C order, which is the
    # meshgrid's own order — so the flattened conv indices are the permutation
    conv = c * kernel * kernel + (blk_i * s + ph) * kernel + (blk_j * s + pw)
    return conv.reshape(-1).astype(np.int64)
