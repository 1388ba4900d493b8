"""Inference API (≙ nvit_tpu/infer.py): batched prediction on one device.

Usage::

    from nvit_tpu_torch.infer import Predictor
    p = Predictor.from_config(cfg, seed=0, device="cuda")   # random weights
    labels, probs = p.predict(images_u8)                      # [B,C,H,W] uint8

or ``Predictor.from_checkpoint(out_dir, "checkpoint_best")`` (a training
checkpoint, the JAX package's or the port's), ``Predictor.from_export(dest,
name)`` (a params-only export, ``ckpt/export.py``), or
``Predictor(state_dict, cfg.model, device="cuda")`` with a ``state_dict``
from ``ckpt.convert.state_dict_from_jax``.  None of them builds an
optimizer.  The forward runs the port's kernels where the model's config
selects them.  ``quantize="int8"`` serves w8a8 (``ops/quant.py``): int8
linears on ``torch._int_mm``, attention still on K1/K5 or K7.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from nvit_tpu_torch.ckpt.checkpoint import restore_params
from nvit_tpu_torch.ckpt.export import load_export
from nvit_tpu_torch.configs import Config, ViTConfig
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.ops.quant import int8_skeleton, quantize_vit


def topk_from_probs(probs: np.ndarray, top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """probs [B, C] → (top-k class indices [B, k], probabilities [B, k])."""
    idx = np.argsort(-probs, axis=-1)[:, :top_k]
    return idx, np.take_along_axis(probs, idx, axis=-1)


class Predictor:
    def __init__(
        self,
        state_dict_or_module: Mapping[str, torch.Tensor] | ViT,
        model_cfg: ViTConfig,
        *,
        device: torch.device | str = "cuda",
        compute_dtype: torch.dtype | None = torch.bfloat16,
        data_parallel: bool = False,
        model_parallel: int = 1,
        quantize: str | None = None,
    ):
        """``state_dict_or_module``: a ``ViT`` (moved to ``device``, the card
        unless the caller asks for the CPU) or its ``state_dict`` (loaded
        strictly; an int8 one into the int8 model).  ``compute_dtype=None``
        runs fp32.  ``quantize="int8"`` quantizes every linear once, after
        loading (w8a8, ``ops/quant.py``); an int8 export stays as stored."""
        if data_parallel or model_parallel != 1:
            raise NotImplementedError(
                "data_parallel / model_parallel are not ported yet (ROADMAP.md, multi-GPU)"
            )
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        if isinstance(state_dict_or_module, nn.Module):
            model = state_dict_or_module.to(self.device)
        else:
            model = ViT(model_cfg, device=self.device)
            if any(name.endswith(".wq") for name in state_dict_or_module):
                int8_skeleton(model)
            model.load_state_dict(state_dict_or_module, strict=True)
        if quantize == "int8":
            quantize_vit(model)
        self.model = model.eval()

    @classmethod
    def from_config(cls, cfg: Config, seed: int = 0, *, device: torch.device | str = "cuda",
                    **kw) -> "Predictor":
        """Fresh random weights from ``seed`` (testing / warm-pool prebuild)."""
        device = torch.device(device)
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        model = ViT(cfg.model, device=device).init_weights(g)
        return cls(model, cfg.model, device=device, **kw)

    @classmethod
    def from_checkpoint(cls, out_dir: str | Path, name: str = "checkpoint_best",
                        **kw) -> "Predictor":
        """The parameters of a training checkpoint; its moments stay unread."""
        sd, cfg, _meta = restore_params(out_dir, name)
        return cls(sd, cfg.model, **kw)

    @classmethod
    def from_export(cls, dest: str | Path, name: str = "checkpoint_best", **kw) -> "Predictor":
        """A params-only export (``ckpt/export.py``); bf16 leaves load into
        the fp32 model exactly."""
        sd, model_cfg = load_export(dest, name)
        return cls(sd, model_cfg, **kw)

    def predict_probs(self, images_u8) -> np.ndarray:
        """[B, C, H, W] uint8 → softmax probabilities [B, num_classes] (fp32)."""
        # np.array copies: request bodies arrive as read-only buffers
        x = torch.from_numpy(np.array(images_u8, dtype=np.uint8)).to(self.device)
        with torch.inference_mode():
            logits = self.model(normalize(x), compute_dtype=self.compute_dtype)
            probs = torch.softmax(logits.float(), dim=-1)
        return probs.cpu().numpy()

    def predict(self, images_u8, top_k: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """→ (top-k class indices [B, k], probabilities [B, k])."""
        return topk_from_probs(self.predict_probs(images_u8), top_k)
