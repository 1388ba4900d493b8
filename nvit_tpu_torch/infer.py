"""Inference API (≙ nvit_tpu/infer.py): batched prediction on one device,
or data-parallel over several.

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
``data_parallel=True`` keeps one replica per card (or per entry of
``devices=[...]``) and splits every batch over them; ``model_parallel=N``
shards each replica's trunk over N of them (tensor parallelism, in this
one process), and without ``data_parallel`` every device goes to the model
axis.
"""

from __future__ import annotations

import contextlib
import copy
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from nvit_tpu_torch.ckpt.checkpoint import restore_params
from nvit_tpu_torch.ckpt.export import load_export
from nvit_tpu_torch.configs import Config, ViTConfig
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.obs.profiling import span
from nvit_tpu_torch.ops.quant import int8_skeleton, quantize_vit
from nvit_tpu_torch.parallel.mesh import Axis
from nvit_tpu_torch.parallel.tensor import LocalShards


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
        devices: Sequence[torch.device | str] | None = None,
    ):
        """``state_dict_or_module``: a ``ViT`` (moved to ``device``, the card
        unless the caller asks for the CPU) or its ``state_dict`` (loaded
        strictly; an int8 one into the int8 model).  ``compute_dtype=None``
        runs fp32.  ``quantize="int8"`` quantizes every linear once, after
        loading (w8a8, ``ops/quant.py``); an int8 export stays as stored.

        ``data_parallel=True`` (≙ infer.py:40-157, the ``data`` mesh axis)
        keeps one replica on each of ``devices`` — default every visible
        card, or ``device`` alone on the CPU; a device may be listed twice —
        pads each batch to a multiple of their count, launches every chunk
        on its replica before it gathers any, so the cards overlap, and
        returns the one-replica probabilities.  It composes with int8.

        ``model_parallel=N`` (≙ infer.py:59-96, the ``model`` axis, with the
        training layout of ``parallel/mesh.py``) shards each replica's trunk
        over N consecutive ``devices``: every device (default every visible
        card; on the CPU N times the CPU) goes to the model axis unless
        ``data_parallel`` makes a data × model grid of them.  Each shard runs
        the kernels on its heads and u|v columns; the partial products are
        summed in shard order (``parallel/tensor.py::LocalShards``), so the
        result does not depend on timing.  Not with int8."""
        if model_parallel < 1:
            raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
        if quantize is not None and model_parallel > 1:
            raise ValueError("model_parallel > 1 is not supported with quantize yet")
        if devices is not None and not data_parallel and model_parallel == 1:
            raise ValueError("devices= lists the data-parallel replicas or the model shards: pass "
                             "data_parallel=True or model_parallel > 1")
        device = torch.device(device)
        if not data_parallel and model_parallel == 1:
            devices = [device]
        elif devices is None:
            devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                       if device.type == "cuda" else [device] * model_parallel)
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if not devices:
            raise ValueError("data_parallel=True with no device")
        if n % model_parallel:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        if not data_parallel and model_parallel not in (1, n):
            raise ValueError(f"model_parallel={model_parallel} without data_parallel would idle "
                             f"{n - model_parallel} of {n} devices; pass data_parallel=True")
        mp = model_parallel if data_parallel else n  # without data_parallel, every device is a shard
        self.cfg = model_cfg
        self.device = devices[0]
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
        self.devices = devices
        self.model_parallel = mp
        # each replica's input device: the first of its model group
        self._inputs = devices[::mp]
        if mp == 1:
            self.replicas = [self.model, *(copy.deepcopy(self.model).to(d) for d in devices[1:])]
        else:
            self.replicas = [tensor_parallel(m, devices[i * mp:(i + 1) * mp]) for i, m in enumerate(
                [self.model, *(copy.deepcopy(self.model) for _ in self._inputs[1:])])]
        self.batch_multiple = len(self.replicas)  # each batch pads to a multiple of this

    @property
    def layout(self) -> dict:
        """The serving layout: data replicas × model shards over the devices."""
        return {"data": len(self.replicas), "model": self.model_parallel,
                "devices": [str(d) for d in self.devices]}

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
        """[B, C, H, W] uint8 → softmax probabilities [B, num_classes] (fp32).

        Host spans (``obs/profiling.span``): ``nvit.infer.upload`` (the copy,
        the replica padding, each replica's rows to its device, normalized)
        and ``nvit.infer.readback`` (the gather, where the host waits for
        the device)."""
        outs = []
        with torch.inference_mode():
            with span("nvit.infer.upload"):
                # np.array copies: request bodies arrive as read-only buffers
                x = np.array(images_u8, dtype=np.uint8)
                b, m = x.shape[0], self.batch_multiple
                if b % m:  # ≙ infer.py:147-150: pad to a replica multiple
                    x = np.concatenate([x, np.zeros((m - b % m, *x.shape[1:]), np.uint8)])
                inputs = [normalize(torch.from_numpy(chunk).to(dev))
                          for dev, chunk in zip(self._inputs, np.split(x, m))]
            for model, dev, x_dev in zip(self.replicas, self._inputs, inputs):
                # launched on every replica before any is gathered
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    logits = model(x_dev, compute_dtype=self.compute_dtype)
                    outs.append(torch.softmax(logits.float(), dim=-1))
            with span("nvit.infer.readback"):
                probs = torch.cat([o.cpu() for o in outs])
        return probs[:b].numpy()

    def predict(self, images_u8, top_k: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """→ (top-k class indices [B, k], probabilities [B, k])."""
        return topk_from_probs(self.predict_probs(images_u8), top_k)


def tensor_parallel(model: ViT, devices: Sequence[torch.device]) -> ViT:
    """``model`` with each trunk block replaced by its ``len(devices)``
    model shards (``Block.shard_``), shard m on ``devices[m]``, run in this
    process (``LocalShards``); the rest of the model on ``devices[0]``."""
    model = model.to(devices[0])
    blocks = model.transformer["h"]
    for i, blk in enumerate(blocks):
        n = len(devices)
        blocks[i] = LocalShards([copy.deepcopy(blk).to(d).shard_(Axis(m, n)) for m, d in enumerate(devices)])
    return model
