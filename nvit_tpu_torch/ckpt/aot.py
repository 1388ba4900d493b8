"""AOT serving artifact via ``torch.export`` (≙ nvit_tpu/ckpt/aot.py): the
whole serving computation — ``normalize`` → the forward → fp32 softmax — as
one exported program with the weights inside, so a serving host loads it
without building the model from code.

    python -m nvit_tpu_torch.ckpt.aot --checkpoint out --name checkpoint_best --dest deploy/ [--int8] [--batch N]
    python -m nvit_tpu_torch.serve --checkpoint deploy --name checkpoint_best --aot

* ``<name>.aot.pt2`` (``torch.export.save``) and ``<name>.aot.json``, whose
  ``format`` is ``nvit_tpu_torch.ckpt.aot.v1``; the other meta fields are the
  JAX package's, ``platforms`` the device type the program was exported on
  (``["cuda"]`` or ``["cpu"]``), checked at load.
* The kernels are registered operators (``torch.ops.nvit.qknorm_attention``,
  ``.flash_attention``, ``.gated_mlp``; ops/flash_attention.py,
  ops/gated_mlp.py), so the program calls them and the loaded program
  launches K1/K5 after the prologue, K7 and K3/K6 as the eager forward does.
  So are the residual updates (``torch.ops.nvit.slerp_residual``,
  ``.norm_skip``; core/residual.py, imported here with the model), on
  every path, so every program needs them registered where it is loaded.
* ``batch=None`` exports a symbolic batch on the plain path
  (``flash_attn=False``, meta ``"attention": "plain"``), as the JAX package
  does (its Pallas grids cannot be shape-polymorphic), so a symbolic
  artifact computes what JAX's does, plain but for the residual updates,
  which launch their kernels on CUDA and run their twins on the CPU;
  ``batch=N`` pins the batch and keeps the configured kernels.  The
  registered operators would take a symbolic batch: lifting the swap is an
  open choice (ROADMAP.md).
* ``quantize="int8"`` quantizes first (ops/quant.py): the program holds the
  int8 weights and ``torch._int_mm``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch
from torch import nn

from nvit_tpu_torch.ckpt.checkpoint import restore_params
from nvit_tpu_torch.configs import ViTConfig, merge_dataclass
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.infer import topk_from_probs
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.ops import flash_attention, gated_mlp  # noqa: F401  (registers the operators)
from nvit_tpu_torch.ops.quant import quantize_vit

AOT_FORMAT = "nvit_tpu_torch.ckpt.aot.v1"


class ServingForward(nn.Module):
    """uint8 images [B, C, H, W] → fp32 probabilities, exactly as
    ``Predictor.predict_probs`` computes them."""

    def __init__(self, model: ViT, compute_dtype: torch.dtype | None = torch.bfloat16):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        logits = self.model(normalize(images_u8), compute_dtype=self.compute_dtype)
        return torch.softmax(logits.float(), dim=-1)


def export_aot(out_dir: str | Path, name: str, dest: str | Path, *, quantize: str | None = None,
               batch: int | None = None, device: torch.device | str = "cuda") -> Path:
    """Training checkpoint ``<out_dir>/<name>`` → ``<dest>/<name>.aot.pt2`` and
    ``.aot.json``: ``torch.export`` of ``ServingForward`` under ``no_grad`` on
    ``device`` (the card unless the caller asks for the CPU), at the pinned
    ``batch`` or, for ``batch=None``, a symbolic one (an example of 2 keeps
    export from specializing it to 1).  The payload lands under a temporary
    name first and the json, which ``load_aot`` reads first, is renamed last."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
    sd, cfg, meta = restore_params(out_dir, name)
    model_cfg = cfg.model
    if batch is None and model_cfg.flash_attn:
        model_cfg = dataclasses.replace(model_cfg, flash_attn=False)
    device = torch.device(device)
    model = ViT(model_cfg, device=device)
    model.load_state_dict(sd, strict=True)
    if quantize:
        quantize_vit(model)
    example = torch.zeros((batch or 2, model_cfg.channels, model_cfg.image_size, model_cfg.image_size),
                          dtype=torch.uint8, device=device)
    dynamic = None if batch else ({0: torch.export.Dim("batch", min=1, max=65536)},)
    with torch.no_grad():
        program = torch.export.export(ServingForward(model).eval(), (example,), dynamic_shapes=dynamic)

    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    tmp = {ext: dest / f".{name}.aot.tmp{ext}" for ext in (".pt2", ".json")}
    torch.export.save(program, tmp[".pt2"])
    tmp[".json"].write_text(json.dumps({
        "format": AOT_FORMAT,
        "model": cfg.to_dict()["model"],
        "quantize": quantize,
        "batch": batch,
        "attention": "flash" if model_cfg.flash_attn else "plain",
        "platforms": [device.type],
        "num_leaves": len(program.state_dict) + len(program.constants),
        "source_iter": meta.get("iter_num"),
        "source_metrics": meta.get("metrics", {}),
    }, indent=1))
    for ext in (".pt2", ".json"):
        os.replace(tmp[ext], dest / f"{name}.aot{ext}")
    return dest / f"{name}.aot.pt2"


class AotPredictor:
    """``Predictor``-shaped wrapper over a loaded artifact (drop-in for
    ``serve.InferenceService``: ``.cfg``, ``.pinned_batch``,
    ``.predict_probs``, ``.predict``)."""

    def __init__(self, program: torch.export.ExportedProgram, model_cfg: ViTConfig,
                 pinned_batch: int | None, device: torch.device | str):
        self.cfg = model_cfg
        # a pinned artifact takes exactly this batch; InferenceService pads up to it
        self.pinned_batch = pinned_batch
        self.device = torch.device(device)
        self._forward = program.module()

    def predict_probs(self, images_u8) -> np.ndarray:
        """[B, C, H, W] uint8 → softmax probabilities [B, num_classes] (fp32)."""
        images = np.array(images_u8, dtype=np.uint8)
        if self.pinned_batch and images.shape[0] != self.pinned_batch:
            raise ValueError(f"the artifact's pinned batch is {self.pinned_batch}, got {images.shape[0]}")
        with torch.inference_mode():
            probs = self._forward(torch.from_numpy(images).to(self.device))
        return probs.cpu().numpy()

    def predict(self, images_u8, top_k: int = 1) -> tuple[np.ndarray, np.ndarray]:
        return topk_from_probs(self.predict_probs(images_u8), top_k)


def load_aot(dest: str | Path, name: str, *, device: torch.device | str = "cuda") -> AotPredictor:
    """Restore an artifact to serve on ``device``: no model is built or traced."""
    dest = Path(dest)
    meta = json.loads((dest / f"{name}.aot.json").read_text())
    if meta.get("format") != AOT_FORMAT:
        raise ValueError(f"not an AOT export: format={meta.get('format')!r}")
    platforms = [p.lower() for p in meta.get("platforms", [])]
    backend = torch.device(device).type
    if platforms and backend not in platforms:
        raise ValueError(f"AOT artifact was lowered for {platforms} but this process runs on "
                         f"{backend!r} — re-export on the serving platform")
    program = torch.export.load(dest / f"{name}.aot.pt2")
    model_cfg = merge_dataclass(ViTConfig(), meta["model"])
    return AotPredictor(program, model_cfg, meta.get("batch"), device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export an AOT (torch.export) serving artifact")
    ap.add_argument("--checkpoint", default="out")
    ap.add_argument("--name", default="checkpoint_best")
    ap.add_argument("--dest", default="deploy")
    ap.add_argument("--int8", action="store_true", help="int8-quantize before export (w8a8)")
    ap.add_argument("--batch", type=int, default=None,
                    help="pin a concrete batch size (keeps the kernels); default: symbolic batch "
                         "(plain attention)")
    ap.add_argument("--device", default="cuda", help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)
    path = export_aot(args.checkpoint, args.name, args.dest, quantize="int8" if args.int8 else None,
                      batch=args.batch, device=args.device)
    total = sum((path.parent / f"{args.name}.aot{ext}").stat().st_size for ext in (".pt2", ".json"))
    print(f"exported {path} (+ .json, {total / 1e6:.1f} MB total)")


if __name__ == "__main__":
    main()
