"""Inference-only export: the parameters, no optimizer state
(≙ nvit_tpu/ckpt/export.py).

``export_for_inference`` reads a training checkpoint's parameters (its
moments stay unread) and writes ``<dest>/<name>.export.npz`` and
``.export.json`` in the JAX package's export format
(``"nvit_tpu.ckpt.export.v1"``: the params' leaves in ``jax.tree_util``
order, the model config, the storage dtype, the source iteration and
metrics), atomically like the checkpoints; ``dtype="int8"`` stores the
int8 tree of ``ops/quant.py``, as the JAX package's int8 export does.
``bfloat16`` leaves are stored
as the 2-byte void records numpy writes for ``ml_dtypes.bfloat16``, so a
JAX export loads here and a port export loads in the JAX package.
``Predictor.from_export`` serves one without building an optimizer.  The
export is a file transform: it reads and writes files and touches no
device::

    python -m nvit_tpu_torch.ckpt.export --checkpoint out --name checkpoint_best --dest deploy/
    # → deploy/checkpoint_best.export.npz + .export.json    [--dtype float32 | int8]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nvit_tpu_torch.ckpt.checkpoint import read_params, state_dict_of_leaves, write_files
from nvit_tpu_torch.ckpt.convert import jax_params_from_state_dict
from nvit_tpu_torch.ckpt.tree import flatten, param_tree
from nvit_tpu_torch.configs import ViTConfig, merge_dataclass
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.ops.quant import quantize_vit

EXPORT_FORMAT = "nvit_tpu.ckpt.export.v1"


def bf16_to_void(a: np.ndarray) -> np.ndarray:
    """fp32 → bf16 (round to nearest even, as ``astype(bfloat16)``) stored as
    the 2-byte void records numpy writes for ``ml_dtypes.bfloat16``; the JAX
    package's loaders view them back.  (int16 would be cast as integers.)"""
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view("V2")


def int8_leaves(leaves: list[np.ndarray], model_cfg: ViTConfig) -> list[np.ndarray]:
    """The params' fp32 leaves → the int8 tree's leaves (``ops/quant.py``:
    every linear ``b``, ``scale``, ``wq``; the rest fp32), quantized on the CPU."""
    model = ViT(model_cfg, device="cpu")
    model.load_state_dict(state_dict_of_leaves(leaves, model_cfg), strict=True)
    return [leaf for _, leaf in flatten(jax_params_from_state_dict(quantize_vit(model).state_dict(), model_cfg))]


def export_for_inference(out_dir: str | Path, name: str, dest: str | Path, *,
                         dtype: str = "bfloat16") -> Path:
    """Checkpoint ``<out_dir>/<name>`` → the params-only artifact in ``dest``;
    ``dtype`` stores the floating-point leaves in bfloat16 (half the bytes)
    or float32 (the master copy, exact), or ``int8`` the w8a8 serving tree
    (int8 linears with fp32 per-channel scales, the rest fp32: ~12× smaller
    than the checkpoint, served without quantizing again)."""
    if dtype not in ("bfloat16", "float32", "int8"):
        raise ValueError(f"export dtype must be bfloat16, float32 or int8, got {dtype!r}")
    leaves, cfg, meta = read_params(out_dir, name)
    if dtype == "bfloat16":
        leaves = [bf16_to_void(a) for a in leaves]
    elif dtype == "int8":
        leaves = int8_leaves(leaves, cfg.model)
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    return write_files(dest, f"{name}.export", leaves, {
        "format": EXPORT_FORMAT,
        "model": cfg.to_dict()["model"],
        "dtype": dtype,
        "num_leaves": len(leaves),
        "source_iter": meta.get("iter_num"),
        "source_metrics": meta.get("metrics", {}),
    })


def load_export(dest: str | Path, name: str) -> tuple[dict[str, torch.Tensor], ViTConfig]:
    """→ (state_dict on the CPU in the stored dtype, ViTConfig) from an
    export; an int8 export gives the int8 model's ``state_dict``
    (``ops.quant.int8_skeleton`` takes it), quantized as it was stored."""
    dest = Path(dest)
    meta = json.loads((dest / f"{name}.export.json").read_text())
    if meta.get("format") != EXPORT_FORMAT:
        raise ValueError(f"not an inference export: format={meta.get('format')!r}")
    int8 = meta.get("dtype") == "int8"
    model_cfg = merge_dataclass(ViTConfig(), meta["model"])
    specs = flatten(param_tree(model_cfg, int8=int8))
    if meta["num_leaves"] != len(specs):
        raise ValueError(f"leaf count mismatch: the model has {len(specs)}, the export {meta['num_leaves']}")
    with np.load(dest / f"{name}.export.npz") as z:
        stored = [z[f"leaf_{i}"] for i in range(len(specs))]
    for (path, spec), a in zip(specs, stored):
        if a.shape != spec.shape or (a.dtype.kind == "V" and a.dtype.itemsize != 2):
            raise ValueError(f"export leaf {path} is {a.dtype} {a.shape}, expected {spec.shape}")
    return state_dict_of_leaves(stored, model_cfg, int8=int8), model_cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Export a params-only inference artifact")
    ap.add_argument("--checkpoint", default="out")
    ap.add_argument("--name", default="checkpoint_best")
    ap.add_argument("--dest", default="deploy")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"])
    args = ap.parse_args(argv)
    path = export_for_inference(args.checkpoint, args.name, args.dest, dtype=args.dtype)
    size_mb = path.stat().st_size / 1e6
    src = Path(args.checkpoint) / f"{args.name}.npz"
    note = f" (train ckpt {src.stat().st_size / 1e6:.1f} MB)" if src.exists() else ""
    print(f"exported {path} ({size_mb:.1f} MB{note})")


if __name__ == "__main__":
    main()
