"""Inference-only export: the parameters, no optimizer state
(≙ nvit_tpu/ckpt/export.py).

``export_for_inference`` reads a training checkpoint's parameters (its
moments stay unread) and writes ``<dest>/<name>.export.npz`` and
``.export.json`` in the JAX package's export format
(``"nvit_tpu.ckpt.export.v1"``: the params' leaves in ``jax.tree_util``
order, the model config, the storage dtype, the source iteration and
metrics), atomically like the checkpoints.  ``bfloat16`` leaves are stored
as the 2-byte void records numpy writes for ``ml_dtypes.bfloat16``, so a
JAX export loads here and a port export loads in the JAX package.
``Predictor.from_export`` serves one without building an optimizer.  The
export is a file transform: it reads and writes files and touches no
device::

    python -m nvit_tpu_torch.ckpt.export --checkpoint out --name checkpoint_best --dest deploy/
    # → deploy/checkpoint_best.export.npz + .export.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from nvit_tpu_torch.ckpt.checkpoint import read_params, state_dict_of_leaves, write_files
from nvit_tpu_torch.ckpt.tree import flatten, param_tree
from nvit_tpu_torch.configs import ViTConfig, merge_dataclass

EXPORT_FORMAT = "nvit_tpu.ckpt.export.v1"


def bf16_to_void(a: np.ndarray) -> np.ndarray:
    """fp32 → bf16 (round to nearest even, as ``astype(bfloat16)``) stored as
    the 2-byte void records numpy writes for ``ml_dtypes.bfloat16``; the JAX
    package's loaders view them back.  (int16 would be cast as integers.)"""
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view("V2")


def export_for_inference(out_dir: str | Path, name: str, dest: str | Path, *,
                         dtype: str = "bfloat16") -> Path:
    """Checkpoint ``<out_dir>/<name>`` → the params-only artifact in ``dest``;
    ``dtype`` stores the floating-point leaves in bfloat16 (half the bytes)
    or float32 (the master copy, exact)."""
    if dtype == "int8":
        raise NotImplementedError("export dtype 'int8' (w8a8) is not ported yet "
                                  "(ROADMAP.md, 'int8 serving')")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"export dtype must be bfloat16, float32 or int8, got {dtype!r}")
    leaves, cfg, meta = read_params(out_dir, name)
    if dtype == "bfloat16":
        leaves = [bf16_to_void(a) for a in leaves]
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
    """→ (state_dict on the CPU in the stored dtype, ViTConfig) from an export."""
    dest = Path(dest)
    meta = json.loads((dest / f"{name}.export.json").read_text())
    if meta.get("format") != EXPORT_FORMAT:
        raise ValueError(f"not an inference export: format={meta.get('format')!r}")
    if meta.get("dtype") == "int8":
        raise NotImplementedError("int8 exports are not ported yet (ROADMAP.md, 'int8 serving')")
    model_cfg = merge_dataclass(ViTConfig(), meta["model"])
    specs = flatten(param_tree(model_cfg))
    if meta["num_leaves"] != len(specs):
        raise ValueError(f"leaf count mismatch: the model has {len(specs)}, the export {meta['num_leaves']}")
    with np.load(dest / f"{name}.export.npz") as z:
        stored = [z[f"leaf_{i}"] for i in range(len(specs))]
    for (path, spec), a in zip(specs, stored):
        if a.shape != spec.shape or (a.dtype.kind == "V" and a.dtype.itemsize != 2):
            raise ValueError(f"export leaf {path} is {a.dtype} {a.shape}, expected {spec.shape}")
    return state_dict_of_leaves(stored, model_cfg), model_cfg


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
