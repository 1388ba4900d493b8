"""Observability (≙ nvit_tpu/obs/metrics.py): console/logfile logging, the
JSONL metric sink with its wandb mirror, the nViT ``out/stat`` file, the step
timer with MFU, and device memory stats from ``torch.cuda``.

The wandb mirror (``wandb.mode`` online or offline) logs in with
``get_secret("WANDB_API_KEY")`` when online, and renders ``gradhist/*``
counts as ``wandb.Histogram``s over the static edges.  Where the package is
absent or its init fails, the writer logs one warning and keeps the JSONL
sink alone, as the JAX package's does.
"""

from __future__ import annotations

import json
import logging
import resource
import sys
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from nvit_tpu_torch.configs import Config, get_secret
from nvit_tpu_torch.models.blocks import (
    ATTN_ALPHA_INIT_VALUE,
    MLP_ALPHA_INIT_VALUE,
    SQK_INIT_VALUE,
    SUV_INIT_SCALING,
    SUV_INIT_VALUE,
)
from nvit_tpu_torch.obs.grad_hist import histogram_edges

# the gradhist edges with finite ends, as wandb needs them
_EDGES = histogram_edges()
WANDB_HIST_EDGES = np.concatenate([[0.0], _EDGES[1:-1], [_EDGES[-2] * 2]])


def setup_logging(out_dir: str | Path, *, level: str = "INFO", to_file: bool = True) -> logging.Logger:
    """Console + ``out_dir/training.log`` logging (≙ metrics.py:setup_logging)."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if to_file:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(Path(out_dir) / "training.log"))
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
    return logging.getLogger("nvit_tpu_torch")


class MetricsWriter:
    """Grouped metric logging to ``out_dir/metrics.jsonl``, one JSON object
    per call, mirrored to wandb when ``wandb_mode`` is online or offline and
    wandb starts (≙ metrics.py:MetricsWriter)."""

    def __init__(self, out_dir: str | Path, wandb_mode: str = "disabled", run_name: str = "nvit",
                 project: str = "nvit", config: dict | None = None):
        self.path = Path(out_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self.wandb = None
        if wandb_mode in ("online", "offline"):
            try:
                import wandb  # type: ignore

                api_key = get_secret("WANDB_API_KEY")
                if api_key and wandb_mode == "online":
                    wandb.login(key=api_key)
                wandb.init(mode=wandb_mode, project=project,
                           name=f"{run_name}_{time.strftime('%Y%m%d_%H%M%S')}", config=config or {})
                self.wandb = wandb
            except Exception as e:  # not installed, no network: the JSONL sink alone
                logging.getLogger("nvit_tpu_torch").warning(
                    "wandb unavailable (%s: %s); metrics go to %s", type(e).__name__, e, self.path)

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        clean = {k: (v.item() if hasattr(v, "item") else v) for k, v in metrics.items()}
        if step is not None:
            clean["_step"] = int(step)
        self._fh.write(json.dumps(clean) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            out = dict(metrics)
            for k, v in metrics.items():
                # gradhist/* are bin counts over the static log2 edges:
                # wandb histograms (≙ wandb.watch, train.py:531-546)
                if k.startswith("gradhist/"):
                    try:
                        out[k] = self.wandb.Histogram(
                            np_histogram=(np.asarray(v, dtype=np.int64), WANDB_HIST_EDGES))
                    except Exception:  # keep the raw list: the sink never breaks the run
                        pass
            self.wandb.log(out, step=step)

    def finish(self) -> None:
        self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()


def hparams_str(model: torch.nn.Module, cfg: Config) -> str:
    """Mean effective nViT scale parameters, per block (≙ metrics.py:hparams_str)."""
    if not cfg.model.use_nvit:
        return ""
    base = cfg.model.base_scale
    mean = lambda p: float(p.detach().float().mean())  # noqa: E731
    sz_eff = mean(model.sz) * (cfg.model.sz_init_value / cfg.model.sz_init_scaling)
    parts = [f"{sz_eff:.5f} "]
    for blk in model.transformer["h"]:
        sqk = mean(blk.sqk) * (SQK_INIT_VALUE / base)
        attn_alpha = mean(blk.attn_alpha) * (ATTN_ALPHA_INIT_VALUE / base)
        mlp_alpha = mean(blk.mlp_alpha) * (MLP_ALPHA_INIT_VALUE / base)
        suv = mean(blk.suv) * (SUV_INIT_VALUE / SUV_INIT_SCALING)
        parts.append(f"{sqk:.5f} {attn_alpha:.5f} {mlp_alpha:.5f} {suv:.5f} ")
    return "".join(parts)


def write_stat_line(
    out_dir: str | Path, *, iter_num: int, lr: float, train_loss: float, val_loss: float,
    model: torch.nn.Module, cfg: Config, append: bool = True,
) -> None:
    """One line of ``out_dir/stat`` (≙ metrics.py:write_stat_line)."""
    line = f"{iter_num:.6e} {lr:.4e} {train_loss:.4e} {val_loss:.4e} "
    line += "".join(f"{0.0:.4e} " for _ in range(9))
    line += hparams_str(model, cfg) + "\n"
    with open(Path(out_dir) / "stat", "a" if append else "w") as f:
        f.write(line)


def memory_stats(log_memory: bool = True, device: torch.device | None = None) -> dict[str, float]:
    """Host peak RSS and, on a CUDA device, the caching allocator's
    allocated / reserved / peak-allocated bytes in GiB."""
    if not log_memory:
        return {}
    stats = {"ram_peak_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}
    if device is not None and device.type == "cuda":
        i = device.index if device.index is not None else torch.cuda.current_device()
        stats[f"device_{i}/mem_allocated_gb"] = torch.cuda.memory_allocated(device) / 2**30
        stats[f"device_{i}/mem_reserved_gb"] = torch.cuda.memory_reserved(device) / 2**30
        stats[f"device_{i}/max_mem_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    return stats


class StepTimer:
    """Step time and MFU (≙ metrics.py:StepTimer).  ``peak_flops`` is the
    device's dense bf16 peak, or None where it is not known (the CPU): MFU
    is then None, never a number taken against another device's peak."""

    def __init__(self, flops_per_iter: float, peak_flops: float | None):
        self.flops_per_iter = flops_per_iter
        self.peak_flops = peak_flops
        self.t0 = time.perf_counter()

    def tick(self) -> tuple[float, float | None]:
        t1 = time.perf_counter()
        dt = t1 - self.t0
        self.t0 = t1
        if self.peak_flops is None or dt <= 0:
            return dt, None
        return dt, (self.flops_per_iter / dt) / self.peak_flops
