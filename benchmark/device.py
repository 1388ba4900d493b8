"""Device helpers that leave a CPU run (the harness's own tests) alone."""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    name, _, limit = (out[0] if out else "unknown, unknown").partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}


def stage(what: str, t_start: float) -> None:
    """Stderr: seconds since the run's start at a step of set-up."""
    print(f"setup {what}: {time.time() - t_start:.2f} s", file=sys.stderr, flush=True)
