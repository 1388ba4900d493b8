"""CUDA-event times of the gated-MLP kernels on the card: K3 and K4 (and K6,
both directions, with a bias) at the flagship's batch-32 shapes, beside
cuBLAS's bare [n, 2H] GEMM and the unfused chains.

    python -m nvit_tpu_torch.scripts.gated_mlp_bench [--batch 32] [--repeat 20]

Shapes (n = batch·784 rows): nViT-B/16's c_fc (K = 768, H = 3072) and
cross-attention ``proj`` (K = 768, H = 768), and nViT-L's c_fc (K = 1024,
H = 4096).  Inputs are random from a seed.  For each kernel it prints two
times: the median of ``--repeat`` single calls, each between two events
(what chip_smoke.py reports), and one event pair around ``--repeat``
back-to-back calls over their count (the wrapper's host time hidden behind
the card's work, as on the training step).  cuBLAS's GEMM computes [u | v]
without the gate: a yardstick of the product alone, not the same function.
The unfused chains are the ``gated_mlp_kernel="off"`` path's work: the GEMM
(+ bias), then the gate (forward) or its derivatives (backward) in bf16.

Prints the card's name and power limit, then one JSON line per shape with
every time in ms and the kernels' TFLOP/s over 4·n·K·H.  Two trees are
compared by running this file with each tree's ``nvit_tpu_torch`` first on
``PYTHONPATH``, in turns (parent, change, change, parent)::

    PYTHONPATH=<tree> python nvit_tpu_torch/scripts/gated_mlp_bench.py

Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

SEED = 0
WARMUP = 3
SHAPES = (("c_fc", 768, 3072), ("proj", 768, 768), ("nViT-L c_fc", 1024, 4096))  # (name, K, H)


def single_ms(fn, repeat: int) -> float:
    """Median of ``repeat`` calls, each timed alone between two events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeat):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, repeat: int) -> float:
    """One event pair around ``repeat`` back-to-back calls, over the count."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeat


def unfused_bwd(x, w, g, b=None):
    """The unfused chain's work for K4's function: the GEMM recompute of
    [u | v] (+ b), then the gate's backward in bf16 and the cat of du, dv."""
    uv = F.linear(x, w)
    u, v = torch.chunk(uv if b is None else uv + b, 2, dim=-1)
    sig = torch.sigmoid(v)
    return torch.cat([g * F.silu(v), (g * u) * (sig * (1 + v * (1 - sig)))], dim=-1)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--repeat", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gated_mlp_bench: no CUDA card", file=sys.stderr)
        return 1

    import nvit_tpu_torch
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_fwd, gated_mlp_xla

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    n = args.batch * 784
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for name, k, h in SHAPES:
        x = torch.randn(n, k, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(2 * h, k, generator=gen, device="cuda") / k ** 0.5).to(torch.bfloat16)
        b = (0.5 * torch.randn(2 * h, generator=gen, device="cuda")).to(torch.bfloat16)
        g = torch.randn(n, h, generator=gen, device="cuda").to(torch.bfloat16)
        calls = {
            "K3": lambda: gated_mlp_fwd(x, w), "K4": lambda: gated_mlp_bwd_duv(x, w, g),
            "K6": lambda: gated_mlp_fwd(x, w, b), "K6 backward": lambda: gated_mlp_bwd_duv(x, w, g, b),
            "cuBLAS GEMM": lambda: F.linear(x, w), "unfused forward": lambda: gated_mlp_xla(x, w),
            "unfused backward": lambda: unfused_bwd(x, w, g),
        }
        flops = 4 * n * k * h
        row = {"package": str(nvit_tpu_torch.__path__[0]), "shape": name, "n": n, "K": k, "H": h}
        for what, fn in calls.items():
            single, run = single_ms(fn, args.repeat), run_ms(fn, args.repeat)
            row[what] = {"ms": single, f"run{args.repeat}_ms": run, "tflops": flops / run / 1e9}
        print(json.dumps(row))
        del x, w, b, g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
