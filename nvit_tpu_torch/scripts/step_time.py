"""Host-clock time of one training step on the card at full width: nViT-B/16
(``flagship_config()``), the baseline ViT-B/16 (``use_nvit=False``) and
path A (``bias=True``), batch 32, bf16, no remat, random weights from a
seed.

    python -m nvit_tpu_torch.scripts.step_time [--steps 5] [--rounds 2]

Per path: one state, two warm steps, then ``--rounds`` medians of
``--steps`` steps, each step ended by a device sync; prints the card's name
and power limit, one line per path, and one JSON line with the means.  To
compare two trees, run this file with each tree first on ``PYTHONPATH``, in
turns (parent, change, change, parent), in one call::

    PYTHONPATH=<tree> python nvit_tpu_torch/scripts/step_time.py

It uses only ``flagship_config``, ``create_train_state`` and
``make_train_step``, which every tree since the training slice has.
Refuses to run without a card.  ``chip_smoke.py`` times its steps with
this module's ``step_ms``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

PATHS = {"nvit": {}, "baseline": {"use_nvit": False}, "path A": {"bias": True}}


def sync_step(step, state, images, labels):
    """One training step, ended by a device sync → the step's output."""
    out = step(state, images, labels)
    torch.cuda.synchronize()
    return out


def step_ms(step, state, images, labels, n: int) -> float:
    """Median host-clock milliseconds of ``n`` synced steps."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        sync_step(step, state, images, labels)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_time: no CUDA device", file=sys.stderr)
        return 1
    import nvit_tpu_torch
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_train_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"tree: {nvit_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    out = {}
    for name, kw in PATHS.items():
        cfg = flagship_config(**kw)
        state = create_train_state(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        m = cfg.model
        images = torch.rand((cfg.training.batch_size, 3, m.image_size, m.image_size), generator=g,
                            device="cuda") * 2 - 1
        labels = torch.randint(0, m.num_classes, (cfg.training.batch_size,), generator=g, device="cuda")
        step = make_train_step(cfg, log_norms=False)
        step_ms(step, state, images, labels, 2)  # warm
        torch.cuda.reset_peak_memory_stats()
        runs = [step_ms(step, state, images, labels, args.steps) for _ in range(args.rounds)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[name] = {"ms": statistics.mean(runs), "runs": runs, "peak_gib": peak}
        print(f"{name}: {statistics.mean(runs):.3f} ms per step (medians of {args.steps}: "
              f"{', '.join(f'{x:.3f}' for x in runs)}), peak {peak:.3f} GiB [{smi}]", flush=True)
        del state, step, images, labels
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "steps": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
