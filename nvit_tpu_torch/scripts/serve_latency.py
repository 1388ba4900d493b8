"""Host-clock latency of one serving forward on the card: the median of many
``Predictor.predict_probs`` calls at one batch, nViT-B/16 as served.

    python -m nvit_tpu_torch.scripts.serve_latency [--batch 1] [--iters 400]

Builds ``preset("nvit-b16")`` with 1000 classes and random weights from a
seed, warms up, then times ``--iters`` forwards on the host clock.  Each
call ends in the host copy of the probabilities, so each is one request's
whole forward, Python and launches included: at batch 1 that is what bounds
it, not the card.  Prints the card's name and power limit, then one JSON
line with the median, the quartiles and the minimum in ms.  Two trees are
compared by running this file with each tree's ``nvit_tpu_torch`` first on
``PYTHONPATH``, in turns::

    PYTHONPATH=<tree> python nvit_tpu_torch/scripts/serve_latency.py

Refuses to run without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WARMUP = 20
SEED = 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=400)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_latency: no CUDA card", file=sys.stderr)
        return 1

    import nvit_tpu_torch
    from nvit_tpu_torch.configs import Config, ViTConfig
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import preset

    cfg = Config(model=ViTConfig(**preset("nvit-b16"), num_classes=1000))
    pred = Predictor.from_config(cfg, seed=SEED, device="cuda")
    size = cfg.model.image_size
    imgs = np.random.default_rng(SEED).integers(0, 256, (args.batch, 3, size, size), dtype=np.uint8)
    for _ in range(WARMUP):
        pred.predict_probs(imgs)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        pred.predict_probs(imgs)
        times.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = statistics.quantiles(times, n=4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"package": str(nvit_tpu_torch.__path__[0]), "batch": args.batch, "iters": args.iters,
                      "median_ms": med, "q1_ms": q1, "q3_ms": q3, "min_ms": min(times)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
