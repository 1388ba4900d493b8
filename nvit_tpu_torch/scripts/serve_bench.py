"""Serving throughput: dynamic batching against per-request dispatch
(≙ scripts/serve_bench.py).

N concurrent clients each issue single-image predictions through
``serve.InferenceService``, first with the batch window off (one device
forward per request), then on (concurrent requests coalesced into one
forward).  One JSON line per window: requests per second, p50 and p99
latency in ms, and the service's ``/stats`` snapshot.

    python -m nvit_tpu_torch.scripts.serve_bench                      # flagship, random weights
    python -m nvit_tpu_torch.scripts.serve_bench --checkpoint out --name checkpoint_best
    python -m nvit_tpu_torch.scripts.serve_bench --clients 32 --requests 8 --window-ms 3 [--int8]

Without ``--checkpoint`` the model is ``models.presets.flagship_config()``
with weights drawn from a seed.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import threading
import time

import numpy as np

from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.models.presets import flagship_config
from nvit_tpu_torch.serve import InferenceService


def bench(service: InferenceService, clients: int, requests: int, image_size: int) -> dict:
    """Every client's ``requests`` single-image predictions, after warming
    every batch bucket → requests/s, p50/p99 ms and the service's stats."""
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (1, 3, image_size, image_size), dtype=np.uint8) for _ in range(clients)]
    lat: list[float] = []
    lat_lock = threading.Lock()

    def client(i: int) -> None:
        for _ in range(requests):
            t0 = time.perf_counter()
            service.predict(imgs[i])
            dt = time.perf_counter() - t0
            with lat_lock:
                lat.append(dt)

    service.warmup(all_buckets=True)  # steady state: no first-seen shape while timing
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as ex:
        list(ex.map(client, range(clients)))
    wall = time.perf_counter() - t0
    lat.sort()
    n = clients * requests
    return {
        "requests_per_sec": round(n / wall, 2),
        "p50_ms": round(lat[n // 2] * 1e3, 2),
        "p99_ms": round(lat[min(n - 1, int(n * 0.99))] * 1e3, 2),
        "stats": service.stats.snapshot(),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir (default: flagship, random weights)")
    ap.add_argument("--name", default="checkpoint_best")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8, help="requests per client")
    ap.add_argument("--window-ms", type=float, default=3.0)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--int8", action="store_true", help="serve w8a8 (ops/quant.py)")
    ap.add_argument("--device", default="cuda", help="the card unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    quantize = "int8" if args.int8 else None
    if args.checkpoint:
        predictor = Predictor.from_checkpoint(args.checkpoint, args.name, device=args.device, quantize=quantize)
    else:
        predictor = Predictor.from_config(flagship_config(), device=args.device, quantize=quantize)

    lines = []
    for window in (0.0, args.window_ms):
        service = InferenceService(predictor, max_batch=args.max_batch, batch_window_ms=window)
        try:
            r = bench(service, args.clients, args.requests, predictor.cfg.image_size)
        finally:
            service.close()
        lines.append({"metric": "serve_requests_per_sec", "window_ms": window, "clients": args.clients, **r})
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
