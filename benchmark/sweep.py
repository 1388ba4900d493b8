"""Find a serving cell's knee: the open loop at each of several offered
rates, one window each, on the card.

    python3 -m benchmark.sweep --workload nvit-b16.serve --rates 300,400,500 --seconds 10

For each rate one JSON line: requests sent, the p50 / p95 / p99 latency,
the share of requests answered by the window's close, and the backlog's
trend (the median latency of the window's last fifth over its first
fifth).  Completions keep pace with arrivals where the trend stays near 1;
a growing backlog shows as a trend well above it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.traffic import serve
    from benchmark.record import percentile
    from benchmark.spec import load_cell

    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    base = load_cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell = dataclasses.replace(base, workload=dict(base.workload, rate_per_s=rate))
        run = serve.open_loop(cell, args.seed, args.seconds, False, device, time.time())[0]
        lat = np.array(run.counters["latency_ms"])
        fifth = max(1, len(lat) // 5)  # requests are indexed in due order
        sent = run.counters["attempted"]
        window_ms = run.window_s * 1e3
        due = serve.schedule(rate, args.seconds, args.seed) * 1e3
        done_by_close = float(np.mean(due + lat <= window_ms))
        print(json.dumps({
            "rate_per_s": rate, "requests": sent, "p50_ms": percentile(lat.tolist(), 50),
            "p95_ms": percentile(lat.tolist(), 95), "p99_ms": percentile(lat.tolist(), 99),
            "answered_by_close": done_by_close,
            "trend": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
            "rows_per_forward": run.counters["device_images"] / max(1, run.counters["device_programs"]),
            "late_p95_ms": percentile(run.counters["late_ms"], 95),
            "waited_for_client": run.counters["waited_for_client"], "missing": run.counters["failed"]}),
            flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
