"""95th percentile of the latency of every request of the window, from its
due time to its returned result; a failed request counts as missing.  Read
per layer: at the cell's rate the batcher flips between its 32- and 64-row
padded regimes with the host's speed, and the tail with it."""

from benchmark.record import percentile


def read(run):
    if "latency_ms" not in run.counters:
        return None
    return percentile(run.counters["latency_ms"], 95)
