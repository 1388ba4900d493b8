"""95th percentile of how late the load generator sent a request: the
client's send time less the request's due time."""

from benchmark.record import percentile


def read(run):
    if not run.counters.get("late_ms"):
        return None
    return percentile(run.counters["late_ms"], 95)
