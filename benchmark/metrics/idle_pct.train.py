"""The device's idle share of the untraced window: 1 − the busy time per
row read from the trace (per padded row when serving), times the rows the
window ran, over the wall time they ran in, in %."""

from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run)
