"""Device-idle ms per step of the host stretch whose gap's middle lies in
the program's ``nvit.step.reduce`` span (``spans.idle_ms_per_unit``: every
gap between the device intervals, not only the longest).  The stretch
records every host operation, so the reading lies above the untraced
window's idle time: compare it parent against change only.  None where the
program records no such span."""

from benchmark.spans import idle_ms_per_unit


def read(run):
    return idle_ms_per_unit(run, "nvit.step.reduce")
