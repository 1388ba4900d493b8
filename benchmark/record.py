"""The record of one run, which every metric reader reads."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from benchmark.trace import Trace


@dataclass
class Run:
    """What a traffic module's ``drive`` records.  Its counters hold at
    least ``attempted`` and ``failed`` (the result line's), ``rows`` (rows
    this rank ran on the device in the window) and ``rows_s`` (the wall
    seconds they ran in), and whatever its own readers read."""

    model: dict  # the configuration's model section
    workload: dict
    chips: int
    backward: bool = False  # each traced unit ran the backward as well as the forward
    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window on the host clock
    counters: dict = field(default_factory=dict)
    summary: str = ""  # one line for standard error: what the window did
    trace: Trace | None = None  # rank 0's traced stretch (``--trace 1``), the device's side only
    host_trace: Trace | None = None  # a further stretch with the host's operations
    peak_bytes: int = 0  # device memory peak over the window, the fullest chip


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0–100) of ``values``; a failed
    request is ``inf``, so it counts as missing every limit."""
    s = sorted(values)
    if not s:
        return math.inf
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]
