"""Readers of the program's own spans in the host stretch (``run.host_trace``).

The port records a host span (``nvit_tpu_torch.obs.profiling.span``) at
each phase of its training step: ``nvit.step.forward`` and
``nvit.step.backward`` once per micro-batch, ``nvit.step.reduce`` around
the gradients' exchange, ``nvit.step.update`` around clip + AdamW + renorm.
They reach the host stretch's host operations on the profiler's clock,
the clock of its device intervals.  A program without them (an older
tree) gives these readers nothing, and each returns None.

The host stretch records every host operation, which slows the host, so
its idle time lies above the untraced window's: its readings compare two
trees' host stretches, never a window.
"""

from __future__ import annotations

import re

from benchmark.record import Run
from benchmark.trace import Trace

PREFIX = "nvit."
# kernel-launch calls of the CUDA runtime (cuda*) and of its lower-level cu* API (``_ptsz``-style suffixes too)
LAUNCH = re.compile(r"cu(da)?Launch(Cooperative)?Kernel(Ex|ExC)?(_\w+)?")
AGREE = 0.01  # launch calls and kernels may differ by this share of the kernels


def spans(trace: Trace) -> list[tuple[float, float, str]]:
    return [h for h in trace.host if h[2].startswith(PREFIX)]


def innermost(found: list[tuple[float, float, str]], t: float) -> str | None:
    """The name of the shortest span of ``found`` that holds time ``t``."""
    best = None
    for s, e, name in found:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def gaps(trace: Trace) -> list[tuple[float, float]]:
    """Every device-idle stretch between the union of the device intervals,
    from the first interval to the last, as (start_us, end_us)."""
    out: list[tuple[float, float]] = []
    end = None
    for s, e, _ in sorted(trace.device):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def idle_ms_per_unit(run: Run, name: str) -> float | None:
    """Device-idle ms per traced step whose gap's middle lies in span
    ``name`` (the innermost ``nvit.`` span there)."""
    trace = run.host_trace
    if trace is None or not trace.units or not trace.device:
        return None
    found = spans(trace)
    if not any(n == name for _, _, n in found):
        return None
    us = sum(e - s for s, e in gaps(trace) if innermost(found, (s + e) / 2) == name)
    return us / 1e3 / trace.units


def launches(trace: Trace) -> list[tuple[float, float, str]]:
    return [h for h in trace.host if LAUNCH.fullmatch(h[2])]


def launches_per_unit(run: Run, name: str) -> float | None:
    """Kernel-launch calls per traced step that start inside span ``name``;
    None where the stretch's launch calls and its kernels (copies and sets
    not counted) differ by more than ``AGREE``."""
    trace = run.host_trace
    if trace is None or not trace.units or not trace.kernels:
        return None
    found = [(s, e) for s, e, n in spans(trace) if n == name]
    calls = launches(trace)
    if not found or abs(len(calls) - len(trace.kernels)) > AGREE * len(trace.kernels):
        return None
    return sum(1 for s, _, _ in calls if any(a <= s <= b for a, b in found)) / trace.units
