"""Shared arithmetic of the metric readers (``metrics/<name>.py``): each
reader is one ``read(run)`` that returns its number, or None where the run
holds nothing for it to read (a share of a roofline or of a peak is never
reported as 0)."""

from __future__ import annotations

from benchmark import flops, trace
from benchmark.record import Run


def roofline_pct(run: Run, groups: tuple[str, ...], bound_of) -> float | None:
    """Σ bound over Σ device time of the traced calls in ``groups``, in %;
    ``bound_of(model, rows, backward)`` is a call's bound in seconds."""
    if run.trace is None or not run.trace.rows:
        return None
    device_s = sum(v for k, v in run.trace.group_s().items() if k in groups)
    if device_s <= 0:
        return None
    bound = sum(bound_of(run.model, rows, run.backward) for rows in run.trace.rows)
    return 100.0 * bound / device_s


def attention_roofline(run: Run) -> float | None:
    return roofline_pct(run, trace.ATTENTION, flops.attention_bound_s)


def mlp_roofline(run: Run) -> float | None:
    return roofline_pct(run, trace.GATED_MLP, flops.mlp_bound_s)


def idle_pct(run: Run) -> float | None:
    """The device's idle share of the untraced window, in %: the device's
    busy time per row as the trace reads it, times the rows the window ran,
    over the wall time they ran in.  The trace's own idle share would count
    the profiler's slowing of the host."""
    if run.trace is None or not run.trace.device or not run.trace.rows or not run.counters.get("rows_s"):
        return None
    per_row = run.trace.busy_s() / sum(run.trace.rows)
    return 100.0 * (1.0 - per_row * run.counters["rows"] / run.counters["rows_s"])


def group_ms_per_unit(run: Run, group: str) -> float | None:
    if run.trace is None or not run.trace.units:
        return None
    s = run.trace.group_s().get(group, 0.0)
    return 1e3 * s / run.trace.units if s > 0 else None
