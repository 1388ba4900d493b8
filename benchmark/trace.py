"""The device trace: ``torch.profiler`` over a stretch of the run, reduced to
what the per-layer readers read.

Kernel names are grouped as the program's ``obs/profile_step.py`` groups
them (a copy: the yardstick stays here), with NCCL's kernels a group of
their own.  Busy time is the union of the device's intervals (kernels,
copies, sets; the profiler's "Command Buffer Full" rows are waits and are
left out); an idle gap is named by the innermost host operation running at
its middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from benchmark.device import sync

GROUPS = {
    "K1/K5 qknorm_attn_fwd": ("qknorm_attn_fwd_kernel",),
    "K2/K5 qknorm_attn_bwd": ("qknorm_attn_bwd_",),
    "QK-norm projection prologue": ("qknorm_project_kernel",),
    "K3/K6 gated_mlp_fwd": ("gated_mlp_fwd_kernel",),
    "K4/K6 gated_mlp_bwd": ("gated_mlp_bwd_kernel",),
    "K7 flash_attn_fwd": ("flash_attn_fwd_kernel",),
    "K8/K9 flash_attn_bwd": ("flash_attn_bwd_",),
    "K8/K9 backward prologue": ("flash_project_kernel",),
    "NCCL collectives": ("nccl",),
    "cuBLAS GEMMs": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
}
PLAIN = "elementwise, reductions, copies"
ATTENTION = ("K1/K5 qknorm_attn_fwd", "K2/K5 qknorm_attn_bwd", "QK-norm projection prologue",
             "K7 flash_attn_fwd", "K8/K9 flash_attn_bwd", "K8/K9 backward prologue")
GATED_MLP = ("K3/K6 gated_mlp_fwd", "K4/K6 gated_mlp_bwd")


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS.items():
        if any(k in low for k in keys):
            return group
    return PLAIN


@dataclass
class Trace:
    """A traced stretch: ``units`` steps or forwards in ``window_s`` seconds
    of the host clock; device intervals as (start_us, end_us, name);
    host intervals as (start_us, end_us, name)."""

    window_s: float
    units: int
    device: list[tuple[float, float, str]] = field(default_factory=list)
    host: list[tuple[float, float, str]] = field(default_factory=list)
    rows: list[int] = field(default_factory=list)  # rows of each traced unit

    @property
    def kernels(self) -> list[tuple[float, float, str]]:
        return [e for e in self.device if not e[2].startswith(("Memcpy", "Memset"))]

    def group_s(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, name in self.device:
            g = group_of(name)
            out[g] = out.get(g, 0.0) + (e - s) / 1e6
        return out

    def busy_s(self) -> float:
        total, end = 0.0, None
        for s, e, _ in sorted(self.device):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, named: int = 500) -> list[list]:
        """Device-idle time between the first and the last device interval:
        the ``named`` longest gaps summed by the innermost host operation at
        each gap's middle, the shorter ones summed under one entry."""
        import numpy as np

        gaps: list[tuple[float, float]] = []  # (length_us, middle_us)
        end = None
        for s, e, _ in sorted(self.device):
            if end is not None and s > end:
                gaps.append((s - end, (s + end) / 2))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        by: dict[str, float] = {}
        for length, mid in gaps[:named]:
            inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if inside.size:
                name = self.host[int(inside[np.argmin(ends[inside] - starts[inside])])][2]
            else:
                name = "(no host operation)"
            by[name] = by.get(name, 0.0) + length / 1e6
        if len(gaps) > named:
            by[f"(gaps under {gaps[named - 1][0]:.1f} us)"] = sum(g[0] for g in gaps[named:]) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def warm_profiler(device: torch.device) -> None:
    """One short profiled op, so that the profiler's own start-up is paid in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Profile:
    """Start and stop around a stretch; ``trace()`` reduces what it recorded.
    With ``host`` the host's operations are recorded too, which slows the
    host: the device-side numbers come from a stretch without them, and the
    host operations only name the idle gaps."""

    def __init__(self, device: torch.device, host: bool = False):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
        if host or not activities:
            activities.append(ProfilerActivity.CPU)
        self._prof = profile(activities=activities)
        self._t0 = self._t1 = 0.0

    def start(self) -> None:
        sync(self.device)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        self._t1 = time.perf_counter()
        self._prof.stop()

    def trace(self, units: int, rows: list[int] | None = None) -> Trace:
        out = Trace(window_s=self._t1 - self._t0, units=units, rows=list(rows or []))
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self._prof.events():
            r = ev.time_range
            if ev.device_type == cuda:
                if "Command Buffer Full" not in ev.name and r.end > r.start:
                    out.device.append((float(r.start), float(r.end), ev.name))
            elif r.end > r.start:
                out.host.append((float(r.start), float(r.end), ev.name))
        return out
