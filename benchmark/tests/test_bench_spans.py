"""The readers of the program's step spans (``benchmark/spans.py`` and the
``idle_*_ms.train`` / ``update_launches.train`` metrics) on synthetic host
stretches whose answers are known by hand, on the CPU."""

from __future__ import annotations

import pytest

from benchmark.record import Run
from benchmark.spec import reader
from benchmark.trace import Trace


def stretch(spans: bool = True, launch_name: str = "cudaLaunchKernel", extra_launches: int = 0) -> Trace:
    """Two steps, times in µs.  Each step of 100 µs: forward [0, 30],
    backward [30, 70], update [70, 95], and a stretch in no span after it.

    Device intervals (one kernel each) leave these gaps in a step:
    5 µs at [10, 15] (forward), 4 at [40, 44] and 6 at [60, 66] (backward),
    2 at [71, 73] and 8 at [80, 88] (update), 3 at [96, 99] (no span);
    the 3 µs gap at [28, 31] has its middle, 29.5, in the forward.  One
    launch call starts at each kernel's start less 1 µs; the update's
    kernels are the three that start at 73, 88 and 90."""
    device, host = [], []
    for step in range(2):
        o = 100.0 * step
        kernels = [(0, 10), (15, 28), (31, 40), (44, 60), (66, 71), (73, 80), (88, 90), (90, 96), (99, 100)]
        if step == 1:
            kernels[-1] = (99, 99.5)  # the stretch ends on the last kernel
        device += [(o + s, o + e, f"kernel_{i}") for i, (s, e) in enumerate(kernels)]
        device.append((o + 16, o + 18, "Memcpy HtoD (Pageable -> Device)"))  # inside a kernel: no gap
        host += [(o + s - 1, o + s - 0.5, launch_name) for s, _ in kernels]
        host.append((o + 15.5, o + 16, "cudaMemcpyAsync"))
        host.append((o + 2, o + 8, "aten::mul"))
        if spans:
            host += [(o + 0, o + 30, "nvit.step.forward"), (o + 30, o + 70, "nvit.step.backward"),
                     (o + 70, o + 95, "nvit.step.update"), (o + 80, o + 85, "FusedAdamW")]
    host += [(250.0, 250.5, launch_name)] * extra_launches
    return Trace(window_s=200e-6, units=2, device=device, host=host)


def run_of(trace: Trace) -> Run:
    return Run(model={}, workload={}, chips=1, backward=True, host_trace=trace)


@pytest.mark.parametrize("metric,want", [
    ("idle_forward_ms.train", 8e-3),  # 5 + 3 µs a step
    ("idle_backward_ms.train", 10e-3),  # 4 + 6
    ("idle_update_ms.train", 10e-3),  # 2 + 8: the gap at [80, 88] lies in the update, not in FusedAdamW's
    ("update_launches.train", 3.0),
])
def test_readers_give_the_hand_counts(metric, want):
    assert reader(metric)(run_of(stretch())) == pytest.approx(want)
    # the cu* launch call is counted alike
    assert reader(metric)(run_of(stretch(launch_name="cuLaunchKernelEx"))) == pytest.approx(want)


def test_readers_read_nothing_without_the_programs_spans():
    for metric in ("idle_forward_ms.train", "idle_backward_ms.train", "idle_update_ms.train",
                   "idle_reduce_ms.train", "update_launches.train"):
        assert reader(metric)(run_of(stretch(spans=False))) is None
        assert reader(metric)(Run(model={}, workload={}, chips=1)) is None
    # a span the step did not run (no exchange on one card)
    assert reader("idle_reduce_ms.train")(run_of(stretch())) is None


def test_launch_count_must_agree_with_the_kernels():
    # 18 kernels: one call more is 5.6% off, so no reading; a stretch of
    # 200 kernels with one more call is within 1%
    assert reader("update_launches.train")(run_of(stretch(extra_launches=1))) is None
    assert reader("update_launches.train")(run_of(stretch(launch_name="cudaGraphLaunch"))) is None
    big = stretch()
    big.device += [(1000.0 + 2 * i, 1001.0 + 2 * i, "k") for i in range(182)]
    big.host += [(999.5 + 2 * i, 999.8 + 2 * i, "cudaLaunchKernel") for i in range(182)]
    assert reader("update_launches.train")(run_of(big)) == 3.0
    big.host.append((5000.0, 5000.5, "cudaLaunchKernelExC"))
    assert reader("update_launches.train")(run_of(big)) == 3.0
