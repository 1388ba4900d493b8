"""The reader of ``residual_ms.train`` on synthetic traces, on the CPU."""

from __future__ import annotations

import pytest

from benchmark.record import Run
from benchmark.spec import reader
from benchmark.trace import PLAIN, Trace, group_of


def run_of(device) -> Run:
    return Run(model={}, workload={}, chips=1, backward=True, trace=Trace(window_s=1e-3, units=2, device=device))


def test_counts_the_residual_kernels_only():
    """Two steps: 30 + 20 µs of residual kernels and 50 µs of others → 25 µs a step."""
    device = [(0.0, 30.0, "void (anonymous namespace)::residual_slerp_bwd<__nv_bfloat16, 3>(...)"),
              (40.0, 60.0, "void (anonymous namespace)::residual_colsum(float const*, int, int, ...)"),
              (60.0, 100.0, "void at::native::vectorized_elementwise_kernel<4, ...>"),
              (100.0, 110.0, "Memcpy DtoD (Device -> Device)")]
    assert reader("residual_ms.train")(run_of(device)) == pytest.approx(0.025)
    # the kernels stay in the plain chains' group, which plain_ops_ms.train reads
    assert group_of(device[0][2]) == group_of(device[1][2]) == PLAIN


def test_reads_nothing_without_them():
    assert reader("residual_ms.train")(run_of([(0.0, 50.0, "void at::native::reduce_kernel<512, 1>")])) is None
    assert reader("residual_ms.train")(Run(model={}, workload={}, chips=1)) is None
