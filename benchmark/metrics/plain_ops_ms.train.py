"""Device ms per traced step outside the program's kernels, cuBLAS and
NCCL: the elementwise chains, reductions, casts and copies."""

from benchmark.readers import group_ms_per_unit
from benchmark.trace import PLAIN


def read(run):
    return group_ms_per_unit(run, PLAIN)
