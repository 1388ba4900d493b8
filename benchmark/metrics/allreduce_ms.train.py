"""Device ms per traced step of NCCL's kernels on rank 0: the step's
gradient all-reduce."""

from benchmark.readers import group_ms_per_unit


def read(run):
    return group_ms_per_unit(run, "NCCL collectives")
