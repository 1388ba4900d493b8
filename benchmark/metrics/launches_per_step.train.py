"""Kernel launches per traced step (copies and sets not counted)."""


def read(run):
    if run.trace is None or not run.trace.units or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.units
