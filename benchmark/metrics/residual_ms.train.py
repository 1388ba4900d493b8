"""Device ms per traced step of the residual updates' kernels (the program's
``csrc/residual.cu``: every kernel whose name holds ``residual_``).  None
where the trace holds none, as on a program that runs the updates as ATen
chains."""


def read(run):
    if run.trace is None or not run.trace.units:
        return None
    us = sum(e - s for s, e, name in run.trace.kernels if "residual_" in name)
    return 1e-3 * us / run.trace.units if us > 0 else None
