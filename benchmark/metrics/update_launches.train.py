"""Kernel-launch calls per step of the host stretch (``cudaLaunchKernel``,
``cuLaunchKernel`` and their Ex forms, ``spans.LAUNCH``; copies and sets not counted, as in
``launches_per_step.train``) that start inside the program's
``nvit.step.update`` span: clip + AdamW + renorm.  The stretch records
every host operation; compare the reading parent against change only.
None where the program records no such span, or where the stretch's launch
calls and its kernels differ by more than 1%."""

from benchmark.spans import launches_per_unit


def read(run):
    return launches_per_unit(run, "nvit.step.update")
