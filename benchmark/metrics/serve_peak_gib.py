"""Peak device memory allocated over the serving window (after a reset at
its start, every batch bucket warmed before it), in GiB: what one replica
of the service holds on its card."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
