"""Peak device memory allocated over the training window (after a reset
at its start), on the fullest device, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
