"""Rows the power-of-two padding adds, as a share of the requests' rows
over the window (the service's counters: padded_images / device_images − 1), in %."""


def read(run):
    if not run.counters.get("device_images"):
        return None
    return 100.0 * (run.counters["padded_images"] / run.counters["device_images"] - 1.0)
