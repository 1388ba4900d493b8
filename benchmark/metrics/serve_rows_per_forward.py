"""Requests' rows per device forward over the window (the service's
counters: device_images / device_programs)."""


def read(run):
    if not run.counters.get("device_programs"):
        return None
    return run.counters["device_images"] / run.counters["device_programs"]
