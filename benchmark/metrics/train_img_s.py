"""Images the training step consumed in the window, all ranks, over the
window's wall time, which ends in a sync."""


def read(run):
    if "images" not in run.counters or run.window_s <= 0:
        return None
    return run.counters["images"] / run.window_s
