"""Model FLOPs of the window's images (``flops.train_flops_per_image``,
counted from the configuration's shapes) over the window's wall time and
the chips' dense bf16 peak, in %."""

from benchmark import flops


def read(run):
    if "images" not in run.counters or run.window_s <= 0:
        return None
    rate = run.counters["images"] * flops.train_flops_per_image(run.model) / run.window_s
    return 100.0 * rate / (flops.PEAK_BF16_FLOPS * run.chips)
