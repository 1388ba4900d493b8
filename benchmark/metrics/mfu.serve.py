"""Model FLOPs of the images served in the window (real rows, not padding;
``flops.serve_flops_per_image``) over the host time of the device forwards
that served them and the chip's dense bf16 peak, in %."""

from benchmark import flops


def read(run):
    if not run.counters.get("forward_s"):
        return None
    rate = run.counters["device_images"] * flops.serve_flops_per_image(run.model) / run.counters["forward_s"]
    return 100.0 * rate / flops.PEAK_BF16_FLOPS
