"""Σ bound of the traced gated-MLP calls (K3/K6 forward and K4/K6
backward: ``flops.gated_fwd`` / ``gated_bwd`` at c_fc and the
cross-attention's proj) over Σ their device time, in %."""

from benchmark.readers import mlp_roofline


def read(run):
    return mlp_roofline(run)
