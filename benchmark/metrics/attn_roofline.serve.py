"""Σ bound of the traced attention calls (forward 4·B·H·T²·D operations,
backward 2.5 times it; ``flops.attention_fwd`` / ``attention_bwd``) over Σ
the device time of the attention kernels and their prologues, in %."""

from benchmark.readers import attention_roofline


def read(run):
    return attention_roofline(run)
