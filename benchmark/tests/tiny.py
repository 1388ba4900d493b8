"""Cells cut to a size a CPU test can run: the cell's own files, with the
model at the ``nvit-tiny4`` preset's sizes and the traffic shrunk alike."""

from __future__ import annotations

import dataclasses

from benchmark.spec import Cell, load_cell

TINY_MODEL = dict(image_size=32, n_layer=4, n_head=4, n_embd=128, local_patch_size=4, global_patch_size=8,
                  num_classes=10)


def tiny_cell(name: str, fp32: bool = False) -> Cell:
    """``fp32``: the program computes in float32, so that a sound run reads
    far under limits that were set for bf16 at full size."""
    cell = load_cell(name)
    config = dict(cell.config, model=dict(cell.config["model"], **TINY_MODEL))
    if fp32:
        config["system"] = dict(config["system"], use_amp=False)
    w = dict(cell.workload)
    if w["kind"] == "train":
        w.update(batch_per_rank=8, pool_batches=4, reference_rows=4, trace_steps=2, host_trace_steps=1)
    else:
        w.update(rate_per_s=50.0, pool_images=16, check_sample=8, clients=16, max_batch=8, trace_seconds=0.1)
    return dataclasses.replace(cell, workload=w, config=config)
