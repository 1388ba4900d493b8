"""Profiling and the NaN sanitizer (≙ nvit_tpu/obs/profiling.py).

* ``start_trace`` / ``stop_trace`` / ``maybe_trace``: a ``torch.profiler``
  trace (CPU activity, and CUDA activity on the card) written into
  ``<out_dir>/profile`` as ``<host>_<pid>.<ms>.pt.trace.json`` — the Chrome
  trace format, which Perfetto (ui.perfetto.dev) and TensorBoard's PyTorch
  profiler plugin (``tensorboard --logdir <out_dir>/profile``) open.  The
  Trainer traces steps [1, 1 + ``system.profile_steps``) (≙ the JAX
  trainer's ``jax.profiler`` window).
* ``span``: a named host range at a layer boundary of the program (the
  train step's forward / backward / reduce / update, the serving batcher's
  window, batch and forward, the Predictor's upload and readback; every
  name starts with ``nvit.``), recorded by whatever profiler runs: that
  trace, or a benchmark's traced stretch.
* ``check_finite``: the counterpart of ``jax_debug_nans`` under
  ``system.debug_nans`` — one host sync over a set of tensors, raising
  ``FloatingPointError`` that names the first non-finite one.  PyTorch has
  no counterpart of ``jax_disable_jit`` (it runs eagerly).
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Iterable

import torch
from torch._C._profiler import _RecordFunctionFast

logger = logging.getLogger("nvit_tpu_torch.obs")


def start_trace(out_dir: str | Path, device: torch.device) -> torch.profiler.profile:
    """A started profiler that writes its trace into ``<out_dir>/profile`` when stopped."""
    path = Path(out_dir) / "profile"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(str(path)))
    logger.info("capturing a torch.profiler trace to %s", path)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Stop ``prof`` and write its trace; the caller syncs on a value of
    the traced work first, so the trace holds all of it."""
    prof.stop()
    logger.info("trace written; open it in Perfetto or with tensorboard --logdir <out_dir>/profile")


@contextlib.contextmanager
def maybe_trace(out_dir: str | Path, enabled: bool, device: torch.device):
    """Trace the body into ``<out_dir>/profile`` when ``enabled``."""
    if not enabled:
        yield
        return
    prof = start_trace(out_dir, device)
    try:
        yield
    finally:
        stop_trace(prof)


def span(name: str) -> contextlib.AbstractContextManager:
    """A profiler range named ``name`` around a with-block, on the host only.

    A range of FUNCTION scope, as an ``autograd.Function``'s own, so the
    profiler records it as a CPU operation of the calling thread (all
    threads under ``profile_all_threads``) and makes no device-side
    annotation of it: the device's intervals stay the kernels, copies and
    sets alone.  ``torch.profiler.record_function`` opens a USER_SCOPE
    range instead, which a profiler that records the host's operations
    mirrors onto the device as a ``gpu_user_annotation`` interval from the
    range's first kernel to its last (torch 2.11 on an H100), filling the
    device's idle gaps inside it.  With no profiler running a span costs
    one check, ~0.5 µs; its times are the profiler's, on the clock of the
    device intervals."""
    return _RecordFunctionFast(name)


def check_finite(named: Iterable[tuple[str, torch.Tensor]]) -> None:
    """Raise ``FloatingPointError`` naming the first tensor that holds a NaN
    or an inf; one device-to-host transfer for all of them."""
    named = list(named)
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    for (name, _), ok in zip(named, finite):
        if not ok:
            raise FloatingPointError(f"non-finite values in {name} (system.debug_nans)")
