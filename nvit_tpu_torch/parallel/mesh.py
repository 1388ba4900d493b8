"""Data parallelism across processes (≙ nvit_tpu/parallel/mesh.py, its
``data`` axis; the ``model`` axis and FSDP are not ported).

The JAX package runs one program over a mesh, and XLA's partitioner puts
the gradient all-reduce into it.  The port runs one process per card, as
the reference's ``torchrun`` did, and each process calls its kernels on its
own rows of the global batch (what ``shard_map`` did there).  What crosses
processes is here, on ``torch.distributed``:

* ``init_data_parallel`` forms the group from the launcher's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL for ``cuda``, gloo for ``cpu``, chosen by the
  device type and never on a failure, with a finite timeout (600 s unless
  the caller gives one).  The rank's card is
  ``cuda:{LOCAL_RANK}``.  Beside an NCCL group a gloo group carries the
  host's flags, so a flag never waits for the card;
* ``broadcast_`` puts rank 0's tensors on every rank (≙ ``shard_params``,
  DDP's initial parameter broadcast);
* ``all_reduce_mean_`` and ``all_reduce_sum_``: one flat fp32 buffer per
  call, reduced in place — the gradients (mean: every loss term is a
  per-sample mean, so the mean of equal per-rank means is the global
  mean) and the Hebbian deltas (sum: a delta is a batch sum);
* ``mean_metrics`` of a dict of host floats, ``broadcast_flag`` of rank 0's
  verdict and ``any_flag`` over ranks.

The gradients are reduced once a step, after the micro-batch loop (≙ JAX's
accumulation inside one program, the reference's ``no_sync``).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Iterable, Mapping

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# a collective that waits longer has lost a rank: it raises
DEFAULT_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class DataGroup:
    """The processes of one data-parallel run, as this process sees them."""

    rank: int
    world: int
    device: torch.device
    control: dist.ProcessGroup | None  # gloo, for host flags; None: the default group


def launcher_world() -> int:
    """``WORLD_SIZE`` of the launcher's environment (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _wrap(device: torch.device, timeout_s: float) -> DataGroup:
    control = None
    if dist.get_backend() != "gloo":  # a collective call: every rank makes it
        control = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
    return DataGroup(dist.get_rank(), dist.get_world_size(), device, control)


def init_data_parallel(device_type: str, *, backend: str | None = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """Form the group from the launcher's environment (every rank calls
    this): ``backend`` defaults to the device type's; the rank's device is
    ``cuda:{LOCAL_RANK}`` (made current) or the CPU."""
    if device_type not in BACKENDS:
        raise ValueError(f"no data-parallel backend for device type {device_type!r}")
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend=backend or BACKENDS[device_type], init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s))
    return _wrap(device, timeout_s)


def join_default_group(device: torch.device, *, timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """A ``DataGroup`` over a default group the caller formed (every rank
    calls this)."""
    return _wrap(torch.device(device), timeout_s)


def destroy(group: DataGroup) -> None:
    if group.control is not None:
        dist.destroy_process_group(group.control)
    dist.destroy_process_group()


def _through_flat(tensors: list[torch.Tensor], op, dtype: torch.dtype = torch.float32) -> None:
    """Copy ``tensors`` into one ``dtype`` buffer, run ``op`` on it in
    place, copy the result back."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])
    op(flat)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(group: DataGroup, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor ← its mean over ranks, in place (one all-reduce)."""
    def mean(flat):
        dist.all_reduce(flat)
        flat.div_(group.world)
    _through_flat(list(tensors), mean)


def all_reduce_sum_(group: DataGroup, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor ← its sum over ranks, in place (one all-reduce)."""
    _through_flat(list(tensors), dist.all_reduce)


def broadcast_(group: DataGroup, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor ← rank 0's, in place: one broadcast per dtype."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        _through_flat(ts, lambda flat: dist.broadcast(flat, src=0), dtype)


def mean_metrics(group: DataGroup, metrics: Mapping[str, float]) -> dict[str, float]:
    """The mean over ranks of each host float (float64, on the host)."""
    keys = sorted(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64)
    dist.all_reduce(values, group=group.control)
    return dict(zip(keys, (values / group.world).tolist()))


def broadcast_flag(group: DataGroup, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank."""
    value = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(value, src=0, group=group.control)
    return bool(value.item())


def any_flag(group: DataGroup, flag: bool) -> bool:
    """True on every rank when any rank's ``flag`` is."""
    value = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=group.control)
    return bool(value.item())
