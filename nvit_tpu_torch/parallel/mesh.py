"""Data parallelism, tensor parallelism and FSDP across processes
(≙ nvit_tpu/parallel/mesh.py: its ``data`` and ``model`` axes and its
``fsdp`` layout).

The JAX package runs one program over a mesh, and XLA's partitioner puts
the collectives into it.  The port runs one process per card, as the
reference's ``torchrun`` did, and each process calls its kernels on its own
share of the work (what ``shard_map`` did there).  What crosses processes
is here, on ``torch.distributed``:

* ``init_data_parallel`` forms the group from the launcher's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL for ``cuda``, gloo for ``cpu``, chosen by the
  device type and never on a failure, with a finite timeout (600 s unless
  the caller gives one).  The rank's card is
  ``cuda:{LOCAL_RANK}``.  Beside an NCCL group a gloo group carries the
  host's flags, so a flag never waits for the card;
* ``make_mesh`` carves the data × model grid out of that world (≙
  ``make_mesh``'s ``reshape(n // mp, mp)``): rank r is (data r // M, model
  r % M), so a model group is M consecutive ranks.  Every rank makes every
  ``new_group`` call, in one order: one model group per data index, then
  one data group per model index;
* the layout (≙ ``block_param_specs`` / ``param_specs``), in the ``[out,
  in]`` layout: ``query``, ``key``, ``value`` and ``c_fc`` shard dim 0 with
  their biases; ``att_c_proj`` and ``mlp_c_proj`` shard dim 1 and keep
  their biases whole; everything else is replicated.  These are the axes
  the renorm does not normalize (``ops/renorm.py``), so the in-step renorm
  stays local.  One difference from JAX's contiguous column shard: model
  rank m holds c_fc's u rows m·4d/M … (m+1)·4d/M − 1 AND the same rows of
  v, stored as one ``[2·4d/M, d]`` matrix (``split``'s ``pairs=2``), so the
  gated kernels compute u·SiLU(v) on the rank's columns with no collective.
  Under FSDP (``system.fsdp`` over several data ranks, ≙ ``P(None,
  ("model", "data"))``) each model shard is cut again, contiguously, over
  the data axis, and the AdamW moments are sharded as their parameters;
* ``broadcast_`` puts rank 0's tensors on every rank (≙ ``shard_params``,
  DDP's initial parameter broadcast);
* ``all_reduce_mean_`` and ``all_reduce_sum_``: one flat fp32 buffer per
  call, reduced in place over a group — the gradients (mean over the data
  axis: every loss term is a per-sample mean, so the mean of equal per-rank
  means is the global mean), the Hebbian deltas (sum over the data axis: a
  delta is a batch sum) and ``sqk``/``suv``'s gradients (sum over the model
  axis: each rank reads its heads' and columns' slice of them);
* ``Mesh.global_norms``: norms of whole tensors from the shards (the sum of
  squares over the axes a tensor is cut along, one copy of a replicated
  one), and ``Mesh.gather``: a whole tensor from the shards, on every rank;
* ``mean_metrics`` of a dict of host floats, ``broadcast_flag`` of rank 0's
  verdict and ``any_flag`` over ranks.

The gradients are reduced once a step, after the micro-batch loop (≙ JAX's
accumulation inside one program, the reference's ``no_sync``); the model
axis's collectives run inside the forward and backward
(``parallel/tensor.py``).
"""

from __future__ import annotations

import datetime
import os
import re
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
    timeout_s: float = DEFAULT_TIMEOUT_S
    pg = None  # its collectives run on the default group


def launcher_world() -> int:
    """``WORLD_SIZE`` of the launcher's environment (1 without one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def _wrap(device: torch.device, timeout_s: float) -> DataGroup:
    control = None
    if dist.get_backend() != "gloo":  # a collective call: every rank makes it
        control = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))
    return DataGroup(dist.get_rank(), dist.get_world_size(), device, control, timeout_s)


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


def all_reduce_mean_(group: DataGroup | Axis, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor ← its mean over the group's ranks, in place (one all-reduce)."""
    def mean(flat):
        dist.all_reduce(flat, group=group.pg)
        flat.div_(group.world)
    _through_flat(list(tensors), mean)


def all_reduce_sum_(group: DataGroup | Axis, tensors: Iterable[torch.Tensor]) -> None:
    """Each tensor ← its sum over the group's ranks, in place (one all-reduce)."""
    _through_flat(list(tensors), lambda flat: dist.all_reduce(flat, group=group.pg))


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


# --------------------------------------------------------- the data × model grid
@dataclass(frozen=True)
class Axis:
    """One axis of the grid as this rank sees it: its index on the axis, the
    axis's size and the process group of the ranks along it (None: the
    default group; no collective runs on an axis of size 1)."""

    rank: int
    world: int
    pg: dist.ProcessGroup | None = None


COLUMN_PARALLEL = ("query", "key", "value", "c_fc")  # shard dim 0, their biases too
ROW_PARALLEL = ("att_c_proj", "mlp_c_proj")  # shard dim 1, their biases whole
_TRUNK = re.compile(r"^transformer\.h\.\d+\.(.+)$")


def block_dim(name: str) -> int | None:
    """The sharded dim of a ``Block`` parameter (its own name), None for a
    replicated one: column-parallel q/k/v/c_fc shard their OUT axis (dim 0)
    and their biases; the row-parallel output projections their IN axis
    (dim 1), their biases replicated; the scale vectors replicated."""
    module, _, attr = name.rpartition(".")
    if module in COLUMN_PARALLEL:
        return 0
    return 1 if module in ROW_PARALLEL and attr == "weight" else None


def block_param_specs(use_nvit: bool, bias: bool) -> dict[str, int | None]:
    """``block_dim`` of each parameter of one ``Block`` (≙
    mesh.py:block_param_specs, in the ``[out, in]`` layout)."""
    names = [f"{n}.weight" for n in (*COLUMN_PARALLEL, *ROW_PARALLEL)]
    if bias:
        names += [f"{n}.bias" for n in (*COLUMN_PARALLEL, *ROW_PARALLEL)]
    names += ["skip_param", *(("attn_alpha", "mlp_alpha", "sqk", "suv") if use_nvit else
                              ("rmsnorm_att.weight", "rmsnorm_mlp.weight"))]
    return {n: block_dim(n) for n in names}


def shard_dim(name: str) -> int | None:
    """The sharded dim of the ``ViT`` parameter (or buffer) ``name``; None
    outside the transformer trunk (≙ param_specs: the patch embeds, the SOM,
    the heads and the cross-attention are replicated)."""
    m = _TRUNK.match(name)
    return None if m is None else block_dim(m.group(1))


def param_specs(named: Iterable[tuple[str, torch.Tensor]]) -> dict[str, int | None]:
    """``{name: shard_dim(name)}`` over ``named`` (``model.named_parameters()``)."""
    return {name: shard_dim(name) for name, _ in named}


def pairs_of(name: str) -> int:
    """2 for c_fc's weight and bias, whose dim 0 is the u and v halves: a
    model shard takes matching rows of both; 1 otherwise."""
    return 2 if name.rpartition(".")[0].endswith("c_fc") else 1


def split(x: torch.Tensor, dim: int, index: int, count: int, pairs: int = 1) -> torch.Tensor:
    """Piece ``index`` of ``count`` of ``x`` along ``dim``: contiguous, or
    with ``pairs`` = 2 the same piece of each half, stacked."""
    n = x.shape[dim] // pairs
    if n % count:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} ({pairs} × {n}) does not divide into {count} shards")
    c = n // count
    if pairs == 1:
        return x.narrow(dim, index * c, c)
    return torch.cat([x.narrow(dim, h * n + index * c, c) for h in range(pairs)], dim=dim)


@dataclass(frozen=True)
class Mesh:
    """The data × model grid of a run, as this rank sees it.  ``fsdp``:
    the trunk's shards are cut again over the data axis (it has > 1 rank)."""

    group: DataGroup
    data: Axis
    model: Axis
    fsdp: bool = False

    @property
    def sharded(self) -> bool:
        """Whether any parameter is held in pieces."""
        return self.model.world > 1 or self.fsdp

    def take(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``full`` of parameter
        ``name`` (a parameter, a moment, a gradient, an index tensor)."""
        dim = shard_dim(name)
        if dim is None or not self.sharded:
            return full
        x = split(full, dim, self.model.rank, self.model.world, pairs_of(name))
        if self.fsdp:
            x = split(x, dim, self.data.rank, self.data.world)
        return x.clone(memory_format=torch.contiguous_format)  # not a view that keeps ``full`` alive

    def full_shape(self, name: str, shape) -> tuple[int, ...]:
        """The whole tensor's shape of this rank's piece's ``shape``."""
        dim = shard_dim(name)
        shape = list(shape)
        if dim is not None:
            shape[dim] *= self.model.world * (self.data.world if self.fsdp else 1)
        return tuple(shape)

    def gather(self, name: str, piece: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's piece, on every rank (every
        rank calls this, for the same names in one order).  Bit-exact: the
        pieces' bits are summed as integers into a zero buffer, so this runs
        on any backend's all-reduce, gloo's on CUDA tensors included."""
        if shard_dim(name) is None or not self.sharded:
            return piece
        bits = {4: torch.int32, 2: torch.int16}[piece.element_size()]
        shape = self.full_shape(name, piece.shape)
        buf = torch.zeros(shape, dtype=torch.int32, device=piece.device)
        # a TP shard is held by every data rank alike: the first contributes it
        if self.fsdp or self.data.rank == 0:
            where = self.take(name, torch.arange(buf.numel(), device=piece.device).view(shape))
            buf.view(-1)[where.reshape(-1)] = piece.contiguous().view(bits).reshape(-1).to(torch.int32)
        dist.all_reduce(buf, group=self.group.pg)
        return buf.to(bits).view(piece.dtype)

    def global_norms(self, groups: list[Iterable[tuple[str, torch.Tensor]]]) -> list[torch.Tensor]:
        """sqrt(Σ x²) of each group's WHOLE tensors, on every rank alike:
        per group the replicated tensors' sum once, the TP shards' summed
        over the model axis and the FSDP shards' over every rank (two
        all-reduces for all the groups)."""
        rows = []
        for named in groups:
            parts = [[], [], []]  # replicated, model shards, model × data shards
            for name, t in named:
                kind = 0 if shard_dim(name) is None else 2 if self.fsdp else 1
                parts[kind].append(torch.sum(torch.square(t.float())))
            rows.append([sum(p) if p else torch.zeros((), device=self.group.device) for p in parts])
        table = torch.stack([torch.stack([torch.as_tensor(x, device=self.group.device) for x in r])
                             for r in rows])
        if self.model.world > 1:
            col = table[:, 1].contiguous()
            dist.all_reduce(col, group=self.model.pg)
            table[:, 1] = col
        if self.fsdp:
            col = table[:, 2].contiguous()
            dist.all_reduce(col, group=self.group.pg)
            table[:, 2] = col
        return [torch.sqrt(r[0] + r[1] + r[2]) for r in table]


def data_mesh(group: DataGroup) -> Mesh:
    """The grid of a data-parallel run: every rank a data rank."""
    return Mesh(group, Axis(group.rank, group.world), Axis(0, 1))


def make_mesh(group: DataGroup, model_parallel: int = 1, fsdp: bool = False) -> Mesh:
    """The data × model grid over ``group``'s ranks (every rank calls this):
    rank r is (data r // M, model r % M) (≙ mesh.py:make_mesh).  ``fsdp``
    holds only with more than one data rank."""
    n, mp = group.world, model_parallel
    if mp < 1:
        raise ValueError(f"model_parallel must be >= 1, got {mp}")
    if n % mp:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    dp = n // mp
    d, m = divmod(group.rank, mp)
    timeout = datetime.timedelta(seconds=group.timeout_s)
    model_pg = data_pg = None
    if mp > 1 and dp > 1:  # every rank makes every call, in this order
        for i in range(dp):
            pg = dist.new_group([i * mp + j for j in range(mp)], timeout=timeout)
            model_pg = pg if i == d else model_pg
        for j in range(mp):
            pg = dist.new_group([i * mp + j for i in range(dp)], timeout=timeout)
            data_pg = pg if j == m else data_pg
    # an axis spanning every rank runs on the default group
    return Mesh(group, Axis(d, dp, data_pg), Axis(m, mp, model_pg), fsdp=fsdp and dp > 1)
