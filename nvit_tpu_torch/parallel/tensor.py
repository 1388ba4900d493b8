"""The collectives inside the forward and backward of a sharded trunk
(≙ what XLA's partitioner inserts for the ``model`` axis and the ``fsdp``
layout of nvit_tpu/parallel/mesh.py), as ``autograd.Function``s:

* ``enter_model`` (Megatron's f): the identity forward; the backward
  all-reduces the input's gradient over the model axis.  It goes in front
  of each column-parallel region (q/k/v, c_fc), whose input is replicated
  but whose rank computes only its heads' or columns' share of that
  input's gradient;
* ``reduce_model`` (Megatron's g): the forward all-reduces a row-parallel
  product's partial sums over the model axis (in their dtype: bf16 under
  bf16 compute); the backward is the identity;
* ``gather_data`` (FSDP): the forward all-gathers a weight's data-axis
  pieces (``all_gather_into_tensor``) into the model shard; the backward
  reduce-scatters its gradient (``reduce_scatter_tensor``), so each rank
  keeps the SUM of the data ranks' gradients of its piece.  The gathered
  weight lives as long as autograd keeps it; under ``system.remat`` the
  recompute gathers again, and so does every micro-batch.

``LocalShards`` runs one block's model shards in ONE process, each on its
own device (``Predictor(model_parallel=N)``): the partial products are
summed in shard order on the first shard's device, so every shard sees the
same bits, and the replicated stream is computed once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from nvit_tpu_torch.parallel.mesh import Axis

# reduce_scatter_tensor's newer name (the old one warns in new releases)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.axis.pg)
        return g, None


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=axis.pg)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        x = piece.movedim(dim, 0).contiguous()
        out = x.new_empty((axis.world * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=axis.pg)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0).contiguous()
        out = g.new_empty((g.shape[0] // ctx.axis.world, *g.shape[1:]))
        _reduce_scatter(out, g, group=ctx.axis.pg)
        return out.movedim(0, ctx.dim).contiguous(), None, None


def enter_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _EnterModel.apply(x, axis)


def reduce_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceModel.apply(x, axis)


def gather_data(piece: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return _GatherData.apply(piece, dim, axis)


class LocalShards(nn.Module):
    """One ``Block``'s model shards (``Block.shard_``), each on its own
    device, run in this process: the replicated stream on the first shard,
    each shard's partial products from it, summed in shard order."""

    def __init__(self, shards: list[nn.Module]):
        super().__init__()
        self.shards = nn.ModuleList(shards)

    @property
    def skip_param(self) -> torch.Tensor:
        return self.shards[0].skip_param

    def _sum(self, x: torch.Tensor, part: str, compute_dtype) -> torch.Tensor:
        total = None
        for s in self.shards:
            y = getattr(s, part)(x.to(s.skip_param.device), compute_dtype)
            total = y if total is None else total + y.to(total.device)
        return total

    def forward(self, h: torch.Tensor, *, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        first = self.shards[0]
        x = first.attn_input(h)
        h = first.attn_output(h, x, self._sum(x, "attn_partial", compute_dtype), compute_dtype)
        x = first.mlp_input(h)
        return first.mlp_output(h, x, self._sum(x, "mlp_partial", compute_dtype), compute_dtype)
