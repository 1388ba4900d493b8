"""Eval-cadence per-tensor gradient histograms (≙ nvit_tpu/obs/grad_hist.py,
≙ the reference's wandb.watch(gradients)).

Fixed log2-magnitude bins over a strided downsample of each gradient, taken
in the JAX leaf's element order (``ckpt.convert.jax_order``: linear
gradients as ``[in, out]``, the patch embeds fan-in first), so the kept
elements and the counts are the JAX package's.  Bin 0 counts |g| < 2^MIN_EXP
(exact zeros included); bins 1..62 one octave each, [2^(MIN_EXP+k-1),
2^(MIN_EXP+k)); bin 63 |g| ≥ 2^(MIN_EXP+62), ±inf and NaN.  The counts stay on
the device (int32[64] a tensor, no host sync) until the eval fetches them.
A rank that holds a piece of a tensor (``layout``, a sharded
``parallel/mesh.Mesh``) counts the elements of its piece that the WHOLE
tensor's downsample keeps, read by their indices in the JAX leaf, and the
counts are summed over the ranks that hold the pieces; a replicated tensor
is counted once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from nvit_tpu_torch.ckpt.convert import jax_order, jax_path
from nvit_tpu_torch.parallel.mesh import shard_dim
from nvit_tpu_torch.train.optim import jax_index

BINS = 64
MIN_EXP = -44  # fp32 gradients at a healthy scale sit around 2^-20..2^0
MAX_ELEMS = 65536  # per-tensor downsample cap (strided, deterministic)


def histogram_edges() -> np.ndarray:
    """The 65 static bin edges (for wandb.Histogram or plotting)."""
    return np.concatenate(
        [[0.0], np.exp2(np.arange(MIN_EXP, MIN_EXP + BINS - 1, dtype=np.float64)), [np.inf]])


def grad_histogram(g: torch.Tensor, max_elems: int = MAX_ELEMS, index: torch.Tensor | None = None,
                   numel: int | None = None) -> torch.Tensor:
    """int32[BINS] log2-magnitude histogram of ``g``'s flattened elements,
    every ceil(n / max_elems)-th of them when there are more.  With
    ``index`` (each element's index in a whole tensor of ``numel``
    elements) ``g`` is a piece of it, and the whole tensor's every k-th
    element is kept."""
    flat = g.reshape(-1)
    n = flat.shape[0] if numel is None else numel
    if n > max_elems:
        step = -(-n // max_elems)
        flat = flat[::step] if index is None else flat[index.reshape(-1) % step == 0]
    mag = flat.float().abs()
    # mag = m·2^e with m in [0.5, 1): floor(log2 mag) = e − 1 exactly, where
    # the JAX package's floor(log2) puts a few exact powers of two an octave
    # low (XLA's log2 is not exact there; ROADMAP.md §3)
    _, e = torch.frexp(mag)
    idx = torch.clamp(e.long() - MIN_EXP, 0, BINS - 1)
    idx = torch.where(mag < 2.0 ** MIN_EXP, 0, idx)
    # ±inf and NaN go to the explosion bin, never dropped
    idx = torch.where(torch.isfinite(mag), idx, BINS - 1)
    counts = torch.zeros(BINS, dtype=torch.int32, device=g.device)
    return counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


def tree_grad_histograms(grads: dict[str, torch.Tensor], local_patch: int,
                         layout=None) -> dict[str, torch.Tensor]:
    """{'gradhist/<dotted JAX path>': int32[BINS]} for every gradient, keyed
    as the JAX package keys its leaves (``blocks.0.c_fc.w``); ``layout``:
    the ``Mesh`` whose pieces the gradients are."""
    out, pieces = {}, []
    for name, g in grads.items():
        key = "gradhist/" + ".".join(map(str, jax_path(name)))
        if layout is None or shard_dim(name) is None:
            out[key] = grad_histogram(jax_order(name, g, local_patch))
            continue
        shape = layout.full_shape(name, g.shape)
        index = layout.take(name, jax_index(name, shape, local_patch, g.device))
        out[key] = grad_histogram(g, index=index, numel=math.prod(shape))
        pieces.append(key)
    if pieces:
        counts = torch.stack([out[k] for k in pieces])
        dist.all_reduce(counts, group=(layout.group if layout.fsdp else layout.model).pg)
        out.update(zip(pieces, counts))
    return out
