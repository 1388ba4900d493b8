"""The Kohonen self-organizing map (≙ nvit_tpu/som/kohonen.py): grid
geometry, the best-matching-unit (BMU) search and the batch Hebbian update.

* ``bmu``: ``argmin_n ‖x_i − node_n‖²`` through ‖n‖² − 2·x·nᵀ (‖x‖² is
  constant in the argmin).  The nodes are rounded to the activations' dtype
  and the product is taken in fp32 from those rounded operands, as JAX's
  ``preferred_element_type=float32`` product: a bf16 product would round
  the distances and move the argmin.  The representation is the gathered
  rounded node; its gradient is the one-hot product JAX differentiates —
  an fp32 sum per node of the cotangents, rounded once to the nodes'
  compute dtype — which a scatter-add would sum in bf16 and, on the card,
  in no fixed order.
* ``hebbian_delta``: Δ = lr·α·(K @ Σ_i e_{bmu_i} x_iᵀ − (K @ counts) ⊙ nodes)
  against the current nodes, with K the [N, N] torus neighbourhood table;
  no gradient.

The fp32 products run in full fp32 on the card whatever the process's TF32
setting.  They are dense products outside any TPU kernel, so they stay
``torch.matmul``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class KohonenSpec(NamedTuple):
    """Static SOM geometry."""

    num_nodes: int
    input_dim: int
    m: int
    n: int
    sigma: float
    alpha: float
    periodic: bool


def make_spec(input_dim: int, num_nodes: int, alpha: float = 0.01, sigma: float | None = None,
              periodic: bool = True) -> KohonenSpec:
    """m = isqrt(N), n = N // m, grid = m·n nodes (a non-square N drops
    nodes); σ defaults to sqrt(m·n)/2."""
    m = math.isqrt(num_nodes)
    n = num_nodes // m
    if sigma is None:
        sigma = math.sqrt(m * n) / 2.0
    return KohonenSpec(m * n, input_dim, m, n, float(sigma), float(alpha), periodic)


def grid_locations(spec: KohonenSpec) -> np.ndarray:
    """[N, 2] int64 (row, col) of each node, row-major."""
    return np.array([[i, j] for i in range(spec.m) for j in range(spec.n)], dtype=np.int64)


def wrap_offsets(spec: KohonenSpec) -> np.ndarray:
    """[8, 2] int64 periodic wrap offsets, in the reference's buffer order."""
    m, n = spec.m, spec.n
    return np.array([[-m, -n], [m, n], [-m, 0], [m, 0], [0, -n], [0, n], [-m, n], [m, -n]],
                    dtype=np.int64)


def _kernel_table(spec: KohonenSpec) -> np.ndarray:
    locs = grid_locations(spec).astype(np.float64)
    diff = locs[:, None, :] - locs[None, :, :]  # [N, N, 2]
    if spec.periodic:
        offsets = np.concatenate([np.zeros((1, 2)), wrap_offsets(spec)]).astype(np.float64)
        d2 = np.min(np.sum((diff[None] + offsets[:, None, None, :]) ** 2, axis=-1), axis=0)
    else:
        d2 = np.sum(diff**2, axis=-1)
    return np.exp(-d2 / (2.0 * spec.sigma * spec.sigma)).astype(np.float32)


@lru_cache(maxsize=16)
def _kernel_on(spec: KohonenSpec, device: str) -> torch.Tensor:
    return torch.from_numpy(_kernel_table(spec)).to(device)


def neighborhood_kernel(spec: KohonenSpec, device: torch.device | str = "cpu") -> torch.Tensor:
    """K[a, b] = exp(−d²(a, b) / 2σ²), fp32 [N, N], d the (torus) grid
    distance: a float64 table rounded once to fp32, built once per spec and
    device."""
    return _kernel_on(spec, str(torch.device(device)))


def init_nodes(spec: KohonenSpec, g: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """Standard-normal codebook [N, d] drawn from ``g``."""
    return torch.randn(spec.num_nodes, spec.input_dim, generator=g, device=device)


@contextmanager
def full_fp32_products(device: torch.device):
    """fp32 matmuls in full fp32 (no TF32) on the card for the block."""
    if device.type != "cuda" or not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def one_hot(indices: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 [S, n] one-hot rows of the flat ``indices`` [S], built by a
    scatter: ``F.one_hot`` and ``bincount`` read the indices back to the
    host on the card, which stalls the step's queue."""
    flat = indices.reshape(-1, 1)
    return torch.zeros(flat.shape[0], n, device=indices.device).scatter_(1, flat, 1.0)


class _GatherNodes(torch.autograd.Function):
    """``nodes_mm[indices]`` whose backward is the one-hot product: per node,
    the fp32 sum of its rows' cotangents, rounded once to nodes_mm's dtype."""

    @staticmethod
    def forward(ctx, nodes_mm, indices):
        ctx.save_for_backward(indices)
        ctx.n_nodes, ctx.dtype = nodes_mm.shape[0], nodes_mm.dtype
        return nodes_mm[indices]

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        flat = indices.reshape(-1)
        with full_fp32_products(grad.device):
            g = one_hot(flat, ctx.n_nodes).T @ grad.reshape(flat.numel(), -1).float()
        return g.to(ctx.dtype), None


def bmu(nodes: torch.Tensor, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., S, d], nodes [N, d] → (node representations [..., S, d] in
    x's dtype, indices [..., S] int64).  The gradient reaches ``nodes``
    through the representations."""
    nodes_mm = nodes.to(x.dtype)
    n32 = nodes_mm.float()
    with torch.no_grad(), full_fp32_products(x.device):
        cross = x.detach().float() @ n32.detach().T  # [..., S, N]
        nsq = torch.sum(n32.detach() * n32.detach(), dim=-1)
        indices = torch.argmin(nsq - 2.0 * cross, dim=-1)
    return _GatherNodes.apply(nodes_mm, indices), indices


@torch.no_grad()
def hebbian_delta(nodes: torch.Tensor, kernel: torch.Tensor, x: torch.Tensor, indices: torch.Tensor,
                  lr: torch.Tensor | float, alpha: float) -> torch.Tensor:
    """Δnodes [N, d] (fp32) = lr·α·(K @ xsum − (K @ counts) ⊙ nodes): xsum
    the fp32 sum of each node's inputs (in x's dtype), counts its exact BMU
    count.  ``lr`` may be a 0-d CPU tensor: it scales on the host's copy,
    with no transfer."""
    xs = x.reshape(-1, x.shape[-1])
    hot = one_hot(indices, nodes.shape[0])  # [S, N]
    with full_fp32_products(x.device):
        xsum = hot.T @ xs.float()  # [N, d]
        counts = hot.sum(dim=0)  # exact: integers below 2^24
        strength_x = kernel @ xsum
        strength_total = kernel @ counts
    delta = strength_x - strength_total[:, None] * nodes.float()
    return (lr * alpha) * delta


class KohonenMap(nn.Module):
    """One map: the ``nodes`` codebook and the reference's ``locations`` /
    ``offsets`` buffers (recomputed from the spec, never trained)."""

    def __init__(self, spec: KohonenSpec, *, device: torch.device | str):
        super().__init__()
        self.spec = spec
        self.nodes = nn.Parameter(torch.empty(spec.num_nodes, spec.input_dim, device=device))
        self.register_buffer("locations", torch.from_numpy(grid_locations(spec)).to(device))
        self.register_buffer("offsets", torch.from_numpy(wrap_offsets(spec)).to(device))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        self.nodes.copy_(init_nodes(self.spec, g, self.nodes.device))
