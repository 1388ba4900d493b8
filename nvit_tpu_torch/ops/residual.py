"""The residual updates' CUDA kernels (``csrc/residual.cu``): launch
wrappers for the SLERP residual and ``norm_skip``, forward and backward.

They replace no TPU kernel: the JAX package computes both updates in jnp
under custom VJPs (nvit_tpu/core/residual.py).  The equations, the plain
twin and the ``autograd.Function``s that call these wrappers are in
``core/residual.py``; each kernel is one pass over the rows at the twin's
rounding points.

Each wrapper takes row-major contiguous CUDA tensors of width d, a multiple
of 8 up to 1024, in bf16 or fp32, and raises on anything else; it allocates
its outputs and the backward's scratch, launches on the current stream and
counts its calls in ``.launches``.  The parameter gradients (dα, d_skip)
are summed in a fixed order, without atomics: two calls give the same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_WIDTH = 1024  # 4 chunks of 256 values a row (csrc/residual.cu MAX_CHUNKS)
# rows of the backward's fp32 partials an SM may need: the most blocks of
# 128 threads an SM holds (its grid is the card's occupancy, at most this)
BLOCKS_PER_SM = 16
_IO = {torch.bfloat16: 1, torch.float32: 0}  # the C functions' is_bf16 flags
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # pointers and the stream as c_void_p, or ctypes cuts them to 32 bits
    "slerp_fwd": [_P] * 4 + [_I, _I, _F, _I, _P],
    "slerp_bwd": [_P] * 7 + [_I, _P, _I, _I, _F, _I, _P],
    "norm_skip_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "norm_skip_bwd": [_P] * 7 + [_I, _P] + [_I] * 4 + [_P],
}


def _rows_of(name: str, d: int, **xs: torch.Tensor) -> int:
    """Rows of the [..., d] tensors ``xs`` the kernels take → their count."""
    if d % 8 or not 0 < d <= MAX_WIDTH:
        raise ValueError(f"{name} takes a width that is a multiple of 8 up to {MAX_WIDTH}, got {d}")
    shape = None
    for arg, x in xs.items():
        if not x.is_cuda:
            raise ValueError(f"{name} launches a CUDA kernel: {arg} must be a CUDA tensor")
        if x.dtype not in _IO:
            raise ValueError(f"{name} takes bf16 or fp32 {arg}, got {x.dtype}")
        if shape is None:
            shape = x.shape
        if x.shape != shape or x.shape[-1] != d:
            raise ValueError(f"{name}: {arg} is {tuple(x.shape)}, expected {tuple(shape)} with width {d}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} takes row-major contiguous, 16-byte-aligned {arg}")
    rows = x.numel() // d
    if rows == 0:
        raise ValueError(f"{name} got no rows")
    return rows


def _check_one_dtype(name: str, h: torch.Tensor, **xs: torch.Tensor) -> None:
    for arg, x in xs.items():
        if x.dtype != h.dtype:
            raise ValueError(f"{name} takes {arg} in h's dtype {h.dtype}, got {x.dtype}")


def _check_param(name: str, arg: str, p: torch.Tensor, n: int, device: torch.device) -> None:
    if p.device != device or p.dtype != torch.float32 or tuple(p.shape) != (n,) or not p.is_contiguous():
        raise ValueError(f"{name} takes a contiguous fp32 {arg} of shape {(n,)} on {device}, got "
                         f"{p.dtype} {tuple(p.shape)} on {p.device}")
    if p.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte-aligned {arg}")


@functools.cache
def _function(name: str):
    from nvit_tpu_torch.ops._build import load_library

    fn = getattr(load_library("residual"), f"nvit_residual_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, *args) -> None:
    err = _function(name)(*args)
    if err != 0:
        raise RuntimeError(f"residual_{name} launch failed: cudaError {err}")


def _partials(x: torch.Tensor, d: int) -> tuple[torch.Tensor, int]:
    """fp32 scratch for the backward's per-block partial sums → (it, its rows)."""
    n = torch.cuda.get_device_properties(x.device).multi_processor_count * BLOCKS_PER_SM
    return torch.empty((n, d), dtype=torch.float32, device=x.device), n


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def slerp_fwd(h: torch.Tensor, h_update: torch.Tensor, alpha: torch.Tensor, c: float) -> torch.Tensor:
    """``N(a + lr·(b − a))``, a = N(h), b = N(h_update), lr = |α·c|: h and
    h_update [..., d] of one dtype, alpha fp32 [d] → out like h."""
    d = h.shape[-1]
    rows = _rows_of("residual_slerp_fwd", d, h=h, h_update=h_update)
    _check_one_dtype("residual_slerp_fwd", h, h_update=h_update)
    _check_param("residual_slerp_fwd", "alpha", alpha, d, h.device)
    out = torch.empty_like(h)
    _launch("slerp_fwd", h.data_ptr(), h_update.data_ptr(), alpha.data_ptr(), out.data_ptr(), rows, d, float(c),
            _IO[h.dtype], _stream(h))
    slerp_fwd.launches += 1
    return out


slerp_fwd.launches = 0


def slerp_bwd(
    h: torch.Tensor, h_update: torch.Tensor, alpha: torch.Tensor, c: float, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SLERP's backward from its saved inputs and g (like h) → (dh,
    dh_update like h, dα fp32 [d])."""
    d = h.shape[-1]
    rows = _rows_of("residual_slerp_bwd", d, h=h, h_update=h_update, g=g)
    _check_one_dtype("residual_slerp_bwd", h, h_update=h_update, g=g)
    _check_param("residual_slerp_bwd", "alpha", alpha, d, h.device)
    dh, dhu = torch.empty_like(h), torch.empty_like(h)
    d_alpha = torch.empty_like(alpha)
    partial, n = _partials(h, d)
    _launch("slerp_bwd", h.data_ptr(), h_update.data_ptr(), g.data_ptr(), alpha.data_ptr(), dh.data_ptr(),
            dhu.data_ptr(), partial.data_ptr(), n, d_alpha.data_ptr(), rows, d, float(c), _IO[h.dtype], _stream(h))
    slerp_bwd.launches += 1
    return dh, dhu, d_alpha


slerp_bwd.launches = 0


def norm_skip_fwd(h_new: torch.Tensor, h: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """``N(h_new·s + h)``: h_new and h [..., d], each bf16 or fp32, skip fp32
    [1] → out in their promoted dtype."""
    d = h.shape[-1]
    rows = _rows_of("residual_norm_skip_fwd", d, h_new=h_new, h=h)
    _check_param("residual_norm_skip_fwd", "skip", skip, 1, h.device)
    out = torch.empty(h.shape, dtype=torch.promote_types(h_new.dtype, h.dtype), device=h.device)
    _launch("norm_skip_fwd", h_new.data_ptr(), h.data_ptr(), skip.data_ptr(), out.data_ptr(), rows, d,
            _IO[h_new.dtype], _IO[h.dtype], _stream(h))
    norm_skip_fwd.launches += 1
    return out


norm_skip_fwd.launches = 0


def norm_skip_bwd(
    h_new: torch.Tensor, h: torch.Tensor, skip: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """norm_skip's backward from its saved inputs and g (in the promoted
    dtype) → (d_h_new like h_new, dh like h, d_skip fp32 [1])."""
    d = h.shape[-1]
    rows = _rows_of("residual_norm_skip_bwd", d, h_new=h_new, h=h, g=g)
    _check_param("residual_norm_skip_bwd", "skip", skip, 1, h.device)
    if g.dtype != torch.promote_types(h_new.dtype, h.dtype):
        raise ValueError(f"residual_norm_skip_bwd takes g in the output's dtype, got {g.dtype}")
    d_hnew, dh = torch.empty_like(h_new), torch.empty_like(h)
    d_skip = torch.empty_like(skip)
    partial, n = _partials(h, 1)
    _launch("norm_skip_bwd", h_new.data_ptr(), h.data_ptr(), g.data_ptr(), skip.data_ptr(), d_hnew.data_ptr(),
            dh.data_ptr(), partial.data_ptr(), n, d_skip.data_ptr(), rows, d, _IO[h_new.dtype], _IO[h.dtype],
            _stream(h))
    norm_skip_bwd.launches += 1
    return d_hnew, dh, d_skip


norm_skip_bwd.launches = 0
