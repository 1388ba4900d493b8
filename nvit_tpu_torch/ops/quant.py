"""Int8 w8a8 serving (≙ nvit_tpu/ops/quant.py).

* Weights: symmetric per-output-channel int8, ``w ≈ wq · scale``; in the
  port's ``[out, in]`` layout ``wq`` is int8 ``[out, in]`` and ``scale`` fp32
  ``[out]`` = ``max(max|w[j, :]|, 1e-12) / 127``.
* Activations: dynamic symmetric per-token int8, ``x ≈ xq · sx`` with
  ``sx = max(max|x|, 1e-8) / 127`` along the last axis.
* ``/ 127`` is the product with fp32(1/127), as XLA compiles it
  (``INV_127``), so scales and codes equal the JAX package's jitted ones.
* The product is int8 × int8 → int32 (``torch._int_mm``: cuBLASLt on the
  card), as the JAX package leaves it to ``lax.dot_general`` outside any
  Pallas kernel; the epilogue is ``acc · (sx · scale)`` in fp32, then the
  fp32 bias, then a cast to x's dtype.  Rounding is JAX's: half to even,
  clipped to ±127.

``quantize_vit`` replaces every linear of a ``ViT`` named in the three lists
(the patch embeds, heads, block and cross-attention projections) by a
``QuantLinear``; norms, scale vectors, position embeddings and the SOM's
nodes stay fp32.  ``int8_skeleton`` builds the same structure empty, to load
an int8 export into.  Training never sees quantized parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

# the block and cross-attention linears that quantize (≙ quant.py:51-52;
# the top ones, quant.py:50, are _sites' four modules)
BLOCK_LINEARS = ("query", "key", "value", "att_c_proj", "c_fc", "mlp_c_proj")
CROSS_LINEARS = ("q_local", "k_global", "v_global", "proj", "out_proj")

# ``/ 127`` as the JAX package's compiled programs compute it: XLA turns a
# division by a constant into a product with its fp32 reciprocal, which its
# eager ops do not (ROADMAP.md §3); the value is exact in fp32
INV_127 = 0.007874015718698502  # float32(1 / 127)

# cuBLASLt's int8 GEMM wants more than 16 rows and K, N divisible by 8
_MIN_ROWS = 17
_ALIGN = 8


class QuantParams(NamedTuple):
    """A quantized linear's weight: int8 ``wq [out, in]`` and fp32 ``scale [out]``
    (≙ the ``{"wq", "scale"}`` leaves).  ``core.layers.linear`` dispatches on it."""

    wq: torch.Tensor
    scale: torch.Tensor


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w [out, in] → (wq int8 [out, in], scale fp32 [out]) (≙ quantize_weight)."""
    w = w.float()
    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=1), 1e-12) * INV_127
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return wq, scale


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] → (xq int8 [..., K], sx fp32 [..., 1]) (≙ quantize_activations)."""
    x32 = x.float()
    sx = torch.clamp_min(torch.amax(torch.abs(x32), dim=-1, keepdim=True), 1e-8) * INV_127
    xq = torch.clamp(torch.round(x32 / sx), -127, 127).to(torch.int8)
    return xq, sx


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    if x.shape[dim] == size:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, size - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq int8 [n, K] · wq int8 [N, K]ᵀ → int32 [n, N], exact.  On the card
    ``torch._int_mm`` takes wqᵀ column-major as it lies; rows are padded with
    zeros past 16 and K, N to multiples of 8 where the shapes miss its rules
    (zeros change no sum), and the result is sliced back."""
    n, k = xq.shape
    out = wq.shape[0]
    if not xq.is_cuda:
        return torch._int_mm(xq, wq.t())
    rows = max(n, _MIN_ROWS)
    kp, op = -(-k // _ALIGN) * _ALIGN, -(-out // _ALIGN) * _ALIGN
    acc = torch._int_mm(_pad_to(_pad_to(xq, 0, rows), 1, kp), _pad_to(_pad_to(wq, 0, op), 1, kp).t())
    return acc[:n, :out]


def quantized_linear(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """``x wᵀ (+ b)`` with int8 weights and per-token int8 activations
    (≙ quantized_linear) → x's shape with N features, in x's dtype."""
    *lead, k = x.shape
    xq, sx = quantize_activations(x.reshape(-1, k))
    y = int8_matmul(xq, wq).float() * (sx * scale)
    if b is not None:
        y = y + b
    return y.to(x.dtype).reshape(*lead, wq.shape[0])


class QuantLinear(nn.Module):
    """An int8 linear: buffers ``wq`` int8 [out, in], ``scale`` fp32 [out] and
    ``b`` fp32 [out] (or none), in the consumption layout of the module it
    replaces (a patch embed's fan-in in its forward's order).  ``weight`` and
    ``bias`` are what the model's forwards pass to ``core.layers.linear``."""

    def __init__(self, wq: torch.Tensor, scale: torch.Tensor, b: torch.Tensor | None):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("scale", scale)
        self.register_buffer("b", b)

    @property
    def weight(self) -> QuantParams:
        return QuantParams(self.wq, self.scale)

    @property
    def bias(self) -> torch.Tensor | None:
        return self.b


# the Sequential members that hold a top linear
_SEQ_INDEX = {"global_patch_embed": 1, "reconstruction_head": 0, "mlp_head": 1}


def _get(owner: nn.Module, name: str) -> nn.Module:
    m = getattr(owner, name)
    return m[_SEQ_INDEX[name]] if name in _SEQ_INDEX else m


def _set(owner: nn.Module, name: str, q: QuantLinear) -> None:
    if name in _SEQ_INDEX:
        getattr(owner, name)[_SEQ_INDEX[name]] = q
    else:
        setattr(owner, name, q)


def _float_linear(model, owner: nn.Module, name: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(w [out, in] in the forward's fan-in order, b) of a float linear or
    patch-embedding conv."""
    m = _get(owner, name)
    w = m.weight
    if name in ("local_patch_embed", "global_patch_embed"):
        w = w.reshape(w.shape[0], -1)
    if name == "global_patch_embed":
        w = w[:, model.global_embed_perm]
    return w, m.bias


def _sites(model) -> list[tuple[nn.Module, str]]:
    """(owner, attribute) of every quantizable linear of a ``ViT``."""
    sites = [(model, "local_patch_embed"), (model, "global_patch_embed"),
             (model, "reconstruction_head"), (model, "mlp_head")]
    sites += [(model.cross_attention, n) for n in CROSS_LINEARS]
    sites += [(blk, n) for blk in model.transformer["h"] for n in BLOCK_LINEARS]
    return [(o, n) for o, n in sites if not isinstance(_get(o, n), QuantLinear)]


@torch.no_grad()
def quantize_vit(model):
    """Quantize every linear of ``model`` (a ``ViT``) in place → model
    (≙ quantize_vit_params).  Idempotent: an int8 linear stays as it is."""
    for owner, name in _sites(model):
        w, b = _float_linear(model, owner, name)
        wq, scale = quantize_weight(w)
        _set(owner, name, QuantLinear(wq, scale, None if b is None else b.detach().float()))
    return model


@torch.no_grad()
def int8_skeleton(model):
    """``model`` with every linear replaced by an empty ``QuantLinear`` of its
    shape (on its device), to ``load_state_dict`` an int8 export into."""
    for owner, name in _sites(model):
        w, b = _float_linear(model, owner, name)
        dev = w.device
        _set(owner, name, QuantLinear(
            torch.empty(w.shape, dtype=torch.int8, device=dev),
            torch.empty(w.shape[0], dtype=torch.float32, device=dev),
            None if b is None else torch.empty(w.shape[0], dtype=torch.float32, device=dev)))
    return model


def is_quantized(model) -> bool:
    return any(isinstance(m, QuantLinear) for m in model.modules())


def quantized_size_bytes(model) -> int:
    """Bytes of every parameter and buffer (≙ quantized_size_bytes)."""
    return sum(t.numel() * t.element_size() for t in (*model.parameters(), *model.buffers()))
