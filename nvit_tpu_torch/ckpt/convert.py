"""JAX parameter tree ↔ the port's ``state_dict``: ``state_dict_from_jax``
(numpy in, torch out) and its inverse ``jax_params_from_state_dict`` (torch
in, numpy out).

The port's own mapping, written without importing ``nvit_tpu.ckpt`` (whose
package import pulls jax):

* linear weights ``[in, out]`` → ``[out, in]``;
* the local patch embed ``[C·p·p, d]`` → Conv2d ``[d, C, p, p]``;
* the global patch embed ``[C·k·k, d]`` in the 2×2-block-major fan-in order →
  Conv2d ``[d, C, k, k]`` through the inverse of
  ``models.patch.global_embed_permutation``;
* an int8 linear (``ops/quant.py``, the JAX ``{"wq", "scale"[, "b"]}``
  leaves) → ``<module>.wq`` ``[out, in]``, ``.scale`` and ``.b``; the int8
  patch embeds keep the JAX fan-in order, the order their forward reads;
* with Kohonen, each map's ``nodes`` as they are and ``map_balance`` (0-d);
  the maps' ``locations`` / ``offsets`` buffers are recomputed from the
  config, and a moment dict (which has no buffers) gets none.

The keys are the port's ``ViT.state_dict()`` keys.  In nViT mode they equal
those of ``nvit_tpu/ckpt/torch_interop.py::state_dict_from_params`` without
the unused ``rmsnorm_att/mlp`` weights; in baseline mode (no ``sz``, no scale
vectors, the cross-attention's ``local_norm``/``global_norm``) those plus the
blocks' ``rmsnorm_att/mlp`` weights, which that function drops.  Load the
result with ``ViT.load_state_dict(sd, strict=True)``.

The AdamW moments ``mu``/``nu`` have their parameters' layout on both
sides, so the same two functions carry them across (``ckpt/checkpoint.py``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nvit_tpu_torch.ckpt.tree import Spec, flatten, param_tree
from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.models.patch import global_embed_permutation
from nvit_tpu_torch.models.vit import kohonen_spec
from nvit_tpu_torch.som.kohonen import grid_locations, wrap_offsets


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _linear(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    if "wq" in p:  # int8 (ops/quant.py): wq [in, out] → [out, in], the bias a buffer ``b``
        sd[f"{prefix}.wq"] = _t(np.asarray(p["wq"]).T)
        sd[f"{prefix}.scale"] = _t(p["scale"])
        if "b" in p:
            sd[f"{prefix}.b"] = _t(p["b"])
        return
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def state_dict_from_jax(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """``init_vit``-shaped tree with numpy (or array-like) leaves → state_dict."""
    cfg.validate()
    d, c = cfg.n_embd, cfg.channels
    lp, gp = cfg.local_patch_size, cfg.global_patch_size
    sd: dict[str, torch.Tensor] = {}

    if "wq" in params["local_patch_embed"]:
        # int8 embeds keep the JAX fan-in order, which is their forward's order
        _linear(params["local_patch_embed"], "local_patch_embed", sd)
        _linear(params["global_patch_embed"], "global_patch_embed.1", sd)
    else:
        lw = np.asarray(params["local_patch_embed"]["w"])  # [C·p·p, d]
        sd["local_patch_embed.weight"] = _t(lw.T.reshape(d, c, lp, lp))
        sd["local_patch_embed.bias"] = _t(params["local_patch_embed"]["b"])
        inv = np.argsort(global_embed_permutation(c, gp, lp))
        gw = np.asarray(params["global_patch_embed"]["w"]).T  # [d, C·k·k] in our order
        sd["global_patch_embed.1.weight"] = _t(gw[:, inv].reshape(d, c, gp, gp))
        sd["global_patch_embed.1.bias"] = _t(params["global_patch_embed"]["b"])

    sd["local_pos_embed"] = _t(params["local_pos_embed"])
    sd["global_pos_embed"] = _t(params["global_pos_embed"])
    if cfg.use_kohonen:
        spec = kohonen_spec(cfg)
        sd["map_balance"] = _t(params["map_balance"])
        for name in ("local_kohonen", "global_kohonen"):
            sd[f"{name}.nodes"] = _t(params[name]["nodes"])
            sd[f"{name}.locations"] = _t(grid_locations(spec))
            sd[f"{name}.offsets"] = _t(wrap_offsets(spec))

    ca = params["cross_attention"]
    for name in ("q_local", "k_global", "v_global", "proj", "out_proj"):
        _linear(ca[name], f"cross_attention.{name}", sd)
    if cfg.use_nvit:
        sd["cross_attention.attn_alpha"] = _t(ca["attn_alpha"])
        sd["cross_attention.sqk"] = _t(ca["sqk"])
    else:
        sd["cross_attention.local_norm.weight"] = _t(ca["local_norm"])
        sd["cross_attention.global_norm.weight"] = _t(ca["global_norm"])

    _linear(params["reconstruction_head"], "reconstruction_head.0", sd)

    for i, blk in enumerate(params["blocks"]):
        prefix = f"transformer.h.{i}"
        for name in ("query", "key", "value", "att_c_proj", "c_fc", "mlp_c_proj"):
            _linear(blk[name], f"{prefix}.{name}", sd)
        sd[f"{prefix}.skip_param"] = _t(blk["skip_param"])
        if cfg.use_nvit:
            for name in ("attn_alpha", "mlp_alpha", "sqk", "suv"):
                sd[f"{prefix}.{name}"] = _t(blk[name])
        else:
            for name in ("rmsnorm_att", "rmsnorm_mlp"):
                sd[f"{prefix}.{name}.weight"] = _t(blk[name])

    sd["mlp_head.0.weight"] = _t(params["head_norm"]["w"])
    sd["mlp_head.0.bias"] = _t(params["head_norm"]["b"])
    _linear(params["head"], "mlp_head.1", sd)
    if cfg.use_nvit:
        sd["sz"] = _t(params["sz"])
    return sd


# the Sequential members whose parameters sit one level up in the JAX tree
_SEQUENTIAL = {"mlp_head.0": "head_norm", "mlp_head.1": "head",
               "reconstruction_head.0": "reconstruction_head", "global_patch_embed.1": "global_patch_embed"}
# norms whose weight is the JAX leaf itself, not a {"w": …} dict
_NORMS = ("rmsnorm_att", "rmsnorm_mlp", "local_norm", "global_norm")
_LEAF = {"weight": "w", "bias": "b"}


def jax_path(name: str) -> tuple:
    """The path in ``init_vit``'s tree (dict keys, list indices) of the
    ``ViT`` parameter ``name``: ``transformer.h.3.c_fc.weight`` →
    ``("blocks", 3, "c_fc", "w")``, ``mlp_head.0.weight`` → ``("head_norm",
    "w")``, ``cross_attention.local_norm.weight`` → ``("cross_attention",
    "local_norm")``."""
    parts = name.split(".")
    path: list = []
    if parts[:2] == ["transformer", "h"]:
        path, parts = ["blocks", int(parts[2])], parts[3:]
    if ".".join(parts[:2]) in _SEQUENTIAL:
        parts = [_SEQUENTIAL[".".join(parts[:2])], *parts[2:]]
    if len(parts) > 1 and parts[-2] in _NORMS:
        parts = parts[:-1]
    elif parts[-1] in _LEAF:
        parts[-1] = _LEAF[parts[-1]]
    return (*path, *parts)


def jax_order(name: str, t: torch.Tensor, local_patch: int) -> torch.Tensor:
    """A view of ``t`` — the ``ViT`` parameter ``name``, or a tensor in its
    layout (a gradient, a moment) — whose row-major element order is that of
    the JAX leaf: linear weights transposed to ``[in, out]``, the patch
    embeds' fan-in first, the global one's in the 2×2-block-major order of
    ``global_embed_permutation`` (``local_patch`` is its stride).  Writing
    through the view writes ``t``."""
    if name == "local_patch_embed.weight":
        return t.reshape(t.shape[0], -1).T
    if name == "global_patch_embed.1.weight":
        d, c, k = t.shape[:3]
        s = local_patch
        if k == 2 * s:  # features (i, j, C, ph, pw) of the kernel row i·s + ph, column j·s + pw
            return t.view(d, c, 2, s, 2, s).permute(2, 4, 1, 3, 5, 0)
        return t.reshape(d, -1).T
    if t.dim() == 2 and name.endswith((".weight", ".wq")):
        return t.T
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    """A contiguous host copy that shares no memory with ``t``: the fused
    update rewrites parameters and moments in place.  bfloat16 (the moments
    under ``optimizer.moments_dtype="bfloat16"``) comes out as the 2-byte
    void records numpy writes for ``ml_dtypes.bfloat16``, the JAX package's
    npz form of those leaves."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t.detach())
    if out.dtype == torch.bfloat16:
        return out.view(torch.int16).numpy().view("V2")
    return out.numpy()


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: ViTConfig) -> dict[str, Any]:
    """The inverse of ``state_dict_from_jax``: a ``ViT.state_dict()`` (or a
    moment dict with its keys) → ``init_vit``'s tree with numpy leaves, each
    a host copy in its JAX layout (``jax_order``: linear weights back to
    ``[in, out]``, the patch embeds to their ``[C·k·k, d]`` matrices, the
    global one's fan-in in the 2×2-block-major order).  An int8 model's
    ``state_dict`` (``ops/quant.py``) gives the int8 tree."""
    tree = param_tree(cfg, int8=any(name.endswith(".wq") for name in sd))
    for name, t in sd.items():
        if name.endswith((".locations", ".offsets")):  # the maps' grid buffers have no leaf
            continue
        *parent, leaf = jax_path(name)
        node = tree
        for key in parent:
            node = node[key]
        node[leaf] = _host(jax_order(name, t, cfg.local_patch_size)).reshape(node[leaf].shape)
    missing = [path for path, x in flatten(tree) if isinstance(x, Spec)]
    if missing:
        raise KeyError(f"no tensor for the JAX leaves {missing[:4]}")
    return tree
