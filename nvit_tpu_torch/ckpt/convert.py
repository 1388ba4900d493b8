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

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.models.patch import global_embed_permutation
from nvit_tpu_torch.models.vit import kohonen_spec
from nvit_tpu_torch.som.kohonen import grid_locations, wrap_offsets


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _linear(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def state_dict_from_jax(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """``init_vit``-shaped tree with numpy (or array-like) leaves → state_dict."""
    cfg.validate()
    d, c = cfg.n_embd, cfg.channels
    lp, gp = cfg.local_patch_size, cfg.global_patch_size
    sd: dict[str, torch.Tensor] = {}

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


def _host(t: torch.Tensor) -> np.ndarray:
    """A contiguous host copy that shares no memory with ``t``: the fused
    update rewrites parameters and moments in place."""
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    out.copy_(t.detach())
    return out.numpy()


def _jax_linear(sd: Mapping[str, torch.Tensor], prefix: str) -> dict[str, np.ndarray]:
    p = {"w": _host(sd[f"{prefix}.weight"].T)}
    if f"{prefix}.bias" in sd:
        p["b"] = _host(sd[f"{prefix}.bias"])
    return p


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: ViTConfig) -> dict[str, Any]:
    """The inverse of ``state_dict_from_jax``: a ``ViT.state_dict()`` (or a
    moment dict with its keys) → ``init_vit``'s tree with numpy leaves, each a
    copy: linear weights back to ``[in, out]``, the patch embeds to their
    ``[C·k·k, d]`` matrices, the global one's fan-in onto the 2×2-block-major
    order of ``global_embed_permutation``."""
    cfg.validate()
    d = cfg.n_embd
    perm = torch.from_numpy(global_embed_permutation(cfg.channels, cfg.global_patch_size,
                                                     cfg.local_patch_size))
    gw = sd["global_patch_embed.1.weight"]
    params: dict[str, Any] = {
        "local_patch_embed": {"w": _host(sd["local_patch_embed.weight"].reshape(d, -1).T),
                              "b": _host(sd["local_patch_embed.bias"])},
        "global_patch_embed": {"w": _host(gw.reshape(d, -1)[:, perm.to(gw.device)].T),
                               "b": _host(sd["global_patch_embed.1.bias"])},
        "local_pos_embed": _host(sd["local_pos_embed"]),
        "global_pos_embed": _host(sd["global_pos_embed"]),
        "reconstruction_head": _jax_linear(sd, "reconstruction_head.0"),
        "head_norm": {"w": _host(sd["mlp_head.0.weight"]), "b": _host(sd["mlp_head.0.bias"])},
        "head": _jax_linear(sd, "mlp_head.1"),
    }
    ca = {name: _jax_linear(sd, f"cross_attention.{name}")
          for name in ("q_local", "k_global", "v_global", "proj", "out_proj")}
    if cfg.use_nvit:
        ca.update(attn_alpha=_host(sd["cross_attention.attn_alpha"]),
                  sqk=_host(sd["cross_attention.sqk"]))
    else:
        ca.update(local_norm=_host(sd["cross_attention.local_norm.weight"]),
                  global_norm=_host(sd["cross_attention.global_norm.weight"]))
    params["cross_attention"] = ca

    blocks = []
    for i in range(cfg.n_layer):
        prefix = f"transformer.h.{i}"
        blk = {name: _jax_linear(sd, f"{prefix}.{name}")
               for name in ("query", "key", "value", "att_c_proj", "c_fc", "mlp_c_proj")}
        blk["skip_param"] = _host(sd[f"{prefix}.skip_param"])
        if cfg.use_nvit:
            blk.update({name: _host(sd[f"{prefix}.{name}"])
                        for name in ("attn_alpha", "mlp_alpha", "sqk", "suv")})
        else:
            blk.update({name: _host(sd[f"{prefix}.{name}.weight"])
                        for name in ("rmsnorm_att", "rmsnorm_mlp")})
        blocks.append(blk)
    params["blocks"] = blocks
    if cfg.use_kohonen:
        params["map_balance"] = _host(sd["map_balance"])
        for name in ("local_kohonen", "global_kohonen"):
            params[name] = {"nodes": _host(sd[f"{name}.nodes"])}
    if cfg.use_nvit:
        params["sz"] = _host(sd["sz"])
    return params
