"""JAX parameter tree → the port's ``state_dict`` (numpy in, torch out).

The port's own mapping, written without importing ``nvit_tpu.ckpt`` (whose
package import pulls jax):

* linear weights ``[in, out]`` → ``[out, in]``;
* the local patch embed ``[C·p·p, d]`` → Conv2d ``[d, C, p, p]``;
* the global patch embed ``[C·k·k, d]`` in the 2×2-block-major fan-in order →
  Conv2d ``[d, C, k, k]`` through the inverse of
  ``models.patch.global_embed_permutation``.

The keys are the port's ``ViT.state_dict()`` keys.  In nViT mode they equal
those of ``nvit_tpu/ckpt/torch_interop.py::state_dict_from_params`` without
the unused ``rmsnorm_att/mlp`` weights; in baseline mode (no ``sz``, no scale
vectors, the cross-attention's ``local_norm``/``global_norm``) those plus the
blocks' ``rmsnorm_att/mlp`` weights, which that function drops.  Load the
result with ``ViT.load_state_dict(sd, strict=True)``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from nvit_tpu_torch.configs import ViTConfig
from nvit_tpu_torch.models.patch import global_embed_permutation
from nvit_tpu_torch.models.vit import check_supported


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))


def _linear(p: Mapping[str, Any], prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = _t(p["b"])


def state_dict_from_jax(params: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """``init_vit``-shaped tree with numpy (or array-like) leaves → state_dict."""
    check_supported(cfg)
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
