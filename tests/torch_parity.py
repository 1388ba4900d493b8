"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from nvit_tpu.models.vit import init_vit
from nvit_tpu_torch.configs import ViTConfig


def port_config(cfg) -> ViTConfig:
    """The port's ``ViTConfig`` with the fields of a JAX ``ViTConfig``."""
    return ViTConfig(**dataclasses.asdict(cfg))


def random_jax_params(cfg, seed: int = 0) -> dict:
    """An ``init_vit``-shaped tree of random numpy leaves near init scale.

    The shapes come from ``jax.eval_shape`` (no JAX kernels run, so it costs
    a trace, not dozens of eager compiles); every leaf is drawn from ``seed``
    so the per-channel scalings (sqk, suv, alphas, sz, the baseline's RMSNorm
    weights), biases and position embeddings all take non-constant values."""
    shapes = jax.eval_shape(lambda k: init_vit(k, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        parent = str(getattr(path[-2], "key", "")) if len(path) > 1 else ""
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if name in ("sqk", "attn_alpha", "mlp_alpha"):
            return (cfg.base_scale * (1 + 0.1 * noise)).astype(np.float32)
        if name in ("suv", "skip_param", "sz", "rmsnorm_att", "rmsnorm_mlp", "local_norm",
                    "global_norm") or (parent == "head_norm" and name == "w"):
            return (1 + 0.1 * noise).astype(np.float32)
        if parent.endswith("patch_embed") and name == "w":
            return (noise / np.sqrt(s.shape[0])).astype(np.float32)
        return (0.02 * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def baseline_params(cfg, seed):
    """random_jax_params with the q/k weights (blocks and cross-attention)
    five times larger.  At init scale the attention is near-uniform, and the
    baseline cross-attention (no residual) then hands every block almost the
    same token: the q/k gradients shrink to ~1e-7 of the others and become a
    cancellation that rounding decides — no test of the port."""
    params = random_jax_params(cfg, seed=seed)
    for p, names in [(blk, ("query", "key")) for blk in params["blocks"]] + [
            (params["cross_attention"], ("q_local", "k_global"))]:
        for name in names:
            p[name]["w"] = 5 * p[name]["w"]
    return params


def kohonen_fields(**kw) -> dict:
    """The Kohonen tests' tiny model (16 px, 1 layer, d = 32; 18 nodes:
    two 3×3 maps) with ``kw`` over it."""
    base = dict(image_size=16, n_layer=1, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
                global_patch_size=8, use_nvit=True, use_kohonen=True, kohonen_nodes=18, flash_attn=True)
    base.update(kw)
    return base


def paired_configs(model: dict, **sections):
    """(JAX Config, port Config), field for field equal; each section is
    ``name=(dataclass name, fields)``."""
    from nvit_tpu.configs import schema as jax_schema
    from nvit_tpu_torch import configs as port_schema

    def build(mod):
        return mod.Config(model=mod.ViTConfig(**model),
                          **{k: getattr(mod, cls)(**v) for k, (cls, v) in sections.items()})
    return build(jax_schema), build(port_schema)


def kohonen_params(jcfg, seed: int) -> dict:
    """random_jax_params with the maps' nodes near the embeddings' scale, so
    the BMUs spread over the map."""
    params = random_jax_params(jcfg, seed=seed)
    rng = np.random.default_rng(seed + 50)
    for name in ("local_kohonen", "global_kohonen"):
        shape = params[name]["nodes"].shape
        params[name]["nodes"] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return params
