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
