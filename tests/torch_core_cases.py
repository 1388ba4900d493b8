"""Shared inputs, helpers and fixtures of tests/test_torch_core.py,
tests/test_torch_core_validate.py, tests/test_torch_core_sections.py,
tests/test_torch_core_ops.py, tests/test_torch_core_layout.py,
tests/test_torch_core_adamw.py."""

import jax.numpy as jnp
import numpy as np
import torch

from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from tests.torch_parity import port_config

DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-6)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def both(a, name):
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def close(t, j, name):
    assert t.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[j.dtype.type], (t.dtype, j.dtype)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **DTYPES[name][2])


def small_vit_cfg(**kw):
    base = dict(image_size=16, n_layer=2, n_head=2, n_embd=32, num_classes=7,
                local_patch_size=4, global_patch_size=8, use_nvit=True)
    base.update(kw)
    return ViTConfig(**base)


# ------------------------------------------------------------ training slice
SECTIONS = ("TrainingConfig", "SchedulerConfig", "OptimizerConfig", "SystemConfig",
            "WandbConfig", "AugmentationConfig", "DataConfig", "Config")


def _jax_vjp(fn, primals, cotangent):
    import jax

    _, vjp = jax.vjp(fn, *primals)
    return vjp(cotangent)


def _port_names_to_tensors(tree, cfg):
    """A JAX-shaped tree → ``{ViT parameter name: tensor}`` (the one function
    that carries weights across, applied to any tree of the params' shapes)."""
    return state_dict_from_jax(tree, port_config(cfg))
