"""Named model presets — a copy of ``nvit_tpu.models.presets.PRESETS`` — and
the flagship training config.

A copy, not an import: importing ``nvit_tpu.models`` pulls jax in through the
package ``__init__``.  ``tests/test_torch_core.py`` asserts the two tables
stay equal.  ``ViTConfig(**preset("nvit-b16"), num_classes=1000)`` builds
the flagship model; ``flagship_config()`` the whole training config.
"""

from __future__ import annotations

from typing import Any

from nvit_tpu_torch.configs import Config, OptimizerConfig, SystemConfig, TrainingConfig, ViTConfig

PRESETS: dict[str, dict[str, Any]] = {
    # CIFAR-scale smoke model
    "nvit-tiny4": dict(
        image_size=32, n_layer=4, n_head=4, n_embd=128,
        local_patch_size=4, global_patch_size=8, use_nvit=True,
    ),
    # reference settings.yaml default scale
    "nvit-ref-cifar": dict(
        image_size=32, n_layer=2, n_head=2, n_embd=64,
        local_patch_size=8, global_patch_size=16, use_nvit=True,
    ),
    "nvit-s16": dict(
        image_size=224, n_layer=12, n_head=6, n_embd=384,
        local_patch_size=8, global_patch_size=16, use_nvit=True, flash_attn=True,
    ),
    # flagship nViT-B/16
    "nvit-b16": dict(
        image_size=224, n_layer=12, n_head=12, n_embd=768,
        local_patch_size=8, global_patch_size=16, use_nvit=True, flash_attn=True,
    ),
    "nvit-l16": dict(
        image_size=224, n_layer=24, n_head=16, n_embd=1024,
        local_patch_size=8, global_patch_size=16, use_nvit=True, flash_attn=True,
    ),
}


def preset(name: str) -> dict[str, Any]:
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"unknown preset '{name}'; available: {sorted(PRESETS)}")
    return dict(PRESETS[key])


def flagship_config(**overrides) -> Config:
    """nViT-B/16 training: 12L/12H/768d, 224 px, dual 8/16 patches,
    ImageNet-1k classes, batch 32, no remat — a copy of
    ``__graft_entry__.flagship_config`` (held equal by tests/test_torch_core.py)."""
    model = dict(
        image_size=224,
        n_layer=12,
        n_head=12,
        n_embd=768,
        num_classes=1000,
        local_patch_size=8,
        global_patch_size=16,
        use_nvit=True,
        use_kohonen=False,
        flash_attn=True,
        bias=False,
    )
    model.update(overrides)
    model_cfg = ViTConfig(**model)
    model_cfg.validate()
    return Config(
        model=model_cfg,
        training=TrainingConfig(batch_size=32),
        optimizer=OptimizerConfig(),
        system=SystemConfig(remat=False),
    )
