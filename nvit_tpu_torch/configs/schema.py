"""Model configuration — a copy of ``nvit_tpu.configs.schema.ViTConfig``.

A copy, not an import: the port and ``chip_smoke.py`` load nothing of the
JAX package, so they run where only PyTorch is installed.  The field names,
defaults, derived properties and ``validate`` are the JAX package's, so a
JAX config converts with ``ViTConfig(**dataclasses.asdict(jax_cfg))``;
``tests/test_torch_core.py`` asserts the two schemas stay equal.

``Config`` holds only the ``model`` section for now: the training, optimizer,
system and data sections come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ViTConfig:
    """Model hyperparameters (≙ nvit_tpu/configs/schema.py:ViTConfig)."""

    image_size: int = 224
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 1024
    base_scale: float = 1.0 / math.sqrt(1024.0)
    use_nvit: bool = False
    flash_attn: bool = False  # selects the fused QK-norm attention kernel
    # softmax stabilizer of the fused QK-norm kernel: "rowmax" (exact per-row
    # max, the default), "bounded" or "auto" (opt-in; not ported yet)
    bounded_softmax: str = "rowmax"
    # fused gated-MLP kernel dispatch: "on" | "off" | "auto" (kernel iff
    # n_embd ≤ 768; models/blocks.py)
    gated_mlp_kernel: str = "auto"
    sz_init_value: float = 1.00
    sz_init_scaling: float = 1.0
    dropout: float = 0.0
    bias: bool = False
    channels: int = 3
    num_classes: int = 1000
    local_patch_size: int = 8
    global_patch_size: int = 16
    kohonen_nodes: int = 512
    kohonen_alpha: float = 0.01
    use_kohonen: bool = False
    reconstruction_weight: float = 0.1
    map_balance_weight: float = 0.5
    kohonen_scheduler_enabled: bool = False
    kohonen_scheduler_warmup_steps: int = 1000
    kohonen_scheduler_decay_steps: int = 10000
    kohonen_scheduler_min_lr: float = 0.001
    kohonen_hebbian: str = "reference"
    local_quantization_weight: float = 0.1
    global_quantization_weight: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.local_patch_size) ** 2

    @property
    def grid_size(self) -> int:
        return self.image_size // self.local_patch_size

    def validate(self) -> None:
        if self.bounded_softmax not in ("bounded", "rowmax", "auto"):
            raise ValueError(
                f"bounded_softmax must be 'bounded', 'rowmax' or 'auto', got {self.bounded_softmax!r}"
            )
        if self.gated_mlp_kernel not in ("on", "off", "auto"):
            raise ValueError(
                f"gated_mlp_kernel must be 'on', 'off' or 'auto', got {self.gated_mlp_kernel!r}"
            )
        if self.kohonen_hebbian not in ("sum", "reference", "off"):
            raise ValueError(
                f"kohonen_hebbian must be 'sum', 'reference' or 'off', got {self.kohonen_hebbian!r}"
            )
        if self.n_embd % self.n_head != 0:
            raise ValueError(f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")
        if self.image_size % self.local_patch_size != 0:
            raise ValueError(
                f"image_size={self.image_size} not divisible by local_patch_size={self.local_patch_size}"
            )
        if (self.global_patch_size - self.local_patch_size) % 2 != 0:
            raise ValueError("global/local patch size difference must be even (centered padding)")
        if self.use_kohonen and self.kohonen_nodes < 2:
            raise ValueError(f"kohonen_nodes must be ≥ 2 (two maps), got {self.kohonen_nodes}")


@dataclass(frozen=True)
class Config:
    """The config tree's ``model`` section (≙ nvit_tpu/configs/schema.py:Config)."""

    model: ViTConfig = field(default_factory=ViTConfig)
