"""The typed configuration tree — a copy of ``nvit_tpu.configs.schema``.

A copy, not an import: the port and ``chip_smoke.py`` load nothing of the
JAX package, so they run where only PyTorch is installed.  The field names,
defaults, derived properties and ``validate`` are the JAX package's, so a
JAX config converts section by section with ``dataclasses.asdict``;
``tests/test_torch_core.py`` asserts the two schemas stay equal, and
``merge_dataclass`` is the JAX package's too: a checkpoint's meta stores
``Config.to_dict()``, which either package rebuilds into its own config.  Comments
name the TPU where the JAX package's settings do: they are copied as they
are, and the port's trainer (``train/trainer.py``) says which settings it
takes, which it ignores as TPU-only, and which raise until their ROADMAP.md
item lands.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any


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
    # max, the default, K1/K2), "bounded" or "auto" (opt-in, K5)
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
class TrainingConfig:
    """≙ reference settings.yaml:1-16 (training section)."""

    eval_interval: int = 1000
    # every Nth periodic eval runs the FULL (un-capped) validation pass even
    # when system.quick_validation is on, so best-checkpoint selection and
    # early stopping periodically see the whole val set (≙ reference
    # evaluate() always running the full pass, train.py:728-766).  0 = never.
    full_eval_interval: int = 0
    log_interval: int = 200
    eval_iters: int = 200
    eval_only: bool = False
    always_save_checkpoint: bool = True
    init_from: str = "scratch"  # scratch | resume
    gradient_accumulation_steps: int = 1
    batch_size: int = 512
    max_iters: int = 100_000
    time_limit_seconds: int = 86_400
    max_iters_per_launch: int = 10_000
    early_stopping_patience: int = 10
    save_numbered_checkpoints: bool = False
    consistency_weight: float = 0.1
    smoothness_weight: float = 0.1
    seed: int = 42


@dataclass(frozen=True)
class SchedulerConfig:
    type: str = "cosine"
    factor: float = 0.1
    patience: int = 5


@dataclass(frozen=True)
class OptimizerConfig:
    """≙ reference settings.yaml:18-31 (optimizer section)."""

    learning_rate: float = 1e-3
    min_lr: float = 1e-5
    warmup_iters: int = 500
    lr_decay_iters: int = 1000
    decay_lr: bool = True
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    # AdamW moment storage dtype.  "bfloat16" halves the optimizer state's
    # HBM traffic (−0.96 GB/step at nViT-B/16) and resident size using
    # STOCHASTIC-ROUNDING stores (unbiased; compute stays fp32) — the
    # round-5 pre-registered traffic experiment, BASELINE.md.  Default
    # float32 ≙ reference torch.optim.AdamW state.
    moments_dtype: str = "float32"
    # SR dither bit source when moments_dtype=bfloat16: "hash" (fmix32
    # counter hash — ~8× fewer VPU ops than threefry, same determinism/
    # unbiasedness guarantees) or "threefry" (jax.random.bits).  Default
    # flipped to "hash" by pre-registered experiment #2's keep bar
    # (BASELINE.md round 5: 2.0 ms/step faster than threefry — makes bf16
    # moments step-time-neutral vs fp32 — probe Δ 0.209 < 0.3).
    # Ignored for float32 moments.
    sr_dither: str = "hash"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    def validate(self) -> None:
        if self.moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"moments_dtype must be 'float32' or 'bfloat16', got {self.moments_dtype!r}"
            )
        if self.sr_dither not in ("threefry", "hash"):
            raise ValueError(
                f"sr_dither must be 'threefry' or 'hash', got {self.sr_dither!r}"
            )


@dataclass(frozen=True)
class SystemConfig:
    """≙ reference settings.yaml:60-75 (system section), TPU-translated.

    ``dtype`` is the compute dtype policy ("bfloat16"/"float32"); on TPU bf16
    needs no loss scaling so there is no GradScaler equivalent (params stay
    fp32, activations run in the compute dtype).  ``jit: false`` is the debug
    escape hatch replacing torch.compile's toggle.
    """

    device: str = "tpu"  # tpu | cpu (jax platform hint; informational)
    dtype: str = "bfloat16"
    use_ddp: bool = True  # enable data-parallel sharding over the mesh
    # tensor-parallel axis size of the (data × model) mesh; 1 = pure DP.
    # device_count must be divisible by it (parallel/mesh.py::make_mesh)
    model_parallel: int = 1
    # ZeRO-3-style FSDP: shard trunk weights + AdamW moments over the data
    # axis (renorm-free axis; parallel/mesh.py module docstring).  Composes
    # with model_parallel — per-device param/moment memory scales down with
    # BOTH axes.  No effect on single-device runs
    fsdp: bool = False
    compile: bool = True  # kept for settings parity; jit is always on unless jit=False
    jit: bool = True
    backend: str = "ici"  # ≙ "nccl"; informational — XLA collectives ride ICI/DCN
    log_level: str = "INFO"
    log_to_file: bool = True
    memory_threshold: float = 0.9
    log_memory: bool = True
    log_gpu_stats: bool = True  # name kept for settings parity; logs TPU device stats
    # eval-cadence per-tensor gradient histograms (≙ wandb.watch(gradients),
    # train.py:531-546; obs/grad_hist.py).  Off by default: it compiles a
    # third train-step variant.
    log_grad_histograms: bool = False
    clear_cache: bool = True
    quick_validation: bool = True
    quick_validation_size: int = 1000
    use_amp: bool = True  # parity knob: False forces float32 compute
    use_tqdm: bool = True
    remat: bool = True  # jax.checkpoint the transformer blocks in training
    remat_skip_blocks: int = 0  # exempt the last N blocks from remat (spends HBM for speed)
    profile_steps: int = 0  # capture a jax.profiler trace for the first N steps
    debug_nans: bool = False  # jax_debug_nans sanitizer
    # persistent XLA compilation cache directory ("" = disabled).  Fresh
    # flagship-scale programs cost minutes of (remote) TPU compile; with the
    # cache every relaunch of the same program loads in seconds — essential
    # for the time_limit_seconds relaunch protocol, where each launch would
    # otherwise re-pay the full compile (observed: a 1500 s launch spending
    # 100% of its budget compiling and training zero steps).
    # ≙ torch.compile's inductor cache in the reference's stack (implicit
    # there; explicit and shareable here).
    compilation_cache_dir: str = ".jax_cache"


@dataclass(frozen=True)
class WandbConfig:
    """≙ reference settings.yaml:77-83."""

    mode: str = "disabled"  # online | offline | disabled
    project: str = "phd"
    run_name: str = "nvit_"
    save_artifacts: bool = True
    artifact_description: str = "ViT model checkpoint"
    artifact_name: str = "nvit_cifar100"


@dataclass(frozen=True)
class AugmentationConfig:
    enabled: bool = True
    color_jitter: float = 0.2
    random_affine: bool = True
    cutout: bool = False
    auto_augment: bool = True


@dataclass(frozen=True)
class DataConfig:
    """≙ reference settings.yaml:85-96 (data section)."""

    out_dir: str = "./out"
    dataset: str = "cifar100"  # cifar10 | cifar100 | imagenet | synthetic | digits (bundled real data)
    data_dir: str = "./data"
    checkpoint_dir: str = "./out"
    checkpoint_file: str = "checkpoint_latest"
    checkpoint_backend: str = "npz"  # npz (atomic, async writes) | orbax (sharded multi-host IO)
    # opt-in checksum-pinned CIFAR fetch on the master process (needs egress);
    # ≙ reference train.py:283-301 torchvision download=master_process
    download: bool = False
    num_workers: int = 4
    prefetch: int = 2
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)


@dataclass(frozen=True)
class Config:
    training: TrainingConfig = field(default_factory=TrainingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    model: ViTConfig = field(default_factory=ViTConfig)
    system: SystemConfig = field(default_factory=SystemConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a string/scalar override onto a dataclass field type."""
    if typ is bool:
        if isinstance(value, bool):
            return value
        return str(value).strip().lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(float(value))
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    return value


def merge_dataclass(obj: Any, overrides: dict[str, Any]) -> Any:
    """Return a copy of frozen dataclass ``obj`` with ``overrides`` applied.

    Nested dicts recurse into nested dataclasses; scalar values are coerced to
    the declared field type (env vars arrive as strings).  Unknown keys raise,
    unlike Dynaconf's silent acceptance — the reference's settings→config key
    gaps (train.py:398-417 omitting kohonen_scheduler_*) were a latent bug we
    deliberately do not reproduce.
    """
    if not overrides:
        return obj
    fields = {f.name: f for f in dataclasses.fields(obj)}
    changes: dict[str, Any] = {}
    for key, value in overrides.items():
        key = key.lower()
        if key not in fields:
            raise KeyError(f"Unknown config key '{key}' for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise TypeError(
                    f"Config section '{key}' expects nested keys "
                    f"(e.g. {key.upper()}__SOMEKEY=...), got scalar {value!r}"
                )
            changes[key] = merge_dataclass(current, value)
        else:
            changes[key] = _coerce(value, type(current))
    return dataclasses.replace(obj, **changes)
