"""Configuration of the port (≙ nvit_tpu/configs): the typed config tree."""

from nvit_tpu_torch.configs.schema import (
    AugmentationConfig,
    Config,
    DataConfig,
    OptimizerConfig,
    SchedulerConfig,
    SystemConfig,
    TrainingConfig,
    ViTConfig,
    WandbConfig,
)

__all__ = [
    "AugmentationConfig", "Config", "DataConfig", "OptimizerConfig", "SchedulerConfig",
    "SystemConfig", "TrainingConfig", "ViTConfig", "WandbConfig",
]
