"""Configuration of the port (≙ nvit_tpu/configs): the typed config tree and
its loader (YAML, secrets, ``.env`` and ``NVIT_SECTION__KEY`` overrides)."""

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
    merge_dataclass,
)
from nvit_tpu_torch.configs.loader import get_secret, load_config, read_dotenv

__all__ = [
    "AugmentationConfig", "Config", "DataConfig", "OptimizerConfig", "SchedulerConfig",
    "SystemConfig", "TrainingConfig", "ViTConfig", "WandbConfig", "get_secret", "load_config",
    "merge_dataclass", "read_dotenv",
]
