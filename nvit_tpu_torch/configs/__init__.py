"""Configuration of the port (≙ nvit_tpu/configs): ``ViTConfig`` and ``Config``."""

from nvit_tpu_torch.configs.schema import Config, ViTConfig

__all__ = ["Config", "ViTConfig"]
