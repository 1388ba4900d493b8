"""The debug / visualization CLI (≙ nvit_tpu/debug)."""

from nvit_tpu_torch.debug.cli import debug_model, fixture_image

__all__ = ["debug_model", "fixture_image"]
