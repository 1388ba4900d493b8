"""The port's core primitives, patch embedding and checkpoint conversion
against the JAX package (same numpy inputs through both frameworks).

fp32 results agree to summation order (rtol 1e-5, atol 1e-6); bf16 results
may differ by one bf16 rounding (2^-7 relative), and XLA on the CPU may keep
excess fp32 precision between bf16 ops, so bf16 uses rtol/atol 2e-2.

Companion files: tests/test_torch_core_validate.py,
tests/test_torch_core_sections.py, tests/test_torch_core_ops.py,
tests/test_torch_core_layout.py, tests/test_torch_core_adamw.py; shared
inputs: tests/torch_core_cases.py.
"""

import dataclasses

import pytest
import torch

from nvit_tpu.configs.schema import Config as JaxConfig
from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu.models.presets import PRESETS as JAX_PRESETS
from nvit_tpu_torch.configs import Config as PortConfig
from nvit_tpu_torch.configs import ViTConfig as PortViTConfig
from nvit_tpu_torch.models.presets import PRESETS
from tests.torch_parity import port_config

torch.set_num_threads(1)


def test_presets_table_is_the_jax_table():
    assert PRESETS == JAX_PRESETS


def test_config_schema_is_the_jax_schema():
    """The port's ViTConfig is a copy (the port loads nothing of the JAX
    package): the same fields in the same order with the same defaults."""
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(PortViTConfig) == fields(ViTConfig)
    assert PortConfig().model == port_config(JaxConfig().model)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_properties_match_jax(name):
    jax_cfg = ViTConfig(**PRESETS[name])
    cfg = port_config(jax_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    for prop in ("head_dim", "n_patches", "grid_size"):
        assert getattr(cfg, prop) == getattr(jax_cfg, prop), prop
    cfg.validate()


def test_flagship_config_is_the_graft_entry_copy():
    from __graft_entry__ import flagship_config as jax_flagship
    from nvit_tpu_torch.models.presets import flagship_config

    assert flagship_config().to_dict() == jax_flagship().to_dict()
    assert flagship_config(n_layer=2).to_dict() == jax_flagship(n_layer=2).to_dict()


@pytest.mark.parametrize("bad", [dict(moments_dtype="fp8"), dict(sr_dither="philox")])
def test_optimizer_config_validate_matches_jax(bad):
    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu_torch.configs import OptimizerConfig

    with pytest.raises(ValueError) as want:
        JaxOpt(**bad).validate()
    with pytest.raises(ValueError) as got:
        OptimizerConfig(**bad).validate()
    assert str(got.value) == str(want.value)
