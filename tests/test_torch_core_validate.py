"""The port's config validation and compute-dtype policy against the JAX
package's (a companion of tests/test_torch_core.py)."""

import jax.numpy as jnp
import pytest
import torch

from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu_torch.configs import Config as PortConfig
from nvit_tpu_torch.configs import ViTConfig as PortViTConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("bad", [
    dict(bounded_softmax="max"), dict(gated_mlp_kernel="yes"), dict(kohonen_hebbian="x"),
    dict(n_head=5), dict(image_size=30), dict(global_patch_size=11),
    dict(use_kohonen=True, kohonen_nodes=1),
])
def test_config_validate_matches_jax(bad):
    with pytest.raises(ValueError) as want:
        ViTConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        PortViTConfig(**bad).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("use_amp,dtype", [(True, "bfloat16"), (True, "float16"), (True, "float32"),
                                           (False, "bfloat16")])
def test_compute_dtype_policy_matches_jax(use_amp, dtype):
    from nvit_tpu.configs.schema import Config as JaxCfg
    from nvit_tpu.configs.schema import SystemConfig as JaxSys
    from nvit_tpu.train.state import compute_dtype_of as jax_compute_dtype_of
    from nvit_tpu_torch.configs import SystemConfig
    from nvit_tpu_torch.train.state import compute_dtype_of

    got = compute_dtype_of(PortConfig(system=SystemConfig(use_amp=use_amp, dtype=dtype)))
    want = jax_compute_dtype_of(JaxCfg(system=JaxSys(use_amp=use_amp, dtype=dtype)))
    assert got == {None: None, jnp.bfloat16: torch.bfloat16}[want]
