"""The port's config sections, refusals, decay mask and parameter count against
the JAX package's (a companion of tests/test_torch_core.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from nvit_tpu_torch.models.vit import ViT
from tests.torch_parity import port_config, random_jax_params
from tests.torch_core_cases import SECTIONS, _port_names_to_tensors, small_vit_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("section", SECTIONS)
def test_config_sections_are_the_jax_sections(section):
    import nvit_tpu.configs.schema as jax_schema
    import nvit_tpu_torch.configs.schema as port_schema

    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(getattr(port_schema, section)) == fields(getattr(jax_schema, section))
    assert dataclasses.asdict(getattr(port_schema, section)()) == dataclasses.asdict(
        getattr(jax_schema, section)())


def test_unported_modes_raise():
    """Kohonen (tests/test_torch_kohonen.py holds it against JAX) and
    baseline mode (use_nvit=False; tests/test_torch_baseline.py) are ported:
    a Kohonen ViT builds with the reference state_dict keys — the interop's,
    minus the unused nViT rmsnorm weights — in the reference order outside
    the blocks (map_balance before sz, the maps between the patch embeds and
    the cross-attention), and the baseline one with its own parameters."""
    from nvit_tpu.ckpt.torch_interop import reference_state_dict_order

    cfg = small_vit_cfg(use_kohonen=True, kohonen_nodes=18)
    names = list(ViT(port_config(cfg), device="cpu").state_dict())
    ref = [k for k in reference_state_dict_order(cfg) if ".rmsnorm_" not in k]
    assert sorted(names) == sorted(ref)
    assert [k for k in names if not k.startswith("transformer.")] == [
        k for k in ref if not k.startswith("transformer.")]
    assert "local_kohonen.locations" in names and "map_balance" in names
    names = set(ViT(port_config(small_vit_cfg(use_nvit=False)), device="cpu").state_dict())
    assert "transformer.h.0.rmsnorm_att.weight" in names and "sz" not in names


def test_num_params_and_flops_model_match_jax():
    from nvit_tpu.models.vit import estimate_flops_per_iter as jax_flops
    from nvit_tpu.models.vit import num_params as jax_num_params
    from nvit_tpu_torch.models.vit import estimate_flops_per_iter, num_params

    cfg = small_vit_cfg()
    n = num_params(ViT(port_config(cfg), device="cpu"))
    assert n == jax_num_params(random_jax_params(cfg))
    assert estimate_flops_per_iter(port_config(cfg), n, 2) == jax_flops(cfg, n, 2)


def test_decay_mask_follows_the_jax_leaves():
    """Leaf by leaf against decay_mask(jax_params): the patch-embed convs are
    4-D here and 2-D there, skip_param is [1] in both."""
    import jax

    from nvit_tpu.train.optim import decay_mask as jax_decay_mask
    from nvit_tpu_torch.train.optim import decay_mask

    cfg = small_vit_cfg()
    params = random_jax_params(cfg)
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  jax_decay_mask(params), params)
    want = {n: bool(t.flatten()[0]) for n, t in _port_names_to_tensors(mask, cfg).items()}
    model = ViT(port_config(cfg), device="cpu")
    assert decay_mask(model.named_parameters()) == want
    assert want["local_patch_embed.weight"] and not want["transformer.h.0.skip_param"]
