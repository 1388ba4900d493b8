"""The port's fused clip + AdamW + renorm update against the JAX package's (a
companion of tests/test_torch_core.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_parity import random_jax_params
from tests.torch_core_cases import _port_names_to_tensors, small_vit_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("clip", [0.05, 1e3])  # active, inactive
def test_fused_adamw_renorm_update_matches_jax(clip):
    """Three steps of the fused clip + AdamW + renorm update on converted
    trees: parameters and both moments.  fp32 throughout: the same fp32
    operations in the same order, so only summation order (the global norm,
    the renorm sums) separates the two — rtol 1e-5, atol 1e-6."""
    import jax

    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu.train import optim as jopt
    from nvit_tpu_torch.configs import OptimizerConfig
    from nvit_tpu_torch.train import optim as topt

    cfg = small_vit_cfg()
    params = random_jax_params(cfg, seed=5)
    kw = dict(learning_rate=1e-2, min_lr=1e-3, warmup_iters=1, lr_decay_iters=4, grad_clip=clip)
    rng = np.random.default_rng(6)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
             for _ in range(3)]

    jstate = jopt.init_fused_adamw(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    update = jax.jit(lambda p, g, s: jopt.fused_adamw_renorm_update(JaxOpt(**kw), p, g, s, renorm=True))
    for g in grads:
        jparams, jstate = update(jparams, g, jstate)

    tparams = _port_names_to_tensors(params, cfg)
    tstate = topt.init_fused_adamw(tparams.items())
    for g in grads:
        tstate = topt.fused_adamw_renorm_update(OptimizerConfig(**kw), tparams,
                                                _port_names_to_tensors(g, cfg), tstate, renorm=True)
    assert tstate.count == 3 == int(jstate.count)
    for got, want in ((tparams, jparams), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        want = _port_names_to_tensors(jax.tree_util.tree_map(np.asarray, want), cfg)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    # the Block matrices stay on the hypersphere along the flipped axes
    w = tparams["transformer.h.0.query.weight"]
    torch.testing.assert_close(w.norm(dim=1), torch.ones(w.shape[0]))
    w = tparams["transformer.h.0.att_c_proj.weight"]
    torch.testing.assert_close(w.norm(dim=0), torch.ones(w.shape[1]))
