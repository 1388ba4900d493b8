"""The port's Kohonen model against the JAX package, on the CPU, at tiny
sizes (16 px, 1 layer, d = 32; 18 nodes = two 3×3 maps, 64 nodes = two
5×6 maps):

* ``kohonen_lr`` and the maps' alpha with the scheduler on and off, in
  warmup, decay and after;
* ``ViT.forward_train`` against ``vit_apply`` (logits, the five aux terms,
  the BMU indices, the Hebbian deltas under "reference", "sum" and "off"),
  nViT and baseline, remat off and on, fp32 and bf16;
* the checkpoint tree against the JAX ``TrainState``'s.

The JAX side runs its plain attention and MLP on the CPU (no Pallas kernel
is forced); the port runs its kernels' plain twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.models import schedules as jS
from nvit_tpu.models import vit as jvit
from nvit_tpu.train.state import create_train_state as jax_create_train_state
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.ckpt.tree import train_state_specs
from nvit_tpu_torch.models import schedules as tS
from nvit_tpu_torch.models.vit import ViT, kohonen_spec
from tests.torch_parity import kohonen_fields, kohonen_params, paired_configs

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- schedule
@pytest.mark.parametrize("step", [0, 3, 15, 40])
def test_kohonen_lr_and_map_alpha_match_jax(step):
    """kohonen_lr bit-equal in warmup (step < 5), decay and after (> 20),
    with the scheduler on and off, and each map's alpha: min_lr with the
    scheduler on, kohonen_alpha off."""
    for scheduler in (True, False):
        m = kohonen_fields(kohonen_nodes=64, kohonen_alpha=0.3, kohonen_scheduler_enabled=scheduler,
                           kohonen_scheduler_warmup_steps=5, kohonen_scheduler_decay_steps=20,
                           kohonen_scheduler_min_lr=0.01)
        jcfg, cfg = jax_schema.ViTConfig(**m), port_schema.ViTConfig(**m)
        got = tS.kohonen_lr(cfg, step)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jS.kohonen_lr(jcfg, step)))
        assert tuple(kohonen_spec(cfg)) == tuple(jvit.kohonen_spec(jcfg))
        assert kohonen_spec(cfg).alpha == (0.01 if scheduler else 0.3)


# ---------------------------------------------------------------- forward
FORWARD_CASES = {  # name → (model fields, compute dtype, remat, step)
    "nvit-fp32-reference-scheduled": (dict(kohonen_scheduler_enabled=True, kohonen_scheduler_warmup_steps=5,
                                           kohonen_scheduler_decay_steps=20), None, False, 3),
    "nvit-bf16-remat-sum": (dict(kohonen_nodes=64, kohonen_hebbian="sum"), "bf16", True, 15),
    "baseline-fp32-remat-off": (dict(use_nvit=False, kohonen_nodes=64, kohonen_hebbian="off"), None, True, 40),
    "baseline-bf16-reference": (dict(use_nvit=False, kohonen_scheduler_enabled=True,
                                     kohonen_scheduler_warmup_steps=5, kohonen_scheduler_decay_steps=20),
                                "bf16", False, 15),
}


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_forward_matches_vit_apply(case):
    """Logits, the five aux terms, the BMU indices and the Hebbian deltas
    against ``vit_apply(train=True)``.  fp32: logits 1e-4 (summation order
    through the blocks), aux and deltas 1e-5 relative.  bf16: logits 3e-2
    (tests/test_torch_slice.py's bound), aux 1e-2 relative, the deltas 1e-2
    of their largest, with the indices equal (both read embeddings equal to
    a bf16 rounding here).  The serving forward gives forward_train's
    logits."""
    fields, dt, remat, step = FORWARD_CASES[case]
    jcfg, cfg = paired_configs(kohonen_fields(**fields))
    params = kohonen_params(jcfg.model, seed=len(case))
    img = np.random.default_rng(1).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    jdt, tdt = (None, None) if dt is None else (jnp.bfloat16, torch.bfloat16)
    out = jax.jit(lambda p, x: jvit.vit_apply(p, jcfg.model, x, step=step, train=True, compute_dtype=jdt,
                                              remat=remat))(params, jnp.asarray(img))
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg.model), strict=True)
    with torch.no_grad():
        logits, aux, som = model.forward_train(t(img), step=step, compute_dtype=tdt, remat=remat)
        served = model(t(img), compute_dtype=tdt)
    torch.testing.assert_close(served, logits, rtol=0, atol=0)
    want = np.asarray(out.logits, np.float32)
    tol = dict(rtol=1e-4, atol=1e-5) if dt is None else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(logits.float().numpy(), want, **tol)
    assert set(aux) == set(out.aux_losses)
    for k, v in aux.items():
        np.testing.assert_allclose(v.item(), float(out.aux_losses[k]), rtol=1e-5 if dt is None else 1e-2,
                                   err_msg=k)
    hebbian = cfg.model.kohonen_hebbian != "off"
    assert set(som) == set(out.som_info) == {"local_indices", "global_indices"} | (
        {"local_delta", "global_delta"} if hebbian else set())
    for k in ("local_indices", "global_indices"):
        np.testing.assert_array_equal(som[k].numpy(), np.asarray(out.som_info[k]), err_msg=k)
    for k in ("local_delta", "global_delta") if hebbian else ():
        w = np.asarray(out.som_info[k])
        tol = 1e-5 if dt is None else 1e-2
        np.testing.assert_allclose(som[k].numpy(), w, rtol=tol, atol=tol * np.abs(w).max(), err_msg=k)


# ------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("nodes", [18, 64])
def test_checkpoint_tree_is_the_jax_train_state(nodes):
    jcfg, cfg = paired_configs(kohonen_fields(kohonen_nodes=nodes))
    abstract = jax.eval_shape(lambda: jax_create_train_state(jcfg))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    key = lambda k: getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))  # noqa: E731
    want = [(tuple(key(k) for k in path), tuple(x.shape), str(x.dtype)) for path, x in leaves]
    assert [(p, s.shape, s.dtype) for p, s in train_state_specs(cfg)] == want
