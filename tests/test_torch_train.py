"""The port's training slice against the JAX package, end to end on the CPU.

* the whole slice: ``nvit-tiny4`` at 2 layers with ``flash_attn=True``,
  batch 4, gradient accumulation 1 and 2, two ``make_train_step`` steps in
  the fp32 and bf16 policies — the port (K1–K4 twins on the CPU) against
  ``nvit_tpu.train.step.make_train_step`` with the Pallas kernels forced
  through the generic interpreter (tests/kernel_force.py); parameters and
  metrics are compared after the two steps;
* the same with ``bias=True`` (``settings.yaml``'s setting), nViT and
  baseline, in fp32 (the K6 twins on the CPU), and one step's bias and
  ``suv`` gradients against ``jax.grad`` of the loss that step takes;
* the data path is tests/test_torch_train_data.py, the trainer
  tests/test_torch_trainer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from tests.torch_parity import baseline_params, random_jax_params

torch.set_num_threads(1)

BATCH = 4


def slice_configs(dtype: str, accum: int, **model_kw):
    """(JAX Config, port Config) of the tiny slice, field for field equal."""
    model = preset("nvit-tiny4")
    model.update(n_layer=2, num_classes=10, flash_attn=True, **model_kw)
    sections = dict(
        model=model,
        training=dict(batch_size=BATCH, gradient_accumulation_steps=accum),
        # no warmup: both steps move the weights (lr = 1e-3, then cosine)
        optimizer=dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0, lr_decay_iters=10),
        system=dict(remat=False, dtype=dtype, log_gpu_stats=True),
    )

    def build(mod):
        return mod.Config(
            model=mod.ViTConfig(**sections["model"]),
            training=mod.TrainingConfig(**sections["training"]),
            optimizer=mod.OptimizerConfig(**sections["optimizer"]),
            system=mod.SystemConfig(**sections["system"]),
        )

    return build(jax_schema), build(port_schema)


def batches(cfg):
    rng = np.random.default_rng(21)
    m = cfg.model
    return [(rng.integers(0, 256, (BATCH, 3, m.image_size, m.image_size), dtype=np.uint8),
             rng.integers(0, m.num_classes, BATCH).astype(np.int32)) for _ in range(2)]


CASES = [(d, a) for d in ("float32", "bfloat16") for a in (1, 2)]
METRICS = ("class_loss", "total_loss", "reconstruction", "grad_norm", "learning_rate")


@pytest.fixture(scope="module")
def jax_two_steps():
    """JAX parameters and metrics after two steps, per (dtype, accum),
    computed once for the module (one jitted step program per case)."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.state import TrainState as JaxState
    from nvit_tpu.train.step import make_train_step as jax_make_train_step
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    out = {}
    with force_on_tpu(), generic_interpret_mode():
        for dtype, accum in CASES:
            jcfg, _ = slice_configs(dtype, accum)
            params = random_jax_params(jcfg.model, seed=11)
            state = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                             opt_state=jax_init(params), step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
            step = jax.jit(jax_make_train_step(jcfg))
            metrics = []
            for imgs, labels in batches(jcfg):
                state, m = step(state, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
                metrics.append({k: float(m[k]) for k in METRICS})
            out[dtype, accum] = (params, jax.tree_util.tree_map(np.asarray, state.params), metrics)
    return out


@pytest.mark.parametrize("dtype,accum", CASES)
def test_two_train_steps_match_jax(jax_two_steps, dtype, accum):
    """Parameters and metrics after two steps.

    The first Adam steps move each weight by about ±lr (= 1e-3) whatever the
    gradient's size, so a weight whose gradient is near zero can move the
    other way on a rounding difference; the bounds are on the UPDATES
    (after − before), relative to JAX's, and per element only in fp32.

    * fp32: the same math and rounding points, summation order only —
      metrics rtol 1e-4; every weight within 1e-4 (a tenth of lr; measured
      3.4e-5); the update of the whole model within 1e-5 relative L2
      (measured 1.5e-6).
    * bf16: bf16 roundings through 2 layers of forward and backward —
      metrics rtol 3e-2 (measured 3e-4); the whole model's update within
      3e-2 relative L2 (measured 6e-3); each parameter's within 0.3
      (measured up to 0.17, on the 128-element sqk and alpha vectors, where
      a few sign flips of near-zero steps dominate)."""
    params0, jax_params, jax_metrics = jax_two_steps[dtype, accum]
    _, cfg = slice_configs(dtype, accum)
    assert_two_steps_match(cfg, params0, jax_params, jax_metrics, 1e-5 if dtype == "float32" else 3e-2)


def assert_two_steps_match(cfg, params0, jax_params, jax_metrics, update_rel_l2):
    """Two port steps from ``params0`` on ``batches``: metrics, every
    parameter and the whole update against JAX's (see the callers' bounds)."""
    dtype = cfg.system.dtype
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params0, cfg.model), strict=True)
    state = TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters()),
                       step=0, generator=torch.Generator())
    step = make_train_step(cfg)
    metrics = []
    for imgs, labels in batches(cfg):
        state, m = step(state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
        metrics.append({k: float(m[k]) for k in METRICS})
    assert state.step == 2 and state.opt_state.count == 2

    rtol = 1e-4 if dtype == "float32" else 3e-2
    for got, want in zip(metrics, jax_metrics):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)

    before = state_dict_from_jax(params0, cfg.model)
    want = state_dict_from_jax(jax_params, cfg.model)
    got = {n: p.detach() for n, p in state.model.named_parameters()}
    diff2 = ref2 = 0.0
    moved = 0
    for name, w in want.items():
        d_got, d_want = got[name] - before[name], w - before[name]
        diff2 += float(torch.sum((d_got - d_want) ** 2))
        ref2 += float(torch.sum(d_want ** 2))
        if dtype == "float32":
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-4, err_msg=name)
        elif d_want.norm() > 0:
            assert (d_got - d_want).norm() <= 0.3 * d_want.norm(), name
        moved += int(not torch.equal(got[name], before[name]))
    assert diff2 ** 0.5 <= update_rel_l2 * ref2 ** 0.5
    assert moved > len(want) // 2  # the steps really moved the weights


# ------------------------------------------------------------------ bias
BIAS_MODES = {"nvit": dict(bias=True), "baseline": dict(bias=True, use_nvit=False)}


@pytest.fixture(scope="module")
def jax_bias_steps():
    """Per mode, fp32, bias=True: the JAX parameters, one step's gradients
    (``jax.grad`` of ``make_train_step``'s own loss on the first batch), and
    the parameters and metrics after two steps.  Baseline's q/k weights are
    ×5 (``baseline_params``)."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.state import TrainState as JaxState
    from nvit_tpu.train.step import make_loss_fn as jax_make_loss_fn
    from nvit_tpu.train.step import make_train_step as jax_make_train_step
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    out = {}
    with force_on_tpu(), generic_interpret_mode():
        for mode, kw in BIAS_MODES.items():
            jcfg, _ = slice_configs("float32", 1, **kw)
            params = (baseline_params if mode == "baseline" else random_jax_params)(jcfg.model, seed=13)
            data = [(jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels)) for imgs, labels in batches(jcfg)]
            loss_fn = jax_make_loss_fn(jcfg)
            grads = jax.jit(jax.grad(lambda p, x, y: loss_fn(p, x, y, jnp.zeros((), jnp.int32))[0]))(
                params, *data[0])
            state = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                             opt_state=jax_init(params), step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
            step = jax.jit(jax_make_train_step(jcfg))
            metrics = []
            for x, y in data:
                state, m = step(state, x, y)
                metrics.append({k: float(m[k]) for k in METRICS})
            out[mode] = (params, jax.tree_util.tree_map(np.asarray, grads),
                         jax.tree_util.tree_map(np.asarray, state.params), metrics)
    return out


@pytest.mark.parametrize("mode", BIAS_MODES)
def test_two_train_steps_with_bias_match_jax(jax_bias_steps, mode):
    """bias=True, fp32: the bounds of the fp32 case above — metrics rtol
    1e-4, every weight within 1e-4 — and the whole update within 1e-5
    relative L2 in nViT, 1e-4 in baseline (whose d skip_param is a
    cancellation, tests/test_torch_baseline.py)."""
    params0, _, jax_params, jax_metrics = jax_bias_steps[mode]
    _, cfg = slice_configs("float32", 1, **BIAS_MODES[mode])
    assert_two_steps_match(cfg, params0, jax_params, jax_metrics, 1e-5 if mode == "nvit" else 1e-4)


@pytest.mark.parametrize("mode", BIAS_MODES)
def test_bias_and_suv_gradients_match_jax(jax_bias_steps, mode):
    """One step's gradients, fp32, of every bias — the gated c_fc and
    cross-attention proj biases through K6's db, in nViT the c_fc bias
    through the suv fold — and of suv, which the folded bias reaches too,
    against ``jax.grad`` of the JAX step's loss: each within 1e-4 relative
    L2 (summation order only; measured ≤ 1e-6).  A gradient below 1e-6 of
    the largest is a cancellation that rounding decides, and must only stay
    that small: in baseline the key biases' (exactly 0 — softmax ignores a
    shift of every score in a row; measured 1e-11) and the blocks' query
    biases' (1e-8: the cross-attention hands the blocks near-equal tokens)."""
    from nvit_tpu_torch.train.step import make_loss_fn

    params0, grads, _, _ = jax_bias_steps[mode]
    _, cfg = slice_configs("float32", 1, **BIAS_MODES[mode])
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params0, cfg.model), strict=True)
    imgs, labels = batches(cfg)[0]
    loss, _ = make_loss_fn(cfg)(model, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels).long())
    loss.backward()
    want = state_dict_from_jax(grads, cfg.model)
    got = dict(model.named_parameters())
    names = [n for n in want if n.endswith(".bias") or n.endswith(".suv")]
    assert "cross_attention.proj.bias" in names and "transformer.h.1.c_fc.bias" in names
    assert any(n.endswith(".suv") for n in names) == (mode == "nvit")
    floor = 1e-6 * max(float(want[n].norm()) for n in names)
    checked = 0
    for name in names:
        g = torch.zeros_like(want[name]) if got[name].grad is None else got[name].grad
        if want[name].norm() <= floor:  # a cancellation, or outside the loss (reconstruction)
            assert g.norm() <= floor, name
            continue
        rel = float((g - want[name]).norm() / want[name].norm())
        assert rel <= 1e-4, f"{name}: relative L2 {rel:.3e}"
        checked += 1
    assert checked >= len(names) - (1 if mode == "nvit" else 7)
