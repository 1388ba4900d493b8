"""The baseline model (``use_nvit=False``) against the JAX package on the CPU
(a companion of tests/test_torch_baseline.py): ``Block``,
``CrossAttentionBlock`` and ``ViT`` forwards against ``block_apply`` /
``cross_attention_apply`` / ``vit_apply``, on the plain path and on the
kernel path (the JAX package's Pallas kernels forced through the generic
interpreter, tests/kernel_force.py); ``state_dict_from_jax`` for a baseline
tree; two ``make_train_step`` steps against the JAX package's. Every
tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.models.blocks import block_apply, cross_attention_apply
from nvit_tpu.models.vit import vit_apply
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import decay_mask, init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from tests.torch_parity import baseline_params, port_config, random_jax_params
from tests.torch_baseline_cases import as_np, to_torch

torch.set_num_threads(1)


# ------------------------------------------------------------ model
def base_cfg(**kw):
    base = dict(image_size=16, n_layer=2, n_head=4, n_embd=128, num_classes=7,
                local_patch_size=4, global_patch_size=8, use_nvit=False, flash_attn=False)
    base.update(kw)
    return jax_schema.ViTConfig(**base)


def port_model(params, cfg):
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, port_config(cfg)), strict=True)
    return model.eval()


POLICY = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: summation order only; bf16: a few bf16 roundings through the chain
MODEL_TOL = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture(scope="module")
def jax_forwards():
    """JAX blocks and logits of one random baseline tree, plain and with the
    Pallas kernels forced (generic interpreter), per policy."""
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    params = baseline_params(base_cfg(), seed=5)
    rng = np.random.default_rng(6)
    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    acts = [rng.standard_normal((2, 16, 128)).astype(np.float32) for _ in range(2)]
    out = {}
    for flash in (False, True):
        cfg = base_cfg(flash_attn=flash)
        with force_on_tpu(), generic_interpret_mode():
            for policy, (jdt, _) in POLICY.items():
                def fwd(p, x0, x1, x, cfg=cfg, jdt=jdt):  # one program per case
                    return (block_apply(p["blocks"][0], cfg, x0, compute_dtype=jdt),
                            cross_attention_apply(p["cross_attention"], cfg, x0, x1, compute_dtype=jdt),
                            vit_apply(p, cfg, x, compute_dtype=jdt).logits)

                got = jax.jit(fwd)(params, *(jnp.asarray(a).astype(jdt or jnp.float32) for a in acts),
                                   jnp.asarray(img))
                out[flash, policy] = [np.asarray(x, np.float32) for x in got]
    return params, img, acts, out


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_baseline_model_matches_jax(jax_forwards, flash, policy):
    """Block, CrossAttentionBlock and the whole ViT forward, baseline mode:
    the plain path (flash_attn=False) and the kernel path (K7 and K3 twins)
    against the JAX package's on the same weights and inputs."""
    params, img, acts, want = jax_forwards
    _, tdt = POLICY[policy]
    model = port_model(params, base_cfg(flash_attn=flash))
    x0, x1 = (to_torch(a, tdt or torch.float32) for a in acts)
    with torch.no_grad():
        blk = model.transformer["h"][0](x0, compute_dtype=tdt)
        cross = model.cross_attention(x0, x1, compute_dtype=tdt)
        logits = model(torch.from_numpy(img), compute_dtype=tdt)
    # the RMSNorm weight multiply promotes the residual stream to fp32
    assert blk.dtype == torch.float32 and logits.dtype == torch.float32
    for name, got, ref in zip(("block", "cross-attention", "logits"), (blk, cross, logits),
                              want[flash, policy]):
        np.testing.assert_allclose(as_np(got), ref, **MODEL_TOL[policy], err_msg=name)


def test_baseline_state_dict_keys_and_strict_load():
    """The baseline key set is state_dict_from_params' plus the blocks'
    RMSNorm weights, which that function drops; no sz and no scale vectors."""
    from nvit_tpu.ckpt.torch_interop import state_dict_from_params

    cfg = base_cfg()
    params = random_jax_params(cfg, seed=7)
    ours = state_dict_from_jax(params, port_config(cfg))
    ref = state_dict_from_params(params, cfg, warn_dropped=False)
    block_norms = {f"transformer.h.{i}.{n}.weight" for i in range(cfg.n_layer)
                   for n in ("rmsnorm_att", "rmsnorm_mlp")}
    assert set(ours) == set(ref) | block_norms and not set(ref) & block_norms
    assert not any(k.endswith(("sz", "sqk", "suv", "alpha")) for k in ours)
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key], err_msg=key)
    for i in range(cfg.n_layer):
        np.testing.assert_array_equal(ours[f"transformer.h.{i}.rmsnorm_att.weight"].numpy(),
                                      params["blocks"][i]["rmsnorm_att"])
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)
    fresh = ViT(port_config(cfg), device="cpu").init_weights(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, torch.ones_like(p)) for n, p in fresh.named_parameters() if "norm.weight" in n
               and not n.startswith("mlp_head"))


def test_baseline_decay_mask_leaves_norm_weights_undecayed():
    from nvit_tpu.train.optim import decay_mask as jax_decay_mask

    cfg = base_cfg()
    params = random_jax_params(cfg)
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  jax_decay_mask(params), params)
    want = {n: bool(t.flatten()[0]) for n, t in state_dict_from_jax(mask, port_config(cfg)).items()}
    model = ViT(port_config(cfg), device="cpu")
    assert decay_mask(model.named_parameters()) == want
    assert not want["transformer.h.0.rmsnorm_att.weight"] and not want["cross_attention.local_norm.weight"]


# ------------------------------------------------------------ training
BATCH = 4
TRAIN_CASES = ["float32", "bfloat16"]
METRICS = ("class_loss", "total_loss", "reconstruction", "grad_norm", "learning_rate")


def train_configs(dtype):
    """(JAX Config, port Config) of a 2-layer baseline model on the kernel
    path, field for field equal; accumulation 1."""
    sections = dict(
        model=dict(image_size=16, n_layer=2, n_head=4, n_embd=128, num_classes=10,
                   local_patch_size=4, global_patch_size=8, use_nvit=False, flash_attn=True),
        training=dict(batch_size=BATCH),
        optimizer=dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0, lr_decay_iters=10),
        system=dict(remat=False, dtype=dtype, log_gpu_stats=True),
    )

    def build(mod):
        return mod.Config(model=mod.ViTConfig(**sections["model"]),
                          training=mod.TrainingConfig(**sections["training"]),
                          optimizer=mod.OptimizerConfig(**sections["optimizer"]),
                          system=mod.SystemConfig(**sections["system"]))

    return build(jax_schema), build(port_schema)


def train_batches():
    rng = np.random.default_rng(31)
    return [(rng.integers(0, 256, (BATCH, 3, 16, 16), dtype=np.uint8),
             rng.integers(0, 10, BATCH).astype(np.int32)) for _ in range(2)]


@pytest.fixture(scope="module")
def jax_two_steps():
    """JAX parameters and metrics after two baseline steps per policy."""
    from nvit_tpu.train.optim import init_fused_adamw as jax_init
    from nvit_tpu.train.state import TrainState as JaxState
    from nvit_tpu.train.step import make_train_step as jax_make_train_step
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    out = {}
    with force_on_tpu(), generic_interpret_mode():
        for dtype in TRAIN_CASES:
            jcfg, _ = train_configs(dtype)
            params = baseline_params(jcfg.model, seed=12)
            state = JaxState(params=jax.tree_util.tree_map(jnp.asarray, params),
                             opt_state=jax_init(params), step=jnp.zeros((), jnp.int32),
                             rng=jax.random.PRNGKey(0))
            step = jax.jit(jax_make_train_step(jcfg))
            metrics = []
            for imgs, labels in train_batches():
                state, m = step(state, jax_normalize(jnp.asarray(imgs)), jnp.asarray(labels))
                metrics.append({k: float(m[k]) for k in METRICS})
            out[dtype] = (params, jax.tree_util.tree_map(np.asarray, state.params), metrics)
    return out


@pytest.mark.parametrize("dtype", TRAIN_CASES)
def test_two_baseline_train_steps_match_jax(jax_two_steps, dtype):
    """Parameters and metrics after two steps (no renorm in baseline).  The
    bounds are on the UPDATES (after − before), relative to JAX's, as in
    tests/test_torch_train.py.  One step's fp32 gradients agree to ~3e-7
    relative, except skip_param's: the baseline block returns x + …, with
    x = rms_norm(h) ∝ h, so norm_skip's justnorm VJP (⟂ its input) leaves
    d skip_param a cancellation (measured 1e-2 relative in fp32), and Adam
    passes that on.  bf16 gradients agree to ~1e-2 (bf16 roundings through 2
    layers).
    * fp32: metrics rtol 1e-4; every weight within 1e-4 (a tenth of lr); the
      whole update within 1e-4 relative L2 (measured 2.1e-5).
    * bf16: metrics rtol 3e-2; the whole update within 0.1 relative L2
      (measured 0.068) and each parameter's within 0.3 (measured ≤ 0.12)."""
    params0, jax_params, jax_metrics = jax_two_steps[dtype]
    _, cfg = train_configs(dtype)
    model = ViT(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax(params0, cfg.model), strict=True)
    state = TrainState(model=model, opt_state=init_fused_adamw(model.named_parameters()),
                       step=0, generator=torch.Generator())
    step = make_train_step(cfg)
    metrics = []
    for imgs, labels in train_batches():
        state, m = step(state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
        metrics.append({k: float(m[k]) for k in METRICS})

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
    assert diff2 ** 0.5 <= (1e-4 if dtype == "float32" else 0.1) * ref2 ** 0.5
    assert moved > len(want) // 2


def test_trainer_trains_baseline(tmp_path):
    """The Trainer runs baseline mode end to end on tiny synthetic data: no
    sqk drift metrics and no per-block scale columns in ``stat``."""
    import json

    from nvit_tpu_torch.obs.metrics import hparams_str
    from nvit_tpu_torch.train.trainer import Trainer

    cfg = port_schema.Config(
        model=port_schema.ViTConfig(image_size=16, n_layer=1, n_head=4, n_embd=128, num_classes=10,
                                    local_patch_size=4, global_patch_size=8, use_nvit=False,
                                    flash_attn=True),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2,
                                            log_interval=2, eval_iters=1,
                                            always_save_checkpoint=False),
        optimizer=port_schema.OptimizerConfig(warmup_iters=1, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=False, dtype="float32", quick_validation_size=8),
        data=port_schema.DataConfig(dataset="synthetic", out_dir=str(tmp_path),
                                    augmentation=port_schema.AugmentationConfig(auto_augment=False)),
    )
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    evals = [x for x in lines if "val/loss" in x]
    logs = [x for x in lines if "train/batch_loss" in x]
    assert [x["train/iter"] for x in logs] == [2, 4] and len(evals) == 2
    assert all(np.isfinite(x["train/batch_loss"]) for x in logs)
    assert not any(k.startswith("scales/") for x in evals for k in x)
    assert hparams_str(trainer.state.model, cfg) == ""
    assert (tmp_path / "finished").read_text() == "max_iters:4"
    assert trainer._sqk_drift_metrics() == {}
