"""The port's training slice against the JAX package, end to end on the CPU.

* the whole slice: ``nvit-tiny4`` at 2 layers with ``flash_attn=True``,
  batch 4, gradient accumulation 1 and 2, two ``make_train_step`` steps in
  the fp32 and bf16 policies — the port (K1–K4 twins on the CPU) against
  ``nvit_tpu.train.step.make_train_step`` with the Pallas kernels forced
  through the generic interpreter (tests/kernel_force.py); parameters and
  metrics are compared after the two steps;
* the data path: ``make_synthetic`` arrays, epoch order and batches equal to
  the JAX package's;
* the trainer: a few iterations on tiny synthetic data write
  ``metrics.jsonl``; every unported setting raises at construction.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.data.augment import normalize, preprocess
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import init_fused_adamw
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.step import make_train_step
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_parity import random_jax_params

torch.set_num_threads(1)

BATCH = 4


def slice_configs(dtype: str, accum: int):
    """(JAX Config, port Config) of the tiny slice, field for field equal."""
    model = preset("nvit-tiny4")
    model.update(n_layer=2, num_classes=10, flash_attn=True)
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
    assert diff2 ** 0.5 <= (1e-5 if dtype == "float32" else 3e-2) * ref2 ** 0.5
    assert moved > len(want) // 2  # the steps really moved the weights


# ------------------------------------------------------------------ data
def test_make_synthetic_is_the_jax_draw():
    """The chunked draw yields the JAX package's arrays from the same seed
    (32 px, one chunk boundary crossed with a small chunk)."""
    from nvit_tpu.data.datasets import make_synthetic as jax_make_synthetic
    from nvit_tpu_torch.data import datasets

    want = jax_make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3)
    got = datasets.make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    saved = datasets._NOISE_CHUNK
    datasets._NOISE_CHUNK = 3 * 32 * 32 * 7  # 7 images per chunk
    try:
        np.testing.assert_array_equal(
            datasets.make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3).images,
            want.images)
    finally:
        datasets._NOISE_CHUNK = saved


def test_epoch_order_and_batches_are_the_jax_pipeline():
    from nvit_tpu.data.datasets import ArrayDataset as JaxArrayDataset
    from nvit_tpu.data.pipeline import iterate_array as jax_iterate
    from nvit_tpu_torch.data.datasets import ArrayDataset
    from nvit_tpu_torch.data.pipeline import iterate_array, to_device

    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (37, 3, 4, 4), dtype=np.uint8)
    labels = rng.integers(0, 5, 37).astype(np.int32)
    for kw in (dict(epoch=2, shuffle=True), dict(epoch=0, shuffle=False, drop_last=False),
               dict(epoch=1, shuffle=True, start_batch=2)):
        want = list(jax_iterate(JaxArrayDataset(imgs, labels, 5), batch_size=8, seed=4, **kw))
        got = list(iterate_array(ArrayDataset(imgs, labels, 5), batch_size=8, seed=4, **kw))
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    x, y = to_device(got[0], torch.device("cpu"))
    assert x.dtype == torch.uint8 and y.dtype == torch.int64


def test_preprocess_normalizes_and_autoaugment_raises():
    imgs = torch.from_numpy(np.random.default_rng(23).integers(0, 256, (2, 3, 4, 4), dtype=np.uint8))
    np.testing.assert_array_equal(preprocess(imgs, train=True, auto_augment=False).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(imgs.numpy()))))
    assert torch.equal(preprocess(imgs, train=False), normalize(imgs))
    with pytest.raises(NotImplementedError, match="AutoAugment"):
        preprocess(imgs, train=True, auto_augment=True)


# ------------------------------------------------------------------ trainer
def trainer_config(out_dir, **overrides):
    model = preset("nvit-tiny4")
    model.update(n_layer=1, num_classes=10, image_size=16, flash_attn=True)
    cfg = port_schema.Config(
        model=port_schema.ViTConfig(**model),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=6, eval_interval=4,
                                            log_interval=2, eval_iters=2,
                                            always_save_checkpoint=False),
        optimizer=port_schema.OptimizerConfig(warmup_iters=2, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=False, dtype="float32", quick_validation_size=16),
        data=port_schema.DataConfig(dataset="synthetic", out_dir=str(out_dir),
                                    augmentation=port_schema.AugmentationConfig(auto_augment=False)),
    )
    for section, kw in overrides.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
    return cfg


def test_trainer_writes_metrics_and_finishes(tmp_path):
    trainer = Trainer(trainer_config(tmp_path), device="cpu")
    trainer.train()
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    evals = [x for x in lines if "val/loss" in x]
    logs = [x for x in lines if "train/batch_loss" in x]
    assert [x["_step"] for x in evals] == [0, 4]
    assert [x["train/iter"] for x in logs] == [2, 4, 6]
    for x in logs:
        assert np.isfinite([x["train/batch_loss"], x["train/class_loss"], x["train/grad_norm"],
                            x["optimizer/learning_rate"], x["train/batch_time_ms"]]).all()
        assert "train/mfu" in x and x["train/mfu"] is None  # no device peak on the CPU
    assert np.isfinite([evals[-1]["val/loss"], evals[-1]["train/loss"]]).all()
    assert (tmp_path / "finished").read_text() == "max_iters:6"
    assert len((tmp_path / "stat").read_text().splitlines()) == 3
    assert trainer.iter_num == 6 and trainer.state.step == 6


@pytest.mark.parametrize("section,kw,item", [
    ("training", dict(init_from="resume"), "checkpoint files"),
    ("training", dict(eval_only=True), "checkpoint files"),
    ("training", dict(always_save_checkpoint=True), "checkpoint files"),
    ("wandb", dict(mode="offline"), "wandb"),
    ("data", dict(augmentation=port_schema.AugmentationConfig()), "AutoAugment"),
    ("data", dict(dataset="cifar100"), "datasets"),
    ("system", dict(remat=True), "remat"),
    ("optimizer", dict(moments_dtype="bfloat16"), "bf16 moments"),
    ("system", dict(model_parallel=2), "multi-GPU"),
    ("system", dict(profile_steps=2), "observability"),
    ("model", dict(use_kohonen=True), "Kohonen"),
    ("system", dict(debug_nans=True), "observability"),
])
def test_trainer_refuses_unported_settings(tmp_path, section, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(trainer_config(tmp_path, **{section: kw}), device="cpu")


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "imagenet", "digits"])
def test_unported_datasets_raise(tmp_path, name):
    from nvit_tpu_torch.data.datasets import load_dataset

    with pytest.raises(NotImplementedError, match="datasets and the data pipeline"):
        load_dataset(name, tmp_path)
