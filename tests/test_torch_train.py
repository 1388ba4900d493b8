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
* the data path: ``make_synthetic`` arrays, epoch order and batches equal to
  the JAX package's;
* the trainer: a few iterations on tiny synthetic data write
  ``metrics.jsonl``; several devices and orbax checkpoints raise at
  construction, and the checkpoint settings, ported since, are taken; the
  datasets, ported since, read their files or name the missing layout.
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
    from nvit_tpu_torch.data.pipeline import device_prefetch, iterate_array

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
    x, y = next(device_prefetch(iter(got[:1]), "cpu"))
    assert x.dtype == torch.uint8 and y.dtype == torch.int64


def test_preprocess_normalizes_and_autoaugment_raises():
    """AutoAugment is ported (tests/test_torch_autoaugment.py): a train
    batch with a generator is augmented, then normalized; without one, or
    with AutoAugment off, or for eval, preprocess is the JAX normalize."""
    from nvit_tpu_torch.data.autoaugment import auto_augment_batch, step_generator

    imgs = torch.from_numpy(np.random.default_rng(23).integers(0, 256, (8, 3, 8, 8), dtype=np.uint8))
    np.testing.assert_array_equal(preprocess(imgs, train=True, auto_augment=False).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(imgs.numpy()))))
    assert torch.equal(preprocess(imgs, train=False), normalize(imgs))
    key = np.array([0, 1], np.uint32)
    augmented = preprocess(imgs, step_generator(key, 3), train=True, auto_augment=True, dataset="cifar100")
    assert torch.equal(augmented, normalize(auto_augment_batch(imgs, step_generator(key, 3), dataset="cifar100")))
    assert not torch.equal(augmented, normalize(imgs))


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


def test_entry_points_default_to_the_card(tmp_path):
    """Predictor, Predictor.from_config and Trainer run on the card unless
    the caller asks for the CPU: built with the default device where there
    is no card, each fails for want of CUDA instead of making a CPU model."""
    import inspect

    from nvit_tpu_torch.infer import Predictor

    for fn in (Predictor.__init__, Predictor.from_config, Trainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__
    if torch.cuda.is_available():
        return
    cfg = trainer_config(tmp_path)
    for build in (lambda: Predictor(ViT(cfg.model, device="cpu"), cfg.model),
                  lambda: Predictor.from_config(cfg), lambda: Trainer(cfg)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()


@pytest.mark.parametrize("kw", [dict(init_from="resume"), dict(eval_only=True),
                                dict(always_save_checkpoint=True)])
def test_trainer_takes_the_checkpoint_settings(tmp_path, kw):
    """Ported with the checkpoint files (tests/test_torch_ckpt.py has the
    lifecycle): each setting is taken, and init_from="resume" restores the
    checkpoint a Trainer wrote, which a fresh init does not reproduce."""
    first = Trainer(trainer_config(tmp_path), device="cpu")
    with torch.no_grad():
        for p in first.state.model.parameters():
            p.add_(1.0)
    first.save()
    first.cleanup()  # joins the write
    trainer = Trainer(trainer_config(tmp_path, training=kw, data=dict(checkpoint_dir=str(tmp_path))),
                      device="cpu")
    ((field, value),) = kw.items()
    assert getattr(trainer.cfg.training, field) == value
    restored = all(torch.equal(a, b) for a, b in
                   zip(first.state.model.parameters(), trainer.state.model.parameters()))
    assert restored == (field == "init_from")


@pytest.mark.parametrize("section,kw,item", [
    ("system", dict(model_parallel=2), "multi-GPU"),
    ("data", dict(checkpoint_backend="orbax"), "do-not-port"),
])
def test_trainer_refuses_unported_settings(tmp_path, section, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Trainer(trainer_config(tmp_path, **{section: kw}), device="cpu")


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "imagenet", "digits"])
def test_unported_datasets_raise(tmp_path, name):
    """Every dataset is ported (tests/test_torch_data.py): without their
    files the CIFAR and ImageNet readers raise ``FileNotFoundError`` naming
    the layout; digits, bundled with scikit-learn, equal the JAX package's."""
    from nvit_tpu.data.datasets import load_dataset as jax_load_dataset
    from nvit_tpu_torch.data.datasets import load_dataset

    if name == "digits":
        got, want = load_dataset(name, tmp_path, image_size=16), jax_load_dataset(name, tmp_path, image_size=16)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        return
    with pytest.raises(FileNotFoundError, match="imagenet" if name == "imagenet" else "data.download=true"):
        load_dataset(name, tmp_path)


# ------------------------------------------------- the JAX trainer's warnings
@pytest.fixture
def port_log(caplog):
    """caplog on the port's logger: ``setup_logging`` resets the root
    logger's handlers (caplog's among them), not the named logger's."""
    import logging

    logger = logging.getLogger("nvit_tpu_torch")
    logger.addHandler(caplog.handler)
    yield caplog
    logger.removeHandler(caplog.handler)


def drift_warnings(log) -> list:
    return [r for r in log.records if "sqk_eff drifted" in r.getMessage()]


@pytest.mark.parametrize("mode,warned", [("bounded", 1), ("rowmax", 0), ("auto", 0)])
def test_sqk_drift_warns_once_under_bounded_only(tmp_path, port_log, mode, warned):
    """≙ nvit_tpu/train/trainer.py:395-405: the bound past 40 is logged once
    per Trainer, and only under the static "bounded" stabilizer."""
    trainer = Trainer(trainer_config(tmp_path, model=dict(bounded_softmax=mode)), device="cpu")
    first = trainer._sqk_drift_metrics()
    with torch.no_grad():  # scale every sqk so that the bound passes 40
        factor = float(np.sqrt(2 * 40.0 / first["scales/attn_bound"]))
        for name, p in trainer.state.model.named_parameters():
            if name.endswith("sqk"):
                p.mul_(factor)
    port_log.clear()
    metrics = [trainer._sqk_drift_metrics() for _ in range(2)]
    assert all(m["scales/attn_bound"] > 40.0 for m in metrics)
    assert len(drift_warnings(port_log)) == warned
    if warned:
        assert f"{metrics[0]['scales/sqk_eff_max']:.2f}" in drift_warnings(port_log)[0].getMessage()


def test_quick_validation_without_full_eval_warns_at_construction(tmp_path, port_log):
    """≙ nvit_tpu/train/trainer.py:288-299."""
    Trainer(trainer_config(tmp_path, system=dict(quick_validation=True),
                           training=dict(full_eval_interval=0)), device="cpu")
    assert any("quick_validation is on with full_eval_interval=0" in r.getMessage()
               for r in port_log.records)
    port_log.clear()
    Trainer(trainer_config(tmp_path, training=dict(full_eval_interval=2)), device="cpu")
    assert not any("quick_validation" in r.getMessage() for r in port_log.records)
