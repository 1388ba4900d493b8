"""Shared inputs, helpers and fixtures of tests/test_torch_ckpt.py,
tests/test_torch_ckpt_restore.py, tests/test_torch_ckpt_lifecycle.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.train.optim import FusedAdamWState as JaxAdamWState
from nvit_tpu.train.state import TrainState as JaxTrainState
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_parity import random_jax_params

MODES = {  # the four parameter trees: nViT / baseline, without / with biases
    "nvit": dict(use_nvit=True), "baseline": dict(use_nvit=False),
    "nvit-bias": dict(use_nvit=True, bias=True), "baseline-bias": dict(use_nvit=False, bias=True),
}
FWD_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32 forward: summation order only (test_torch_slice.py)


def model_fields(mode: str) -> dict:
    return dict(image_size=16, n_layer=2, n_head=2, n_embd=32, num_classes=10,
                local_patch_size=4, global_patch_size=8, flash_attn=False, **MODES[mode])


def configs(mode: str):
    """(JAX Config, port Config), field for field equal."""
    m = model_fields(mode)
    return (jax_schema.Config(model=jax_schema.ViTConfig(**m)),
            port_schema.Config(model=port_schema.ViTConfig(**m)))


def jax_key(k):
    return getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))


# ----------------------------------------------------- JAX → port → JAX
def jax_state(jcfg, seed: int) -> JaxTrainState:
    """A JAX TrainState with random params and moments (numpy leaves)."""
    params = random_jax_params(jcfg.model, seed=seed)
    rng = np.random.default_rng(seed + 100)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), params)
    return JaxTrainState(params=params, opt_state=JaxAdamWState(count=np.int32(7), mu=mu, nu=nu),
                         step=np.int32(7), rng=np.array([12345, 678], np.uint32))


TRAINER_META = {"best_val_loss": 2.25, "early_stopping_counter": 3, "eval_count": 4}


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """mode → (directory, JAX state) of a checkpoint the JAX package wrote."""
    out = {}
    for i, mode in enumerate(MODES):
        jcfg, _ = configs(mode)
        d = tmp_path_factory.mktemp(f"jax_{mode}")
        state = jax_state(jcfg, seed=i)
        jax_ckpt.save_checkpoint(d, "checkpoint_latest", state, jcfg, {"val/loss": 2.25}, TRAINER_META)
        out[mode] = (d, state)
    return out


def assert_tensors_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- trainer
def trainer_config(out_dir, **sections):
    model = preset("nvit-tiny4")
    model.update(n_layer=1, num_classes=10, image_size=16, flash_attn=True)
    cfg = port_schema.Config(
        model=port_schema.ViTConfig(**model),
        training=port_schema.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2,
                                            log_interval=1, eval_iters=1),
        optimizer=port_schema.OptimizerConfig(warmup_iters=0, lr_decay_iters=10),
        system=port_schema.SystemConfig(remat=False, dtype="float32", quick_validation_size=8),
        data=port_schema.DataConfig(dataset="synthetic", out_dir=str(out_dir), checkpoint_dir=str(out_dir),
                                    augmentation=port_schema.AugmentationConfig(auto_augment=False)),
    )
    for section, kw in sections.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})
    return cfg


@pytest.fixture(scope="module")
def tiny_data():
    """The synthetic 16 px arrays, made once for the module's trainers."""
    from nvit_tpu_torch.data.datasets import load_dataset

    kw = dict(image_size=16, num_classes=10)
    return load_dataset("synthetic", "", train=True, **kw), load_dataset("synthetic", "", train=False, **kw)


@pytest.fixture
def trainer_with(tiny_data, monkeypatch):
    import nvit_tpu_torch.train.trainer as trainer_module

    monkeypatch.setattr(trainer_module, "load_dataset",
                        lambda name, data_dir, *, train, **kw: tiny_data[0 if train else 1])
    return lambda cfg: Trainer(cfg, device="cpu")


def leaves_of(out_dir, name="checkpoint_latest"):
    with np.load(out_dir / f"{name}.npz") as z:
        return [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]
