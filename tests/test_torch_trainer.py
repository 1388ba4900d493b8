"""The port's ``Trainer`` on the CPU (a companion of
tests/test_torch_train.py): a few iterations on tiny synthetic data write
``metrics.jsonl``; the entry points default to the card; several devices and
orbax checkpoints raise at construction, and the checkpoint settings are
taken; the JAX trainer's sqk drift and quick-validation warnings.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.models.presets import preset
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


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
    ("system", dict(model_parallel=2), "slice 16"),
    ("data", dict(checkpoint_backend="orbax"), "do-not-port"),
])
def test_trainer_refuses_unported_settings(tmp_path, section, kw, item):
    """Orbax stays refused by name; ``model_parallel=2`` on one rank, which
    slice 16 ported, raises JAX's ValueError (≙ trainer.py:99-104)."""
    error, match = {"slice 16": (ValueError, "model_parallel=2 requires a multi-device mesh"),
                    "do-not-port": (NotImplementedError, "do-not-port")}[item]
    with pytest.raises(error, match=match):
        Trainer(trainer_config(tmp_path, **{section: kw}), device="cpu")


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
