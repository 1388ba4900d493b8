"""Shared inputs, helpers and fixtures of tests/test_torch_cli.py,
tests/test_torch_cli_serve.py."""

import os
from pathlib import Path

import pytest

from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.train.state import create_train_state

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_environment(monkeypatch):
    """No NVIT_SECTION__KEY variable of the caller's leaks into a config."""
    for key in list(os.environ):
        if key.startswith("NVIT_"):
            monkeypatch.delenv(key)


# -------------------------------------------------------------- train CLI
TINY_ENV = {
    "NVIT_SYSTEM__DEVICE": "cpu", "NVIT_SYSTEM__DTYPE": "float32", "NVIT_SYSTEM__REMAT": "false",
    "NVIT_SYSTEM__QUICK_VALIDATION_SIZE": "8", "NVIT_SYSTEM__LOG_TO_FILE": "false",
    "NVIT_DATA__DATASET": "synthetic", "NVIT_DATA__AUGMENTATION__AUTO_AUGMENT": "false",
    "NVIT_MODEL__USE_KOHONEN": "false", "NVIT_MODEL__IMAGE_SIZE": "16", "NVIT_MODEL__N_LAYER": "1",
    "NVIT_MODEL__N_HEAD": "2", "NVIT_MODEL__N_EMBD": "64", "NVIT_MODEL__NUM_CLASSES": "10",
    "NVIT_MODEL__LOCAL_PATCH_SIZE": "4", "NVIT_MODEL__GLOBAL_PATCH_SIZE": "8",
    "NVIT_TRAINING__BATCH_SIZE": "8", "NVIT_TRAINING__MAX_ITERS": "4", "NVIT_TRAINING__EVAL_INTERVAL": "2",
    "NVIT_TRAINING__EVAL_ITERS": "1", "NVIT_TRAINING__LOG_INTERVAL": "2",
    "NVIT_OPTIMIZER__WARMUP_ITERS": "0",
}


@pytest.fixture
def tiny_run(tmp_path, monkeypatch):
    """The working directory and environment of a tiny CPU run of the CLI."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    env = {**TINY_ENV, "NVIT_DATA__OUT_DIR": str(out), "NVIT_DATA__CHECKPOINT_DIR": str(out)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    return out


# ------------------------------------------------------------ export, serve
def tiny_checkpoint(out_dir: Path) -> port_schema.Config:
    cfg = port_schema.Config(model=port_schema.ViTConfig(
        image_size=16, n_layer=1, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
        global_patch_size=8, use_nvit=True))
    port_ckpt.save_checkpoint(out_dir, "checkpoint_best", create_train_state(cfg, device="cpu"), cfg)
    return cfg
