"""The port's entry points and config loader against the JAX package's, on the
CPU.

* ``nvit_tpu_torch.configs.load_config`` equals ``nvit_tpu.configs.loader.
  load_config`` on the same YAML, ``secrets.yaml``, ``.env``, environment
  and overrides (and ``get_secret`` its ``get_secret``); the port's
  ``settings.yaml`` parses equal to the JAX package's;
* ``python -m nvit_tpu_torch``'s ``main()`` in this process: a tiny synthetic
  run configured by ``NVIT_*`` variables, its resume and ``eval_only``; the
  packaged defaults and ``NVIT_MULTIHOST=1`` refused by name;
* ``python -m nvit_tpu_torch.ckpt.export``'s ``main`` in this process, bf16
  and int8;
* the serve CLI: ``--data-parallel`` and ``--model-parallel 2`` serving,
  and one run in a subprocess on the CPU (an export served over HTTP,
  SIGHUP reload, SIGTERM drain); ``--int8`` and ``--aot`` are
  tests/test_torch_serving_modes.py;
* ``InferenceService.warmup(all_buckets=True)`` runs the JAX package's
  bucket ladder.

Companion files: tests/test_torch_cli_serve.py; shared inputs:
tests/torch_cli_cases.py.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import nvit_tpu.configs.loader as jax_loader
import nvit_tpu_torch.configs.loader as port_loader
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.train.trainer import main as train_main
from tests.torch_cli_cases import REPO, clean_environment, tiny_checkpoint, tiny_run  # noqa: F401 (autouse)

torch.set_num_threads(1)


# ----------------------------------------------------------------- loader
def test_packaged_settings_parse_equal_to_the_jax_package():
    port = yaml.safe_load((REPO / "nvit_tpu_torch/configs/settings.yaml").read_text())
    jax = yaml.safe_load((REPO / "nvit_tpu/configs/settings.yaml").read_text())
    assert port == jax


@pytest.mark.parametrize("case", ["packaged", "files"])
def test_loader_is_the_jax_loader(tmp_path, case):
    kw = dict(dotenv_path=tmp_path / ".env", secrets_file=tmp_path / "secrets.yaml", env={})
    settings = tmp_path / "missing.yaml"  # → the package's own settings.yaml
    if case == "files":
        settings = tmp_path / "settings.yaml"
        tree = yaml.safe_load((REPO / "nvit_tpu/configs/settings.yaml").read_text())
        tree["model"]["n_layer"] = 5
        tree["model"]["kohonen_scheduler"]["min_lr"] = 0.25
        settings.write_text(yaml.safe_dump(tree))
        (tmp_path / "secrets.yaml").write_text("wandb:\n  project: from-secrets\nwandb_api_key: k123\n")
        (tmp_path / ".env").write_text("# a comment\nNVIT_TRAINING__BATCH_SIZE=64\n"
                                       "NVIT_MODEL__N_HEAD='4'\n")
        kw["env"] = {"NVIT_MODEL__N_LAYER": "3", "NVIT_MODEL__KOHONEN_SCHEDULER_MIN_LR": "0.5",
                     "NVIT_DATA__AUGMENTATION__ENABLED": "false", "NVIT_OPTIMIZER__WEIGHT_DECAY": "1e-3",
                     "NVIT_WANDB_API_KEY": "not-a-config-key", "OTHER": "x"}
        kw["overrides"] = {"training": {"seed": 7}}
    port = port_loader.load_config(settings, **kw)
    jax = jax_loader.load_config(settings, **kw)
    assert port.to_dict() == jax.to_dict()
    if case == "files":
        assert (port.model.n_layer, port.model.n_head, port.training.batch_size) == (3, 4, 64)
        assert port.model.kohonen_scheduler_min_lr == 0.5 and port.wandb.project == "from-secrets"
        assert port_loader.get_secret("WANDB_API_KEY") == jax_loader.get_secret("WANDB_API_KEY") == "k123"


def test_loader_rejects_unknown_keys_like_the_jax_loader():
    for loader in (port_loader, jax_loader):
        with pytest.raises(KeyError, match="no_such_key"):
            loader.load_config(None, env={"NVIT_MODEL__NO_SUCH_KEY": "1"}, dotenv_path="/nonexistent",
                               secrets_file="/nonexistent")


def test_train_cli_runs_resumes_and_evaluates(tiny_run, monkeypatch):
    train_main()
    meta = port_ckpt.load_checkpoint_meta(tiny_run, "checkpoint_latest")
    assert meta["iter_num"] == 4 and meta["config"]["model"]["bias"] is True  # settings.yaml's
    assert (tiny_run / "finished").read_text() == "max_iters:4"
    lines = [json.loads(x) for x in (tiny_run / "metrics.jsonl").read_text().splitlines()]
    assert [x["train/iter"] for x in lines if "train/batch_loss" in x] == [2, 4]
    monkeypatch.setenv("NVIT_TRAINING__INIT_FROM", "resume")
    monkeypatch.setenv("NVIT_TRAINING__MAX_ITERS", "6")
    train_main()
    assert port_ckpt.load_checkpoint_meta(tiny_run, "checkpoint_latest")["iter_num"] == 6
    assert (tiny_run / "finished").read_text() == "max_iters:6"
    monkeypatch.setenv("NVIT_TRAINING__EVAL_ONLY", "true")
    train_main()  # validation only: no step, no save
    assert port_ckpt.load_checkpoint_meta(tiny_run, "checkpoint_latest")["iter_num"] == 6


def test_train_cli_refuses_the_packaged_defaults_and_multihost(tmp_path, monkeypatch):
    """The packaged settings.yaml — CIFAR-100 files, AutoAugment, remat,
    biases and the Kohonen SOM — trains as it is, on a tiny CIFAR tree at a
    small batch.  Under NVIT_MULTIHOST=1 with the JAX coordinator variables
    the same command re-executes itself under torch.distributed.run, one
    process per card of this "host" (tests/test_torch_dp_cli.py runs it)."""
    from tests.test_torch_remat import write_cifar100

    monkeypatch.chdir(tmp_path)
    write_cifar100(tmp_path / "data", n_train=32, n_test=16)
    for k, v in {"NVIT_SYSTEM__DEVICE": "cpu", "NVIT_TRAINING__BATCH_SIZE": "16",
                 "NVIT_TRAINING__MAX_ITERS": "2", "NVIT_TRAINING__EVAL_INTERVAL": "2",
                 "NVIT_TRAINING__EVAL_ITERS": "1", "NVIT_TRAINING__LOG_INTERVAL": "1",
                 "NVIT_SYSTEM__QUICK_VALIDATION_SIZE": "16", "NVIT_DATA__NUM_WORKERS": "1"}.items():
        monkeypatch.setenv(k, v)
    train_main()
    meta = port_ckpt.load_checkpoint_meta(tmp_path / "out", "checkpoint_latest")
    model = meta["config"]["model"]
    assert meta["iter_num"] == 2 and model["use_kohonen"] and model["bias"] and model["kohonen_nodes"] == 64
    assert meta["config"]["system"]["remat"] and meta["config"]["data"]["augmentation"]["auto_augment"]
    lines = [json.loads(x) for x in (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    evals = [x for x in lines if "val/loss" in x]
    assert evals and all(np.isfinite(evals[-1][f"val/{k}"]) for k in (
        "consistency_loss", "smoothness_loss", "local_quantization_loss", "global_quantization_loss"))
    for k, v in {"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": "localhost:1234",
                 "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    launched = []

    def execv(path, argv):
        launched.append(argv)
        raise SystemExit(0)

    monkeypatch.setattr(os, "execv", execv)
    with pytest.raises(SystemExit):
        train_main()
    (argv,) = launched
    assert argv[1:] == ["-m", "torch.distributed.run", "--nnodes=2", "--node_rank=1", "--master_addr=localhost",
                        "--master_port=1234", "--nproc_per_node=1", "-m", "nvit_tpu_torch"]


def test_export_cli(tmp_path, capsys):
    tiny_checkpoint(tmp_path)
    port_export.main(["--checkpoint", str(tmp_path), "--dest", str(tmp_path / "deploy")])
    assert "exported" in capsys.readouterr().out
    sd, _ = port_export.load_export(tmp_path / "deploy", "checkpoint_best")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    port_export.main(["--checkpoint", str(tmp_path), "--dest", str(tmp_path / "int8"), "--dtype", "int8"])
    assert "exported" in capsys.readouterr().out
    sd, _ = port_export.load_export(tmp_path / "int8", "checkpoint_best")
    assert {v.dtype for k, v in sd.items() if k.endswith(".wq")} == {torch.int8}
    assert all(v.dtype == torch.float32 for k, v in sd.items() if not k.endswith(".wq"))
