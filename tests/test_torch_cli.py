"""The port's entry points and config loader against the JAX package's, on the CPU.

* ``nvit_tpu_torch.configs.load_config`` equals ``nvit_tpu.configs.loader.
  load_config`` on the same YAML, ``secrets.yaml``, ``.env``, environment
  and overrides (and ``get_secret`` its ``get_secret``); the port's
  ``settings.yaml`` parses equal to the JAX package's;
* ``python -m nvit_tpu_torch``'s ``main()`` in this process: a tiny synthetic
  run configured by ``NVIT_*`` variables, its resume and ``eval_only``; the
  packaged defaults and ``NVIT_MULTIHOST=1`` refused by name;
* ``python -m nvit_tpu_torch.ckpt.export``'s ``main`` in this process;
* the serve CLI: ``--aot``, ``--int8``, ``--data-parallel`` and
  ``--model-parallel 2`` refused by name, and one run in a subprocess on
  the CPU (an export served over HTTP, SIGHUP reload, SIGTERM drain);
* ``InferenceService.warmup(all_buckets=True)`` runs the JAX package's
  bucket ladder.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import nvit_tpu.configs.loader as jax_loader
import nvit_tpu.serve as jax_serve
import nvit_tpu_torch.configs.loader as port_loader
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.infer import Predictor
from nvit_tpu_torch.serve import InferenceService
from nvit_tpu_torch.serve import main as serve_main
from nvit_tpu_torch.train.state import create_train_state
from nvit_tpu_torch.train.trainer import main as train_main

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_environment(monkeypatch):
    """No NVIT_SECTION__KEY variable of the caller's leaks into a config."""
    for key in list(os.environ):
        if key.startswith("NVIT_"):
            monkeypatch.delenv(key)


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
    small batch; several processes are still refused."""
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
    monkeypatch.setenv("NVIT_MULTIHOST", "1")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        train_main()


# ------------------------------------------------------------ export, serve
def tiny_checkpoint(out_dir: Path) -> port_schema.Config:
    cfg = port_schema.Config(model=port_schema.ViTConfig(
        image_size=16, n_layer=1, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
        global_patch_size=8, use_nvit=True))
    port_ckpt.save_checkpoint(out_dir, "checkpoint_best", create_train_state(cfg, device="cpu"), cfg)
    return cfg


def test_export_cli(tmp_path, capsys):
    tiny_checkpoint(tmp_path)
    port_export.main(["--checkpoint", str(tmp_path), "--dest", str(tmp_path / "deploy")])
    assert "exported" in capsys.readouterr().out
    sd, _ = port_export.load_export(tmp_path / "deploy", "checkpoint_best")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    with pytest.raises(NotImplementedError, match="int8 serving"):
        port_export.main(["--checkpoint", str(tmp_path), "--dest", str(tmp_path), "--dtype", "int8"])


@pytest.mark.parametrize("flags,item", [
    (["--aot"], "the remaining entry points"), (["--int8"], "int8 serving"),
    (["--data-parallel"], "multi-GPU"), (["--model-parallel", "2"], "multi-GPU"),
])
def test_serve_cli_refuses_unported_options(capsys, flags, item):
    with pytest.raises(SystemExit) as exit_info:
        serve_main(flags)
    assert exit_info.value.code == 2 and item in capsys.readouterr().err


@pytest.mark.parametrize("max_batch", [1, 5, 8, 24])
def test_warmup_all_buckets_is_the_jax_ladder(tmp_path, max_batch):
    tiny_checkpoint(tmp_path)
    pred = Predictor.from_checkpoint(tmp_path, device="cpu")
    batches = []
    run = pred.predict_probs
    pred.predict_probs = lambda x: batches.append(len(x)) or run(x)
    service = InferenceService(pred, max_batch=max_batch, builder=lambda: pred)
    service.warmup()
    assert service._bucket_sizes() == [1] and batches == [1]
    service.warmup(all_buckets=True)
    want = jax_serve.InferenceService._bucket_sizes(
        SimpleNamespace(_pinned=None, _warm_all=True, max_batch=max_batch))
    assert service._bucket_sizes() == want and batches[1:] == want
    assert service.stats.device_programs == 0  # warmup is not traffic
    del batches[:]
    service.reload()  # the replacement is warmed on the same ladder
    assert batches == want


def test_serve_cli_in_a_subprocess(tmp_path):
    """An export served over HTTP on the CPU: /predict against the same
    export in this process, SIGHUP reloads it, SIGTERM drains and exits 0."""
    tiny_checkpoint(tmp_path)
    port_export.export_for_inference(tmp_path, "checkpoint_best", tmp_path / "deploy")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nvit_tpu_torch.serve", "--export", "--checkpoint", str(tmp_path / "deploy"),
         "--port", "0", "--device", "cpu", "--max-batch", "4", "--warm-buckets"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()

    def wait_for(*texts: str) -> str:
        while True:
            line = lines.get(timeout=120)
            if line.startswith(texts):
                return line

    try:
        port = int(wait_for("serving").rsplit(":", 1)[1])
        image = np.random.default_rng(0).integers(0, 256, (3, 16, 16), dtype=np.uint8)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict", body=json.dumps({"images": image.tolist(), "top_k": 10}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        served = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        probs = Predictor.from_export(tmp_path / "deploy", device="cpu").predict_probs(image[None])[0]
        np.testing.assert_allclose(served["probs"][0], probs[served["labels"][0]], rtol=1e-6)
        proc.send_signal(signal.SIGHUP)
        assert wait_for("reloaded", "reload failed").startswith("reloaded")
        proc.send_signal(signal.SIGTERM)
        wait_for("drained; exiting")
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
