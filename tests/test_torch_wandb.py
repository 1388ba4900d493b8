"""The wandb sink, artifacts and ``init_from="wandb"`` of the port
(``obs/metrics.py``, ``train/trainer.py``) with a recording stand-in
``wandb`` module in ``sys.modules`` (the package is not installed), as
``tests/test_obs_and_entry.py`` and ``tests/test_trainer.py`` hold the JAX
package's:

* online: log in with the secret key, then ``wandb.init``; offline: no
  login; without the package: the JSONL sink alone and one warning;
* ``gradhist/*`` counts rendered as ``wandb.Histogram``s over the static edges;
* every ``checkpoint_best`` logged as an artifact of its npz and json, the
  previous version deleted;
* ``init_from="wandb"`` resumes from the artifact's ``checkpoint_best``, and
  raises offline, without the package, or without the checkpoint;
* the Trainer takes every setting this slice ported, all at once, with and
  without a wandb module.
"""

import json
import logging
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from nvit_tpu_torch.obs.metrics import WANDB_HIST_EDGES, MetricsWriter
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_ckpt_cases import trainer_config

torch.set_num_threads(1)


def stand_in(monkeypatch, download_dir: Path | None = None) -> dict:
    """Install a recording ``wandb`` module → its record of the calls."""
    calls = {"login": [], "init": [], "log": [], "finish": 0, "artifacts": [], "deleted": [], "requested": []}
    mod = types.ModuleType("wandb")
    mod.login = lambda key=None: calls["login"].append(key)
    mod.init = lambda **kw: calls["init"].append(kw)
    mod.log = lambda metrics, step=None: calls["log"].append((step, metrics))

    def finish():
        calls["finish"] += 1

    class Histogram:
        def __init__(self, np_histogram):
            self.np_histogram = np_histogram

    class Artifact:
        def __init__(self, name, type, metadata=None):
            self.name, self.type, self.metadata, self.files = name, type, metadata, []

        def add_file(self, path):
            self.files.append(Path(path))

    class Api:
        def artifact(self, name, type=None):
            calls["requested"].append((name, type))
            return types.SimpleNamespace(download=lambda: str(download_dir),
                                         delete=lambda: calls["deleted"].append(name))

    mod.finish, mod.Histogram, mod.Artifact, mod.Api = finish, Histogram, Artifact, Api
    mod.log_artifact = lambda a: calls["artifacts"].append((a.name, [f.name for f in a.files],
                                                            all(f.exists() for f in a.files)))
    mod.run = types.SimpleNamespace(entity="team", project="proj")
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return calls


def test_online_logs_in_with_the_secret_key_and_renders_histograms(tmp_path, monkeypatch):
    calls = stand_in(monkeypatch)
    monkeypatch.setenv("NVIT_WANDB_API_KEY", "sekrit-123")
    w = MetricsWriter(tmp_path, wandb_mode="online", run_name="r", project="p", config={"a": 1})
    assert calls["login"] == ["sekrit-123"]
    (init,) = calls["init"]
    assert init["mode"] == "online" and init["project"] == "p" and init["name"].startswith("r_")
    assert init["config"] == {"a": 1}
    counts = list(range(64))
    w.log({"train/loss": torch.tensor(1.5), "gradhist/blocks.0.c_fc.w": counts}, step=3)
    w.finish()
    ((step, logged),) = calls["log"]
    assert step == 3 and logged["train/loss"] == 1.5
    hist = logged["gradhist/blocks.0.c_fc.w"].np_histogram
    np.testing.assert_array_equal(hist[0], counts)
    assert hist[1] is WANDB_HIST_EDGES and len(WANDB_HIST_EDGES) == 65 and np.isfinite(WANDB_HIST_EDGES).all()
    assert calls["finish"] == 1
    (line,) = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert line == {"train/loss": 1.5, "gradhist/blocks.0.c_fc.w": counts, "_step": 3}


def test_offline_skips_login(tmp_path, monkeypatch):
    calls = stand_in(monkeypatch)
    monkeypatch.setenv("NVIT_WANDB_API_KEY", "sekrit-123")
    MetricsWriter(tmp_path, wandb_mode="offline")
    assert calls["login"] == [] and calls["init"][0]["mode"] == "offline"


def test_without_wandb_the_jsonl_sink_runs_alone_with_one_warning(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises ImportError
    with caplog.at_level(logging.WARNING):
        w = MetricsWriter(tmp_path, wandb_mode="online")
        w.log({"x": 1.0}, step=1)
        w.finish()
    assert w.wandb is None
    assert [r.getMessage().startswith("wandb unavailable") for r in caplog.records] == [True]
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {"x": 1.0, "_step": 1}


def test_trainer_mirrors_metrics_and_logs_best_checkpoints_as_artifacts(tmp_path, monkeypatch):
    calls = stand_in(monkeypatch)
    cfg = trainer_config(tmp_path, wandb=dict(mode="online", run_name="run"),
                         system=dict(remat=False, dtype="float32", quick_validation_size=8,
                                     log_grad_histograms=True))
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    steps = [s for s, _ in calls["log"]]
    assert steps == [x["_step"] for x in map(json.loads, (tmp_path / "metrics.jsonl").read_text().splitlines())]
    assert any(hasattr(m.get("gradhist/sz"), "np_histogram") for _, m in calls["log"])
    assert calls["init"][0]["config"] == cfg.to_dict() and calls["finish"] == 1
    # two best checkpoints: two artifacts of the two files, the first deleted
    calls["artifacts"].clear()
    calls["deleted"].clear()
    trainer._last_artifact = None
    trainer.metrics_writer = MetricsWriter(tmp_path, wandb_mode="online")
    trainer.save_best({"val/loss": 1.0})
    trainer.save_best({"val/loss": 0.5})
    assert [files for _, files, _ in calls["artifacts"]] == [["checkpoint_best.npz", "checkpoint_best.json"]] * 2
    assert all(exists for _, _, exists in calls["artifacts"])
    first = calls["artifacts"][0][0]
    assert first.startswith("model-run-nvit-") and calls["deleted"] == [f"team/proj/{first}"]


def best_checkpoint(out_dir) -> Trainer:
    """A 2-iteration run that saves checkpoint_best at its end."""
    first = Trainer(trainer_config(out_dir, training=dict(max_iters=2)), device="cpu")
    first.train()
    first.save_best(first.last_metrics)
    first._join_pending_saves()
    return first


def test_init_from_wandb_resumes_from_the_artifact(tmp_path, monkeypatch):
    first = best_checkpoint(tmp_path / "artifact")
    calls = stand_in(monkeypatch, download_dir=tmp_path / "artifact")
    cfg = trainer_config(tmp_path / "run", training=dict(init_from="wandb", max_iters=3),
                         wandb=dict(mode="online", artifact_name="team/proj/nvit:latest"))
    resumed = Trainer(cfg, device="cpu")
    assert calls["requested"] == [("team/proj/nvit:latest", "model")]
    assert resumed.iter_num == 2
    assert all(torch.equal(a, b) for a, b in zip(first.state.model.parameters(), resumed.state.model.parameters()))
    resumed.train()
    assert resumed.iter_num == 3


def test_init_from_wandb_needs_online_wandb_and_the_checkpoint(tmp_path, monkeypatch):
    cfg = trainer_config(tmp_path, training=dict(init_from="wandb"), wandb=dict(mode="offline"))
    with pytest.raises(ValueError, match="online"):
        Trainer(cfg, device="cpu")
    online = trainer_config(tmp_path, training=dict(init_from="wandb"), wandb=dict(mode="online"))
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ValueError, match="requires the wandb package"):
        Trainer(online, device="cpu")
    stand_in(monkeypatch, download_dir=tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="Checkpoint not found in artifact"):
        Trainer(online, device="cpu")


@pytest.mark.parametrize("with_wandb", [True, False])
def test_trainer_takes_every_setting_of_the_slice(tmp_path, monkeypatch, with_wandb):
    """bf16 moments (threefry), histograms, a trace, the NaN sanitizer and
    wandb offline at once; only several devices and orbax stay refused."""
    if with_wandb:
        calls = stand_in(monkeypatch)
    else:
        monkeypatch.setitem(sys.modules, "wandb", None)
    cfg = trainer_config(tmp_path, optimizer=dict(moments_dtype="bfloat16", sr_dither="threefry",
                                                  warmup_iters=0, lr_decay_iters=10),
                         system=dict(remat=False, dtype="float32", quick_validation_size=8,
                                     log_grad_histograms=True, profile_steps=2, debug_nans=True),
                         wandb=dict(mode="offline"))
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    assert trainer.iter_num == 4 and (tmp_path / "finished").read_text() == "max_iters:4"
    assert list((tmp_path / "profile").glob("*.pt.trace.json"))
    lines = (tmp_path / "metrics.jsonl").read_text()
    assert "gradhist/" in lines
    assert (len(calls["log"]) == len(lines.splitlines())) if with_wandb else True
