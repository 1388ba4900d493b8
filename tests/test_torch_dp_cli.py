"""The port's training CLI on several CPU processes (gloo), at a tiny
synthetic model:

* ``python -m torch.distributed.run --nproc_per_node=2 -m nvit_tpu_torch``
  trains; only rank 0 writes ``metrics.jsonl``, ``training.log``, ``stat``,
  the checkpoints and ``finished``; its checkpoint restores in
  ``nvit_tpu.ckpt`` (the JAX package's reader) and resumes on two ranks;
* ``NVIT_MULTIHOST=1`` with the JAX coordinator variables, two "hosts"
  on the CPU: each ``python -m nvit_tpu_torch`` re-executes itself under
  ``torch.distributed.run`` and the run logs the torchrun run's losses;
* SIGTERM to rank 1 alone: both ranks stop at one step boundary, rank 0
  saves, every process exits 0;
* ``launch_argv``, the command the CLI re-executes under: several cards,
  ``NVIT_MULTIHOST=1``, and its ``ValueError``s.
"""

import json
import os
import re
import shutil
import signal
import time

import jax
import numpy as np
import pytest

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu_torch import configs as port_schema
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.train.trainer import launch_argv
from tests.torch_cli_cases import TINY_ENV
from tests.torch_dp import base_env, free_port, spawn, torchrun, wait_all

ENV = {**TINY_ENV, "NVIT_SYSTEM__LOG_TO_FILE": "true", "NVIT_TRAINING__MAX_ITERS": "4"}


def run_env(out, **extra) -> dict:
    return base_env(**{**ENV, "NVIT_DATA__OUT_DIR": str(out), "NVIT_DATA__CHECKPOINT_DIR": str(out), **extra})


def lines(out) -> list[dict]:
    return [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One torchrun run of 4 iterations on two ranks: (its directory, output)."""
    tmp = tmp_path_factory.mktemp("torchrun")
    return tmp, torchrun(2, run_env(tmp / "out"), tmp)


def test_torchrun_trains_two_ranks_and_rank0_alone_writes(two_ranks):
    tmp, output = two_ranks
    out = tmp / "out"
    assert "rank 0 of 2" in output and "rank 1 of 2" in output
    log = (out / "training.log").read_text()
    assert "rank 0 of 2" in log and "rank 1 of 2" not in log  # rank 1 logs to stderr only
    got = lines(out)
    # one line per log (iterations 2, 4) and eval (0, 2): a second writer would double them
    assert [x.get("train/iter", x.get("training/global_step")) for x in got] == [0, 2, 2, 4]
    assert len((out / "stat").read_text().splitlines()) == 3  # the header line, evals 0 and 2
    assert (out / "finished").read_text() == "max_iters:4"
    assert output.count("Checkpoint snapshot time") == 2  # evaluate at 2, cleanup at 4: rank 0's
    assert port_ckpt.load_checkpoint_meta(out, "checkpoint_latest")["iter_num"] == 4


def test_two_rank_checkpoint_restores_in_jax_and_resumes_on_two_ranks(two_ranks, tmp_path):
    tmp, _ = two_ranks
    out = tmp_path / "out"
    shutil.copytree(tmp / "out", out)
    state, jcfg, meta = jax_ckpt.restore_for_resume(out, "checkpoint_latest")
    assert meta["iter_num"] == 4 and int(state.step) == 4 and jcfg.model.n_embd == 64
    port_state, _, _ = port_ckpt.restore_for_resume(out, "checkpoint_latest", device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(state), port_ckpt.state_leaves(port_state)):
        assert np.array_equal(np.asarray(a), b)
    torchrun(2, run_env(out, NVIT_TRAINING__INIT_FROM="resume", NVIT_TRAINING__MAX_ITERS="6"), tmp_path)
    assert port_ckpt.load_checkpoint_meta(out, "checkpoint_latest")["iter_num"] == 6
    assert [x["train/iter"] for x in lines(out) if "train/iter" in x] == [2, 4, 6]
    assert (out / "finished").read_text() == "max_iters:6"


def test_multihost_runs_two_cpu_hosts_in_lockstep(two_ranks, tmp_path):
    """NVIT_MULTIHOST=1 with the JAX coordinator variables, as the JAX
    package runs several processes: the same command on two "hosts"; the
    same losses as torchrun's two ranks."""
    out = tmp_path / "out"
    coord = {"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": f"localhost:{free_port()}",
             "JAX_NUM_PROCESSES": "2"}
    hosts = [spawn(["-m", "nvit_tpu_torch"], run_env(out, **coord, JAX_PROCESS_ID=str(i)), tmp_path)
             for i in range(2)]
    outputs = wait_all(hosts)
    assert "rank 0 of 2" in outputs[0] and "rank 1 of 2" in outputs[1]
    loss = [x["train/batch_loss"] for x in lines(out) if "train/batch_loss" in x]
    want = [x["train/batch_loss"] for x in lines(two_ranks[0] / "out") if "train/batch_loss" in x]
    assert loss == want and (out / "finished").read_text() == "max_iters:4"


def test_sigterm_to_one_rank_stops_both_at_one_boundary(tmp_path):
    out = tmp_path / "out"
    env = run_env(out, NVIT_TRAINING__MAX_ITERS="100000", NVIT_TRAINING__LOG_INTERVAL="1",
                  NVIT_TRAINING__EVAL_INTERVAL="100000")
    proc = spawn(["-m", "torch.distributed.run", "--nproc_per_node=2", f"--master_port={free_port()}",
                  "-m", "nvit_tpu_torch"], env, tmp_path)
    deadline = time.monotonic() + 60
    pid = None
    while time.monotonic() < deadline and proc.poll() is None:
        proc.log.seek(0)
        text = proc.log.read().decode(errors="replace")
        found = re.search(r"rank 1 of 2 on cpu \(pid (\d+)\)", text)
        if found and "Iter: 3/" in text:
            pid = int(found.group(1))
            break
        time.sleep(0.2)
    assert pid is not None, "rank 1 never reached iteration 3"
    os.kill(pid, signal.SIGTERM)
    (output,) = wait_all([proc])  # exit codes 0: torchrun, both ranks
    assert output.count("Handling deferred signal") == 2
    it = port_ckpt.load_checkpoint_meta(out, "checkpoint_latest")["iter_num"]
    assert it >= 3 and not (out / "finished").exists()
    # rank 0 logged every step up to the stop (the stopping step leaves before its log)
    assert [x["train/iter"] for x in lines(out) if "train/iter" in x][-1] in (it - 1, it)


def config(**system) -> port_schema.Config:
    return port_schema.Config(system=port_schema.SystemConfig(**system))


@pytest.mark.parametrize("env,cfg,cards,want", [
    ({}, config(use_ddp=True), 4, ["--standalone", "--nproc_per_node=4"]),
    ({"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": "10.0.0.7:1234", "JAX_NUM_PROCESSES": "3",
      "JAX_PROCESS_ID": "2"}, config(), 8,
     ["--nnodes=3", "--node_rank=2", "--master_addr=10.0.0.7", "--master_port=1234", "--nproc_per_node=8"]),
    ({"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": "localhost:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0"}, config(device="cpu"), 0,
     ["--nnodes=2", "--node_rank=0", "--master_addr=localhost", "--master_port=1", "--nproc_per_node=1"]),
])
def test_launch_argv_reexecutes_under_torchrun(env, cfg, cards, want):
    argv = launch_argv(env, cfg, cards)
    assert argv[1:3] == ["-m", "torch.distributed.run"] and argv[3:-2] == want
    assert argv[-2:] == ["-m", "nvit_tpu_torch"]


def test_launch_argv_trains_in_this_process():
    """One card, use_ddp off, the CPU, or already under a launcher."""
    assert launch_argv({}, config(use_ddp=True), 1) is None
    assert launch_argv({}, config(use_ddp=False), 8) is None
    assert launch_argv({}, config(use_ddp=True, device="cpu"), 8) is None
    assert launch_argv({"WORLD_SIZE": "2", "NVIT_MULTIHOST": "1"}, config(use_ddp=True), 8) is None


@pytest.mark.parametrize("env,match", [
    ({"NVIT_MULTIHOST": "1"}, "JAX_COORDINATOR_ADDRESS"),
    ({"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": "nohost", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0"}, "host:port"),
    ({"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "2"}, "not in"),
])
def test_launch_argv_refuses_an_incomplete_multihost_environment(env, match):
    with pytest.raises(ValueError, match=match):
        launch_argv(env, config(), 1)
