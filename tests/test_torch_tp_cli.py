"""The port's training CLI with tensor parallelism and FSDP on two CPU
processes (gloo), at the tiny synthetic model of tests/torch_cli_cases.py:

* ``python -m torch.distributed.run --nproc_per_node=2 -m nvit_tpu_torch``
  with ``NVIT_SYSTEM__MODEL_PARALLEL=2`` trains one model over the two
  ranks (data 1 × model 2); only rank 0 writes ``metrics.jsonl`` and the
  checkpoints, and its checkpoint restores in ``nvit_tpu.ckpt``;
* ``NVIT_MULTIHOST=1`` with the JAX coordinator variables, two "hosts": the
  same run, the same losses;
* the checkpoint resumes through the CLI on another layout: two ranks with
  ``NVIT_SYSTEM__FSDP=true`` (data 2 × model 1).
"""

import json
import shutil

import jax
import pytest

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from tests.torch_cli_cases import TINY_ENV
from tests.torch_dp import base_env, free_port, spawn, torchrun, wait_all

ENV = {**TINY_ENV, "NVIT_MODEL__BIAS": "true", "NVIT_TRAINING__MAX_ITERS": "4",
       "NVIT_SYSTEM__MODEL_PARALLEL": "2"}


def run_env(out, **extra) -> dict:
    return base_env(**{**ENV, "NVIT_DATA__OUT_DIR": str(out), "NVIT_DATA__CHECKPOINT_DIR": str(out), **extra})


def losses(out) -> list[float]:
    return [x["train/batch_loss"] for x in map(json.loads, (out / "metrics.jsonl").read_text().splitlines())
            if "train/batch_loss" in x]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One torchrun run of 4 iterations, data 1 × model 2: (its out_dir, output)."""
    tmp = tmp_path_factory.mktemp("tp_torchrun")
    return tmp / "out", torchrun(2, run_env(tmp / "out"), tmp)


def test_torchrun_model_parallel_trains_and_resumes_under_fsdp(two_ranks, tmp_path):
    out, output = two_ranks
    assert "mesh: data=1, model=2" in output and "rank 1 of 2" in output
    assert len(losses(out)) == 2 and (out / "finished").read_text() == "max_iters:4"
    assert output.count("Checkpoint snapshot time") == 2  # evaluate at 2, cleanup at 4: rank 0's
    state, jcfg, meta = jax_ckpt.restore_for_resume(out, "checkpoint_latest")
    assert meta["iter_num"] == 4 and int(state.step) == 4 and jcfg.system.model_parallel == 2
    c_fc = state.params["blocks"][0]["c_fc"]["w"]
    assert c_fc.shape == (64, 2 * 4 * 64)  # whole, [in, out]
    port_state, _, _ = port_ckpt.restore_for_resume(out, "checkpoint_latest", device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(state), port_ckpt.state_leaves(port_state)):
        assert a.shape == b.shape and bytes(memoryview(jax.device_get(a))) == b.tobytes()
    resumed = tmp_path / "resumed"
    shutil.copytree(out, resumed)
    (resumed / "finished").unlink()
    output = torchrun(2, run_env(resumed, NVIT_TRAINING__INIT_FROM="resume", NVIT_TRAINING__MAX_ITERS="6",
                                 NVIT_SYSTEM__MODEL_PARALLEL="1", NVIT_SYSTEM__FSDP="true"), tmp_path)
    assert "mesh: data=2, model=1, fsdp" in output and "Resumed from iteration 4" in output
    assert port_ckpt.load_checkpoint_meta(resumed, "checkpoint_latest")["iter_num"] == 6
    assert len(losses(resumed)) == 3 and (resumed / "finished").read_text() == "max_iters:6"


def test_multihost_model_parallel_runs_two_cpu_hosts_in_lockstep(two_ranks, tmp_path):
    """NVIT_MULTIHOST=1 with the JAX coordinator variables on two "hosts",
    model_parallel=2 across them: the torchrun run's losses."""
    want_out, _ = two_ranks
    out = tmp_path / "out"
    coord = {"NVIT_MULTIHOST": "1", "JAX_COORDINATOR_ADDRESS": f"localhost:{free_port()}",
             "JAX_NUM_PROCESSES": "2"}
    hosts = [spawn(["-m", "nvit_tpu_torch"], run_env(out, **coord, JAX_PROCESS_ID=str(i)), tmp_path)
             for i in range(2)]
    outputs = wait_all(hosts)
    assert "mesh: data=1, model=2" in outputs[0] and "rank 1 of 2" in outputs[1]
    assert losses(out) == losses(want_out) and (out / "finished").read_text() == "max_iters:4"
