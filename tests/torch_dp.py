"""Launch helpers of the port's data-parallel tests (tests/test_torch_dp_*.py):
subprocesses on the CPU, each on a port found by binding port 0, each
waited on with a timeout and killed with its siblings on failure, so a
hang fails the test instead of holding the suite's clock."""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def base_env(**extra: str) -> dict:
    """The environment of a child: the repo importable, no launcher's or
    settings' variables inherited, the CPU."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NVIT_", "JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def wait_all(procs: list[subprocess.Popen], timeout: float = TIMEOUT_S) -> list[str]:
    """Each process's combined output; all are killed if one fails or the
    timeout passes, and the failure raises with the outputs."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
            if p.returncode:
                break
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            kill(p)
            p.wait()
    outs = []
    for p in procs:
        p.log.seek(0)
        outs.append(p.log.read().decode(errors="replace"))
        p.log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"exit codes {codes} (negative: killed at the {timeout} s timeout or "
                             "after a sibling failed):\n" + "\n----\n".join(o[-3000:] for o in outs))
    return outs


def spawn(args: list[str], env: dict, cwd: Path | str = REPO) -> subprocess.Popen:
    """``python <args>`` in its own session, its output in a temporary file."""
    log = tempfile.TemporaryFile()
    p = subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, stdout=log, stderr=subprocess.STDOUT,
                         start_new_session=True)
    p.log = log
    return p


def run_ranks(jobs: list[dict], tmp: Path, world: int = 2) -> list[dict]:
    """``tests/torch_dp_worker.py`` on ``world`` gloo ranks → each rank's results."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, tmp / "job.pt")
    port = str(free_port())
    procs = [spawn(["-m", "tests.torch_dp_worker", str(tmp / "job.pt"), str(tmp)],
                   base_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                            MASTER_ADDR="localhost", MASTER_PORT=port))
             for r in range(world)]
    wait_all(procs)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def torchrun(nproc: int, env: dict, cwd: Path, *, timeout: float = TIMEOUT_S) -> str:
    """``python -m torch.distributed.run --nproc_per_node=<nproc> -m nvit_tpu_torch`` → its output."""
    (out,) = wait_all([spawn(["-m", "torch.distributed.run", f"--nproc_per_node={nproc}",
                              f"--master_port={free_port()}", "-m", "nvit_tpu_torch"], env, cwd)],
                      timeout)
    return out


def kill(p: subprocess.Popen) -> None:
    """SIGKILL to ``p``'s whole session (a launcher and its workers)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
