"""One rank of the port's two-rank data-parallel tests on the CPU (gloo);
it imports no jax.  Run by ``tests/torch_dp.py::run_ranks`` as

    python -m tests.torch_dp_worker <job.pt> <out_dir>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set.  The job (``torch.save``) holds a list of runs, each
``{"name", "cfg", "state_dict", "batches": [(images u8, labels)], "aug"}``.
The rank forms one gloo group for all runs.  For each run it builds a
``Trainer(cfg, group=...)`` whose fresh state holds the run's weights
(rank 1's moved by 0.25, so the Trainer's broadcast of rank 0's shows), and
takes one ``make_train_step`` step per global batch on its rows
``rank·b … (rank+1)·b − 1``, with the per-group norms.  It writes
``<out_dir>/rank<r>.pt``: per run the metrics and the parameters after
every step, the final moments, and for ``aug`` runs the Trainer's
preprocessing of its rows of each batch (train, at the step)."""

from __future__ import annotations

import sys
from pathlib import Path
from unittest import mock

import torch

from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.parallel.mesh import destroy, init_data_parallel
from nvit_tpu_torch.train import trainer as trainer_mod
from nvit_tpu_torch.train.state import create_train_state
from nvit_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def main() -> None:
    job_path, out_dir = Path(sys.argv[1]), Path(sys.argv[2])
    jobs = torch.load(job_path, weights_only=False)
    group = init_data_parallel("cpu", timeout_s=60)
    out = {}
    try:
        for job in jobs:
            out[job["name"]] = one_run(job, group)
    finally:
        destroy(group)
    torch.save(out, out_dir / f"rank{group.rank}.pt")


def one_run(job: dict, group) -> dict:
    cfg, sd = job["cfg"], job["state_dict"]

    def given_state(cfg, seed=None, *, device):
        state = create_train_state(cfg, seed, device=device)
        with torch.no_grad():
            for name, t in state.model.state_dict().items():
                # rank 1 starts from other weights: the Trainer's broadcast must undo it
                t.copy_(sd[name] + (0.25 if group.rank and t.is_floating_point() else 0.0))
        return state

    with mock.patch.object(trainer_mod, "create_train_state", given_state):
        trainer = Trainer(cfg, device="cpu", group=group)
    step = trainer._train_step_norms
    got = {"metrics": [], "params": [], "aug": []}
    for imgs, labels in job["batches"]:
        b = imgs.shape[0] // group.world
        rows = slice(group.rank * b, (group.rank + 1) * b)
        mine = torch.from_numpy(imgs[rows])
        if job.get("aug"):
            got["aug"].append(trainer._preprocess(mine, train=True, step=trainer.state.step))
        _, m = step(trainer.state, normalize(mine), torch.from_numpy(labels[rows]))
        got["metrics"].append({k: float(v) for k, v in m.items()})
        got["params"].append({n: p.detach().clone() for n, p in trainer.state.model.named_parameters()})
    got["mu"] = {k: v.clone() for k, v in trainer.state.opt_state.mu.items()}
    got["nu"] = {k: v.clone() for k, v in trainer.state.opt_state.nu.items()}
    return got


if __name__ == "__main__":
    main()
