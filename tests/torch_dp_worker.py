"""One rank of the port's multi-rank tests on the CPU (gloo): data
parallelism, tensor parallelism and FSDP; it imports no jax.  Run by
``tests/torch_dp.py::run_ranks`` as

    python -m tests.torch_dp_worker <job.pt> <out_dir>

with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set.  The job (``torch.save``) holds a list of runs, each
``{"name", "cfg", "state_dict", "batches": [(images u8, labels)], "aug"}``.
The rank forms one gloo group for all runs.  For each run it builds a
``Trainer(cfg, group=...)`` — whose ``system.model_parallel`` and
``system.fsdp`` lay out the data × model grid — with a fresh state holding
the run's weights (rank ≥ 1's moved by 0.25, so the Trainer's broadcast of
rank 0's shows), and takes one ``make_train_step`` step per global batch on
its data rank's rows ``rank·b … (rank+1)·b − 1``, with the per-group norms.
It writes ``<out_dir>/rank<r>.pt``: per run the metrics and the whole
parameters (gathered from the pieces) after every step, the final whole
moments, the rank's own pieces of the parameters and moments and its
(data, model) coordinates, and for ``aug`` runs the Trainer's preprocessing
of its rows of each batch (train, at the step).

A run with ``"resume": [(name, system fields), ...]`` is a checkpoint run:
the Trainer starts from the seed (``state_dict`` None), each rank's
``out_dir`` its own, takes its steps and saves ``checkpoint_latest``
(gathered, rank 0 writes); then, for each entry, a Trainer on that layout
resumes from rank 0's directory, records its pieces and takes one more
step on the last batch."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist

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


def pieces(trainer) -> dict:
    """The rank's own tensors: parameters and moments, as it holds them."""
    st = trainer.state
    return {"params": {n: p.detach().clone() for n, p in st.model.named_parameters()},
            "mu": {k: v.clone() for k, v in st.opt_state.mu.items()},
            "nu": {k: v.clone() for k, v in st.opt_state.nu.items()},
            "coords": (trainer.data_rank, trainer.mesh.model.rank), "step": st.step}


def whole(trainer, named: dict) -> dict:
    """The whole tensors of ``named`` (this rank's pieces), gathered."""
    mesh = trainer.mesh
    return {n: mesh.gather(n, t.detach()).clone() for n, t in named.items()}


def step_rows(trainer, imgs, labels):
    """This data rank's rows of a global batch, normalized."""
    b = imgs.shape[0] // trainer.data_world
    rows = slice(trainer.data_rank * b, (trainer.data_rank + 1) * b)
    return torch.from_numpy(imgs[rows]), torch.from_numpy(labels[rows])


def ckpt_run(job: dict, group) -> dict:
    cfg = job["cfg"]
    out = Path(job["out_dir"])
    mine = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, out_dir=str(out / f"rank{group.rank}")))
    trainer = Trainer(mine, device="cpu", group=group)
    for imgs, labels in job["batches"]:
        x, y = step_rows(trainer, imgs, labels)
        trainer._train_step(trainer.state, normalize(x), y)
        trainer.iter_num += 1
    got = {"saved": pieces(trainer), "resumed": {}}
    trainer.save({})
    trainer._join_pending_saves()
    dist.barrier()
    for name, system in job["resume"]:
        rcfg = dataclasses.replace(
            mine, system=dataclasses.replace(mine.system, **system),
            training=dataclasses.replace(mine.training, init_from="resume"),
            data=dataclasses.replace(mine.data, checkpoint_dir=str(out / "rank0")))
        resumed = Trainer(rcfg, device="cpu", group=group)
        got["resumed"][name] = pieces(resumed)
        x, y = step_rows(resumed, *job["batches"][-1])
        resumed._train_step(resumed.state, normalize(x), y)
        got["resumed"][name]["after"] = whole(resumed, dict(resumed.state.model.named_parameters()))
    return got


def one_run(job: dict, group) -> dict:
    if "resume" in job:
        return ckpt_run(job, group)
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
        mine, rows_labels = step_rows(trainer, imgs, labels)
        if job.get("aug"):
            got["aug"].append(trainer._preprocess(mine, train=True, step=trainer.state.step))
        _, m = step(trainer.state, normalize(mine), rows_labels)
        got["metrics"].append({k: float(v) for k, v in m.items()})
        got["params"].append(whole(trainer, dict(trainer.state.model.named_parameters())))
    got["mu"] = whole(trainer, trainer.state.opt_state.mu)
    got["nu"] = whole(trainer, trainer.state.opt_state.nu)
    got["pieces"] = pieces(trainer)
    return got


if __name__ == "__main__":
    main()
