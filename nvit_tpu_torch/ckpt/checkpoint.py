"""Checkpoint files in the JAX package's format (≙ nvit_tpu/ckpt/checkpoint.py).

``<out_dir>/<name>.npz`` holds the JAX ``TrainState``'s leaves as ``leaf_0 …
leaf_{n-1}`` in ``jax.tree_util`` flatten order (``ckpt/tree.py``), in the
JAX layouts (``ckpt/convert.py``); ``<name>.json`` the meta: ``iter_num``,
scalar ``metrics``, the Trainer's protocol state (``trainer``), the whole
``config``, a ``timestamp``, ``num_leaves`` and ``"format":
"nvit_tpu.ckpt.v1"``.  So a checkpoint crosses both ways: the JAX package's
``restore_for_resume`` reads the port's files and this module reads its.

* Both files are written to ``.tmp`` names and renamed, so a save cut short
  never leaves a torn ``checkpoint_latest``.
* ``save_checkpoint_async`` copies the state to the host on the calling
  thread and writes the files on another.  The copy must be synchronous:
  the fused update rewrites parameters and moments in place
  (``train/optim.py``), and a copy taken later would hold a later step.
* ``restore_for_resume`` rebuilds the ``Config`` from the checkpoint's own
  meta, then the model and optimizer state from it.  Orbax checkpoints
  (``ckpt/orbax_backend.py``) are on ROADMAP.md's do-not-port list and raise.
* Data parallelism changes nothing here: every rank holds the whole state,
  rank 0 alone saves (the Trainer), and each rank restores onto its own
  ``device``; a checkpoint of a run on N ranks is the same file.
* Under tensor parallelism or FSDP every rank calls ``gathered_leaves``,
  which brings every piece of the parameters and moments to rank 0
  (``Mesh.gather``, bit-exact); rank 0 writes the same npz leaves and json
  meta as one card, and nothing else writes.  A restore reads the whole
  leaves on every rank, which keeps its pieces (``train.state.shard_state_``),
  so a run resumes on any layout, or on one process.  Across hosts the JAX
  trainer switches to orbax, whose arrays each host writes for itself; the
  port needs no such switch: ``torch.distributed``'s collectives reach rank 0
  from every host, so npz stays the one format.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from nvit_tpu_torch.ckpt.convert import jax_params_from_state_dict, state_dict_from_jax
from nvit_tpu_torch.ckpt.tree import flatten, param_tree, train_state_specs, unflatten
from nvit_tpu_torch.configs import Config, merge_dataclass
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import FusedAdamWState, init_fused_adamw
from nvit_tpu_torch.train.state import TrainState

FORMAT = "nvit_tpu.ckpt.v1"


def state_leaves(state: TrainState, params=None, mu=None, nu=None) -> list[np.ndarray]:
    """Host copies of every leaf of ``state`` in the JAX ``TrainState``'s
    order; ``params``/``mu``/``nu`` (whole tensors by name) in place of the
    state's own."""
    cfg = state.model.cfg
    opt = state.opt_state
    trees = (jax_params_from_state_dict(state.model.state_dict() if params is None else params, cfg),
             jax_params_from_state_dict(opt.mu if mu is None else mu, cfg),
             jax_params_from_state_dict(opt.nu if nu is None else nu, cfg))
    params, mu, nu = ([leaf for _, leaf in flatten(t)] for t in trees)
    return [*params, np.array(opt.count, np.int32), *mu, *nu,
            np.array(state.step, np.int32), np.array(state.rng, np.uint32)]


def gathered_leaves(state: TrainState, mesh) -> list[np.ndarray] | None:
    """Every rank calls this: the whole state's leaves on rank 0 (None on
    the others), from every rank's pieces (``mesh``, a ``parallel/mesh.Mesh``)."""
    def whole(named):
        return {n: mesh.gather(n, t) for n, t in named.items()}

    params, mu, nu = (whole(x) for x in (state.model.state_dict(), state.opt_state.mu, state.opt_state.nu))
    return state_leaves(state, params, mu, nu) if mesh.group.rank == 0 else None


def write_files(out_dir: Path, name: str, leaves: list[np.ndarray], meta: dict[str, Any]) -> Path:
    arrays_path = out_dir / f"{name}.npz"
    meta_path = out_dir / f"{name}.json"
    tmp_arrays = arrays_path.with_suffix(".npz.tmp")
    tmp_meta = meta_path.with_suffix(".json.tmp")
    with open(tmp_arrays, "wb") as f:  # a handle, so numpy appends no ".npz"
        np.savez(f, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    tmp_meta.write_text(json.dumps(meta, indent=2))
    tmp_arrays.replace(arrays_path)
    tmp_meta.replace(meta_path)
    return arrays_path


def _snapshot(state: TrainState, config: Config, metrics: dict[str, Any] | None,
              trainer_state: dict[str, Any] | None,
              leaves: list[np.ndarray] | None = None) -> tuple[list[np.ndarray], dict[str, Any]]:
    leaves = state_leaves(state) if leaves is None else leaves
    meta = {
        "iter_num": int(state.step),
        # scalars only (the JAX meta's rule); the trainer logs None for an MFU it cannot know
        "metrics": {k: float(v) for k, v in (metrics or {}).items()
                    if v is not None and np.ndim(v) == 0},
        "trainer": dict(trainer_state or {}),
        "config": config.to_dict(),
        "timestamp": time.strftime("%d_%m_%Y-%Hh%Mm"),
        "num_leaves": len(leaves),
        "format": FORMAT,
    }
    return leaves, meta


def save_checkpoint(out_dir: str | Path, name: str, state: TrainState, config: Config,
                    metrics: dict[str, Any] | None = None,
                    trainer_state: dict[str, Any] | None = None) -> Path:
    """Write ``<out_dir>/<name>.npz`` and ``<name>.json`` atomically."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return write_files(out_dir, name, *_snapshot(state, config, metrics, trainer_state))


class PendingSave(threading.Thread):
    """The file writes of one checkpoint, on a thread; ``result()`` joins it
    and raises what the writes raised (disk full, permissions), which a bare
    thread would drop while the run logs a save that never landed."""

    def __init__(self, out_dir: Path, name: str, leaves: list[np.ndarray], meta: dict[str, Any]):
        super().__init__(daemon=True, name=f"save-{name}")
        self._args = (out_dir, name, leaves, meta)
        self.error: Exception | None = None

    def run(self) -> None:
        try:
            write_files(*self._args)
        except Exception as e:  # re-raised by result()
            self.error = e

    def result(self) -> None:
        self.join()
        if self.error is not None:
            raise RuntimeError(f"async checkpoint write failed: {self.error}") from self.error


def save_checkpoint_async(out_dir: str | Path, name: str, state: TrainState, config: Config,
                          metrics: dict[str, Any] | None = None,
                          trainer_state: dict[str, Any] | None = None,
                          leaves: list[np.ndarray] | None = None) -> PendingSave:
    """Copy the state to the host now, write the files on a thread.  Call
    ``result()`` before writing the same name again (the Trainer does).
    ``leaves``: the host copy already made (``gathered_leaves``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pending = PendingSave(out_dir, name, *_snapshot(state, config, metrics, trainer_state, leaves))
    pending.start()
    return pending


def load_checkpoint_meta(out_dir: str | Path, name: str) -> dict[str, Any]:
    return json.loads((Path(out_dir) / f"{name}.json").read_text())


def checkpoint_exists(out_dir: str | Path, name: str) -> bool:
    return (Path(out_dir) / f"{name}.npz").exists() and (Path(out_dir) / f"{name}.json").exists()


def config_of(meta: dict[str, Any]) -> Config:
    """The checkpoint's own ``Config``; orbax checkpoints raise."""
    fmt = meta.get("format", "")
    if fmt.startswith("nvit_tpu.ckpt.orbax"):
        raise NotImplementedError(
            "orbax checkpoints are not ported: ckpt/orbax_backend.py is on ROADMAP.md's "
            "do-not-port list; save with data.checkpoint_backend='npz'")
    if fmt != FORMAT:
        raise ValueError(f"not an nvit_tpu training checkpoint: format={fmt!r}")
    return merge_dataclass(Config(), meta["config"])


def read_leaves(out_dir: str | Path, name: str, specs: list, meta: dict[str, Any],
                total: int) -> list[np.ndarray]:
    """The first ``len(specs)`` leaves of the checkpoint (npz members load
    one by one: the params alone leave the moments unread), checked against
    ``specs``' shapes; the checkpoint must hold ``total`` leaves."""
    if meta["num_leaves"] != total:
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves but the TrainState has "
                         f"{total} — config mismatch? (checkpoint config: {meta['config']['model']})")
    with np.load(Path(out_dir) / f"{name}.npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(specs))]
    for i, (a, (path, spec)) in enumerate(zip(leaves, specs)):
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"checkpoint leaf {i} {path} has shape {a.shape}, expected "
                             f"{spec.shape} — config mismatch? (checkpoint config: "
                             f"{meta['config']['model']})")
    return leaves


def state_dict_of_leaves(leaves: list[np.ndarray], model_cfg, *, int8: bool = False) -> dict[str, torch.Tensor]:
    """Leaves in the params' flatten order (the int8 tree's with ``int8``) →
    a state_dict (torch tensors on the CPU).  bfloat16 leaves, stored as
    2-byte void records, cross as their int16 bits (``state_dict_from_jax``
    moves layouts only) and come back as bfloat16."""
    stored = [a.view(np.int16) if a.dtype.kind == "V" else a for a in leaves]
    sd = state_dict_from_jax(unflatten(param_tree(model_cfg, int8=int8), iter(stored)), model_cfg)
    return {k: v.view(torch.bfloat16) if v.dtype == torch.int16 else v for k, v in sd.items()}


def load_checkpoint(out_dir: str | Path, name: str, state: TrainState) -> tuple[TrainState, dict]:
    """Restore the checkpoint into ``state``, bit-exact: its parameters and
    moments are overwritten in place, the rest replaced → (state, meta).
    ``state``'s model fixes the structure, as the JAX loader's template does."""
    meta = load_checkpoint_meta(out_dir, name)
    cfg = config_of(meta)
    model_cfg = state.model.cfg
    specs = train_state_specs(dataclasses.replace(cfg, model=model_cfg))
    leaves = read_leaves(out_dir, name, specs, meta, len(specs))
    n = len(flatten(param_tree(model_cfg)))
    state.model.load_state_dict(state_dict_of_leaves(leaves[:n], model_cfg), strict=True)
    opt = state.opt_state
    for moments, part in ((opt.mu, leaves[n + 1:2 * n + 1]), (opt.nu, leaves[2 * n + 1:3 * n + 1])):
        sd = state_dict_of_leaves(part, model_cfg)
        for key, value in moments.items():  # the maps' buffers have no moments
            value.copy_(sd[key])
    state.opt_state = FusedAdamWState(count=int(leaves[n]), mu=opt.mu, nu=opt.nu)
    state.step = int(leaves[-2])
    state.rng = np.array(leaves[-1], np.uint32)
    return state, meta


def restore_for_resume(out_dir: str | Path, name: str, *,
                       device: torch.device | str = "cuda") -> tuple[TrainState, Config, dict]:
    """Rebuild the Config from the checkpoint's meta, the state from the
    Config, and load the checkpoint into it → (state on ``device``, Config,
    meta).  No initializer runs: the weights come from the file."""
    cfg = config_of(load_checkpoint_meta(out_dir, name))
    model = ViT(cfg.model, device=device)
    generator = torch.Generator()
    generator.manual_seed(cfg.training.seed + 1)
    state = TrainState(model=model, generator=generator, step=0,
                       opt_state=init_fused_adamw(model.named_parameters(), cfg.optimizer.moments_dtype))
    state, meta = load_checkpoint(out_dir, name, state)
    return state, cfg, meta


def read_params(out_dir: str | Path, name: str) -> tuple[list[np.ndarray], Config, dict]:
    """(the params' leaves in flatten order, Config, meta): no moment is read."""
    meta = load_checkpoint_meta(out_dir, name)
    cfg = config_of(meta)
    specs = train_state_specs(cfg)
    n = len(flatten(param_tree(cfg.model)))
    return read_leaves(out_dir, name, specs[:n], meta, len(specs)), cfg, meta


def restore_params(out_dir: str | Path, name: str) -> tuple[dict[str, torch.Tensor], Config, dict]:
    """(state_dict on the CPU, Config, meta): the parameters alone — no
    moment is read and no optimizer built (``Predictor.from_checkpoint``)."""
    leaves, cfg, meta = read_params(out_dir, name)
    return state_dict_of_leaves(leaves, cfg.model), cfg, meta
