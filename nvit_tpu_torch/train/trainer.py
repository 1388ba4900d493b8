"""Trainer: the host loop around the train step and the run's lifecycle
(≙ nvit_tpu/train/trainer.py: ``Trainer.train`` :446-666, ``estimate_loss``
/ ``validate`` / ``validate_only`` / ``evaluate`` :668-806, the checkpoint
protocol :808-926, the signal handlers and ``cleanup`` :929-1013, ``main``).

Ported: every model the JAX package trains (nViT and baseline, with or
without biases and the Kohonen SOM, whose Hebbian deltas the train step
adds after the update), the datasets of ``data.dataset`` (CIFAR-10/100 files, fetched
under ``data.download``; ImageNet folders; digits; synthetic), their epoch
batches uploaded by ``device_prefetch`` (``data.num_workers`` decode
threads for folders, ``data.prefetch`` batches in flight), AutoAugment on
the device keyed by the run key and the step, ``system.remat``;
evaluation at ``eval_interval`` over ``eval_iters`` batches of both
splits plus the (quick) validation pass, early stopping, a log every
``log_interval`` iterations to ``out_dir/metrics.jsonl`` (loss terms,
learning rate, ``train/batch_time_ms``, ``train/data_wait_ms`` — the time a
step waited for its batch —, ``train/mfu``, norms, memory), the
``out_dir/stat`` line at every eval, the launch limits and the relaunch
protocol:

* checkpoints in the JAX package's format (``ckpt/checkpoint.py``):
  ``checkpoint_latest`` at every eval when ``always_save_checkpoint`` (and
  ``checkpoint_<iter>`` with ``save_numbered_checkpoints``),
  ``checkpoint_best`` on every strict improvement of the val loss whatever
  the config says, and ``checkpoint_latest`` at exit; the files are
  written on a thread after a synchronous host copy;
* ``init_from="resume"`` from ``data.checkpoint_dir`` /
  ``data.checkpoint_file``: the checkpoint's model config wins over the
  settings, and the early-stop state (best val loss, patience, eval count)
  and the mid-epoch batch position carry across launches;
* the ``finished`` sentinel: ``max_iters:N`` (a resume with a larger
  ``max_iters`` extends the run) or ``early_stop`` (final);
* ``eval_only`` (``validate_only``, on a resumed checkpoint);
* while ``train()`` runs, SIGINT/SIGTERM save ``checkpoint_latest`` and
  exit 0.  A signal that lands inside a training step waits for the step's
  end, because the fused update rewrites the parameters and moments in
  place; a second signal inside the same step exits 1 at once without a
  save.  ``cleanup()`` puts back the handlers ``train()`` found, so a
  finished Trainer holds no process-wide state and can be freed.

Observability (≙ trainer.py:254-261, :558-609, :768-774, :880-911):
``wandb.mode`` online or offline mirrors ``metrics.jsonl`` to wandb (the
JSONL sink alone, with one warning, where wandb is absent), and with
``wandb.save_artifacts`` every ``checkpoint_best`` is logged as a model
artifact (the previous version deleted); ``init_from="wandb"`` resumes from
the ``checkpoint_best`` of ``wandb.artifact_name`` (online only);
``system.log_grad_histograms`` runs the histogram step variant on the step
that feeds an eval (never the one that reaches ``max_iters``) and logs its
``gradhist/*`` counts at that eval; ``system.profile_steps`` traces steps
[1, 1 + profile_steps) into ``out_dir/profile`` (``obs/profiling.py``);
``system.debug_nans`` raises ``FloatingPointError`` on a non-finite loss,
gradient or updated parameter.  ``optimizer.moments_dtype="bfloat16"``
keeps the moments in bf16 with stochastic rounding (``train/optim.py``).

Data parallelism, tensor parallelism and FSDP (≙ trainer.py:90-178,
:335-354, :415-435, :458-465, :590-605, :850-1000): one process per card,
as the reference's ``torchrun`` ran it.  Under a launcher's environment
(``WORLD_SIZE`` > 1) the Trainer forms the group itself
(``parallel/mesh.py``: NCCL on cards, gloo on the CPU), or joins one the
caller formed (``group=``), and destroys a group it formed in
``cleanup()``.  The world is a data × model grid (``make_mesh``:
``system.model_parallel`` = M consecutive ranks a model group), with
``system.fsdp`` over several data ranks the trunk's shards cut again over
the data axis.  Rank 0's parameters and moments are broadcast once, whole;
then each rank keeps its pieces (``train.state.shard_state_``): the model
is built and initialised whole, from the one seed, so every layout starts
from one card's weights.  Each data rank loads its shard of every global
batch (``batch_size / data ranks`` rows, ``drop_last``) and augments its
rows of the global batch's draw; the ranks of a model group read the same
rows with the same draws.  The step (``train/step.py``) reduces over the
axes.  Rank 0 alone writes: the metrics sinks, wandb and its artifacts,
the checkpoints (gathered from every rank's pieces by every rank,
``ckpt/checkpoint.py``), the ``finished`` sentinel, ``stat`` and
``training.log``, and the CIFAR download (the others wait for it).  Every
rank restores the whole checkpoint onto its own device and keeps its
pieces, so a run resumes on any layout.  Validation and ``estimate_loss``
average their metrics over ranks, so early stopping agrees everywhere.
The time limit is rank 0's verdict, broadcast every ``log_interval``
iterations, and a signal is deferred to the step boundary, where the ranks
agree to stop together (one host all-reduce a step), so no rank waits in a
collective another has left.  MFU stays a card's: a TP rank counts its
share of the trunk's products.  Several cards visible to one process with
``use_ddp`` on and no group is a ``ValueError``: the Trainer never trains
on one card of several quietly; so is ``model_parallel > 1`` on one rank
(≙ trainer.py:99-104), and ``fsdp`` on one rank warns, as the JAX trainer
does.

Refused at construction with ``NotImplementedError``, never skipped
silently: orbax checkpoints (on ROADMAP.md's do-not-port list).
``jit``, ``compile``,
``compilation_cache_dir``, ``clear_cache`` and ``backend`` are TPU/XLA
settings with no PyTorch counterpart and are ignored, and so is
``system.use_tqdm``: the JAX trainer's progress bar changes no result.
``system.device`` picks the device of ``main`` (the CLI): the CPU when it
is ``"cpu"``, else the card.
"""

from __future__ import annotations

import dataclasses
import math
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist

from nvit_tpu_torch.ckpt.checkpoint import restore_for_resume, save_checkpoint_async
from nvit_tpu_torch.configs import Config, load_config
from nvit_tpu_torch.data.augment import preprocess
from nvit_tpu_torch.data.autoaugment import step_generator
from nvit_tpu_torch.data.datasets import load_dataset, wait_for_cifar
from nvit_tpu_torch.data.pipeline import device_prefetch, make_epoch_iterator
from nvit_tpu_torch.models.blocks import SQK_INIT_VALUE
from nvit_tpu_torch.models.schedules import cosine_lr
from nvit_tpu_torch.models.vit import estimate_flops_per_iter, num_params
from nvit_tpu_torch.obs.metrics import (
    MetricsWriter,
    StepTimer,
    memory_stats,
    setup_logging,
    write_stat_line,
)
from nvit_tpu_torch.obs.profiling import start_trace, stop_trace
from nvit_tpu_torch.ckpt.checkpoint import gathered_leaves
from nvit_tpu_torch.parallel.mesh import (
    DataGroup,
    any_flag,
    broadcast_,
    broadcast_flag,
    destroy,
    init_data_parallel,
    join_default_group,
    launcher_world,
    make_mesh,
    mean_metrics,
    shard_dim,
)
from nvit_tpu_torch.train.state import create_train_state, shard_state_
from nvit_tpu_torch.train.step import make_eval_step, make_train_step

# dense bf16 tensor-core peak by device name (NVIDIA's data sheets); MFU is
# reported only for a device listed here
PEAK_BF16_FLOPS = {
    "H100 80GB HBM3": 989e12,  # H100 SXM5
    "H100 SXM": 989e12,
    "H200": 989e12,
}


def device_peak_flops(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((peak for key, peak in PEAK_BF16_FLOPS.items() if key in name), None)


def check_ported(cfg: Config, world: int = 1) -> None:
    """Raise ``NotImplementedError`` for the one setting the port refuses,
    orbax checkpoints (not to be ported), and ``ValueError`` for a layout
    ``world`` ranks cannot hold."""
    t, s, d = cfg.training, cfg.system, cfg.data
    if t.init_from not in ("scratch", "resume", "wandb"):
        raise ValueError(f"Invalid init_from value: {t.init_from}")
    if d.checkpoint_backend == "orbax":
        raise NotImplementedError(
            "data.checkpoint_backend='orbax' is not ported: ckpt/orbax_backend.py is on "
            "ROADMAP.md's do-not-port list; use 'npz', the JAX package's default")
    if d.checkpoint_backend != "npz":
        raise ValueError(f"checkpoint_backend must be 'npz' or 'orbax', got {d.checkpoint_backend!r}")
    cfg.model.validate()  # before anything is made on the device
    if s.model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {s.model_parallel}")
    if world > 1 and world % s.model_parallel:  # ≙ make_mesh; one rank: the Trainer's ValueError
        raise ValueError(f"{world} devices not divisible by model_parallel={s.model_parallel}")


def data_group(cfg: Config, device: torch.device, group: DataGroup | None) -> tuple[DataGroup | None, bool]:
    """(the run's data-parallel group or None, whether the Trainer formed
    it): ``group``, else the default group a caller formed, else one formed
    from the launcher's environment.  Refuses a setting that would train
    on fewer cards than asked for."""
    if group is not None:
        return group, False
    if dist.is_initialized():
        return join_default_group(device), False
    world = launcher_world()
    if world > 1 and not cfg.system.use_ddp:
        raise ValueError(f"system.use_ddp is false under a launcher of {world} processes: each "
                         "would train alone on its shard; set system.use_ddp=true")
    if "WORLD_SIZE" in os.environ and cfg.system.use_ddp:  # under a launcher, of one process too
        return init_data_parallel(device.type), True
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cfg.system.use_ddp and cards > 1:
        raise ValueError(
            f"{cards} cards are visible and system.use_ddp is on, but this process has no group: one "
            f"process drives one card; launch `torchrun --nproc_per_node={cards} -m nvit_tpu_torch` "
            "(`python -m nvit_tpu_torch` does), or set system.use_ddp=false or CUDA_VISIBLE_DEVICES "
            "to train on one card")
    return None, False


class Trainer:
    def __init__(self, config: Config, *, device: torch.device | str = "cuda",
                 group: DataGroup | None = None):
        """Train ``config`` on ``device``: the card unless the caller asks
        for the CPU; with a data-parallel group (``group``, the default
        group, or the launcher's environment) on the rank's device."""
        self.cfg = cfg = config
        device = torch.device(device)
        world = (group.world if group is not None else
                 dist.get_world_size() if dist.is_initialized() else launcher_world())
        check_ported(cfg, world)
        self.group, self._owns_group = data_group(cfg, device, group)
        self.world = 1 if self.group is None else self.group.world
        self.rank = 0 if self.group is None else self.group.rank
        self.is_master = self.rank == 0
        self.device = device if self.group is None else self.group.device
        mp = cfg.system.model_parallel
        if self.group is None and mp > 1:  # ≙ trainer.py:99-104
            raise ValueError(f"model_parallel={mp} requires a multi-device mesh ({self.world} device(s) "
                             f"visible, use_ddp={cfg.system.use_ddp})")
        # the data × model grid (≙ make_mesh); None on one rank
        self.mesh = None if self.group is None else make_mesh(self.group, mp, cfg.system.fsdp)
        self.data_world = 1 if self.mesh is None else self.mesh.data.world
        self.data_rank = 0 if self.mesh is None else self.mesh.data.rank
        if self.device.type == "cuda":
            # cuBLAS bf16 GEMMs (the dW/dx products) reduce split-K partials in
            # fp32, as the JAX step's preferred_element_type=f32 products do
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        accum = max(1, cfg.training.gradient_accumulation_steps)
        batch = cfg.training.batch_size
        if batch % accum:
            raise ValueError(f"batch_size={batch} not divisible by gradient_accumulation_steps={accum}")
        if batch % self.data_world:  # ≙ trainer.py:153-178
            raise ValueError(f"batch_size={batch} not divisible by the {self.data_world} ranks")
        if (batch // accum) % self.data_world:
            raise ValueError(f"per-micro-batch size {batch // accum} (batch_size/grad_accum) not "
                             f"divisible by the {self.data_world} ranks")
        self.out_dir = Path(cfg.data.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.logger = setup_logging(self.out_dir, level=cfg.system.log_level,
                                    to_file=cfg.system.log_to_file and self.is_master)
        if self.group is not None:
            self.logger.info("data parallel: rank %d of %d on %s (pid %d)", self.rank, self.world,
                             self.device, os.getpid())
            self.logger.info("mesh: data=%d, model=%d%s", self.data_world, mp,
                             ", fsdp" if self.mesh.fsdp else "")
        if cfg.system.fsdp and self.world == 1:
            # ≙ trainer.py:105-113: not an error, but no memory is saved
            self.logger.warning("system.fsdp requested on one rank: training with fully replicated "
                                "params/moments")
        self.iter_num = 0
        self.finished = False
        self.best_val_loss: float | None = None
        self.early_stopping_counter = 0
        self._eval_count = 0
        self._time_up = False  # rank 0's verdict on the time limit (see _time_limit_reached)
        self._sqk_drift_warned = False  # the drift warning is logged once per Trainer
        self._data_wait = 0.0  # seconds the loop waited for batches since the last log
        self.last_metrics: dict[str, float] = {}
        self.metrics_writer: MetricsWriter | None = None

        if cfg.training.init_from == "scratch":
            self.state = create_train_state(cfg, device=self.device)
        elif cfg.training.init_from == "wandb":
            self._resume(*self._download_wandb_artifact(cfg.wandb.artifact_name))
            cfg = self.cfg
        else:
            self._resume(cfg.data.checkpoint_dir, cfg.data.checkpoint_file.removesuffix(".npz"))
            cfg = self.cfg
        n = num_params(self.state.model)
        n_sharded = sum(p.numel() for name, p in self.state.model.named_parameters()
                        if shard_dim(name) is not None)
        if self.world > 1:  # ≙ shard_params: DDP's initial parameter broadcast
            st = self.state
            broadcast_(self.group, [*st.model.state_dict().values(), *st.opt_state.mu.values(),
                                    *st.opt_state.nu.values()])
            shard_state_(st, self.mesh)  # then each rank keeps its pieces
        grp = self.mesh
        self._train_step = make_train_step(cfg, log_norms=False, group=grp)
        self._train_step_norms = (make_train_step(cfg, log_norms=True, group=grp)
                                  if cfg.system.log_gpu_stats else self._train_step)
        # the eval-cadence variant: + per-tensor gradient histograms
        self._train_step_hist = (make_train_step(cfg, log_norms=cfg.system.log_gpu_stats,
                                                 log_histograms=True, group=grp)
                                 if cfg.system.log_grad_histograms else None)
        self._pending_grad_hists: dict[str, torch.Tensor] | None = None
        self._trace = None  # the profiler of the profile_steps window while it runs
        self._last_artifact: str | None = None
        self._eval_step = make_eval_step(cfg)

        self._pending_saves: list = []
        self._in_step = False  # True while a step rewrites the state in place
        self._deferred_signal: int | None = None
        self._cleaned = False  # cleanup() runs once per launch (signal paths enter twice)
        self._skip_final_save = False  # the state may be half-updated: no final save
        self._prev_handlers: dict | None = None  # train()'s signal handlers are installed

        self.logger.info("Model: %.2fM params | nvit=%s kohonen=%s | %s on %s", n / 1e6,
                         cfg.model.use_nvit, cfg.model.use_kohonen, cfg.data.dataset, self.device)
        if cfg.system.quick_validation and cfg.training.full_eval_interval == 0:
            # ≙ nvit_tpu/train/trainer.py:288-299: the reference's evaluate()
            # always runs the full val pass; here best-model selection and
            # early stopping only ever see the capped subset
            self.logger.warning(
                "quick_validation is on with full_eval_interval=0: every eval "
                "(incl. best-checkpoint selection) runs on a %d-example subset; "
                "set training.full_eval_interval=N to run the full val pass "
                "every Nth eval", cfg.system.quick_validation_size,
            )
        # MFU is a card's: this rank's rows of the global batch, and under TP
        # its share of the trunk's products
        self._flops_per_iter = estimate_flops_per_iter(
            cfg.model, n - n_sharded + n_sharded // mp, model_parallel=mp) * (batch // self.data_world)

    def _resume(self, ckpt_dir: str, name: str) -> None:
        """init_from="resume" (≙ trainer.py:189-224): the MODEL config comes
        from the checkpoint, the rest from the settings; the early-stop
        protocol's state from the checkpoint's meta."""
        state, saved_cfg, meta = restore_for_resume(ckpt_dir, name, device=self.device)
        if saved_cfg.model != self.cfg.model:
            self.logger.warning("checkpoint model config differs from settings; using checkpoint's")
            self.cfg = dataclasses.replace(self.cfg, model=saved_cfg.model)
        self.state = state
        self.iter_num = meta["iter_num"]
        tmeta = meta.get("trainer") or {}
        if tmeta.get("best_val_loss") is not None:
            self.best_val_loss = float(tmeta["best_val_loss"])
        self.early_stopping_counter = int(tmeta.get("early_stopping_counter", 0))
        self._eval_count = int(tmeta.get("eval_count", 0))
        self.logger.info("Resumed from iteration %d (best_val_loss=%s, patience=%d)",
                         self.iter_num, self.best_val_loss, self.early_stopping_counter)

    def _download_wandb_artifact(self, artifact_name: str) -> tuple[str, str]:
        """init_from="wandb": download the model artifact → (its directory,
        "checkpoint_best") (≙ trainer.py:302-316); online wandb only."""
        if self.cfg.wandb.mode != "online":
            raise ValueError("Wandb must be enabled and online to load from artifacts")
        try:
            import wandb  # type: ignore
        except ImportError as e:
            raise ValueError("init_from='wandb' requires the wandb package") from e
        artifact_dir = wandb.Api().artifact(artifact_name, type="model").download()
        if not (Path(artifact_dir) / "checkpoint_best.npz").exists():
            raise FileNotFoundError(f"Checkpoint not found in artifact: {artifact_dir}")
        return artifact_dir, "checkpoint_best"

    # ------------------------------------------------------------------ data
    def _load_data(self) -> None:
        """Both splits of ``data.dataset`` (≙ trainer.py:_load_data): rank 0
        downloads under ``data.download``, the others wait for its extract."""
        cfg = self.cfg
        download = cfg.data.download and self.is_master
        if cfg.data.download and cfg.data.dataset in ("cifar10", "cifar100") and not self.is_master:
            wait_for_cifar(cfg.data.data_dir, cfg.data.dataset)
        kw = dict(image_size=cfg.model.image_size, num_classes=cfg.model.num_classes, download=download)
        t0 = time.perf_counter()
        self.trainset = load_dataset(cfg.data.dataset, cfg.data.data_dir, train=True, **kw)
        self.valset = load_dataset(cfg.data.dataset, cfg.data.data_dir, train=False, **kw)
        self.load_seconds = time.perf_counter() - t0
        self.logger.info("datasets: %d train, %d val images in %.1f s", len(self.trainset),
                         len(self.valset), self.load_seconds)
        self.steps_per_epoch = max(1, len(self.trainset) // cfg.training.batch_size)

    def _epoch_iter(self, ds, *, epoch: int, shuffle: bool, drop_last: bool = True, start_batch: int = 0):
        """The epoch's batches on the device, ``data.prefetch`` in flight
        (≙ trainer.py:_epoch_iter): this data rank's strided shard of each
        global batch, the same for every rank of its model group; ragged
        batches would desync the ranks, so several drop them."""
        d = self.cfg.data
        it = make_epoch_iterator(ds, batch_size=self.cfg.training.batch_size // self.data_world, epoch=epoch,
                                 seed=self.cfg.training.seed, shuffle=shuffle,
                                 drop_last=drop_last or self.world > 1, num_workers=d.num_workers,
                                 shard_index=self.data_rank, shard_count=self.data_world,
                                 start_batch=start_batch)
        return device_prefetch(it, self.device, size=d.prefetch)

    def _timed(self, batches):
        """``batches``, adding the time each one was waited for to ``_data_wait``."""
        try:
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    return
                self._data_wait += time.perf_counter() - t0
                yield batch
        finally:
            batches.close()

    def _preprocess(self, imgs_u8: torch.Tensor, *, train: bool, step: int | None = None) -> torch.Tensor:
        """AutoAugment (train) and normalize; a train batch's draw is keyed
        by the run key and ``step`` (default ``iter_num``), as the JAX
        trainer keys it by ``fold_in(state.rng, step)``, and drawn for the
        global batch, of which this data rank's images are rows
        ``rank·b … (rank+1)·b − 1``."""
        aug = self.cfg.data.augmentation
        gen = step_generator(self.state.rng, self.iter_num if step is None else step) if train else None
        b = imgs_u8.shape[0]
        return preprocess(imgs_u8, gen, train=train, dataset=self.cfg.data.dataset,
                          auto_augment=aug.enabled and aug.auto_augment, row0=self.data_rank * b,
                          batch=self.data_world * b)

    def _sqk_drift_metrics(self) -> dict[str, float]:
        """Largest effective sqk and the bounded-softmax shift it implies
        (≙ trainer.py:_sqk_drift_metrics)."""
        m = self.cfg.model
        if not m.use_nvit:
            return {}
        model = self.state.model
        leaves = [blk.sqk for blk in model.transformer["h"]] + [model.cross_attention.sqk]
        eff_max = float(torch.stack([x.detach().abs().max() for x in leaves]).max()) * (
            SQK_INIT_VALUE / m.base_scale)
        bound = float(np.sqrt(m.n_embd // m.n_head)) * eff_max * eff_max
        # only the static "bounded" stabilizer degrades under drift: "rowmax"
        # is exact at any drift and "auto" routes itself to rowmax past its gate
        if bound > 40.0 and m.bounded_softmax == "bounded" and not self._sqk_drift_warned:
            self._sqk_drift_warned = True
            self.logger.warning(
                "sqk_eff drifted to %.2f (bounded-softmax shift %.1f): rows "
                "whose max score trails it by >60 degrade to uniform "
                "attention; switch model.bounded_softmax=rowmax", eff_max, bound,
            )
        return {"scales/sqk_eff_max": eff_max, "scales/attn_bound": bound}

    def _time_limit_reached(self, tlaunch: float) -> bool:
        """The launch's time limit (≙ trainer.py:415-435): one rank checks
        its own clock every iteration; several take rank 0's verdict,
        broadcast at a lockstep point (every ``log_interval``-th iteration),
        so no rank leaves the loop a step before another."""
        if self._time_up:
            return True
        up = time.time() - tlaunch >= self.cfg.training.time_limit_seconds
        if self.world == 1:
            self._time_up = up
        elif self.iter_num % self.cfg.training.log_interval == 0:
            self._time_up = broadcast_flag(self.group, up)
        return self._time_up

    def _signalled(self) -> bool:
        """At the step boundary: has a deferred signal arrived — on any rank,
        with several, which agree on it here, every step (≙ :590-605)."""
        got = self._deferred_signal is not None
        return got if self.world == 1 else any_flag(self.group, got)

    # ----------------------------------------------------------------- train
    def train(self) -> None:
        """Main training loop (≙ trainer.py:Trainer.train)."""
        cfg = self.cfg
        tc = cfg.training
        try:
            tlaunch = time.time()
            self._time_up = False
            self._cleaned = False  # re-arm cleanup for this launch
            self._install_signal_handlers()
            self._load_data()
            if len(self.trainset) // self.data_world < tc.batch_size // self.data_world:
                raise ValueError(f"training dataset ({len(self.trainset)} examples) is smaller "
                                 f"than one batch ({tc.batch_size})")
            if self.is_master:
                self.metrics_writer = MetricsWriter(self.out_dir, wandb_mode=cfg.wandb.mode,
                                                    run_name=cfg.wandb.run_name, project=cfg.wandb.project,
                                                    config=cfg.to_dict())
            if tc.init_from == "resume" and not self._sentinel_allows_resume():
                self.logger.info("finished sentinel present; not relaunching")
                return
            if self.iter_num == 0 and tc.init_from == "scratch" and self.is_master:
                write_stat_line(self.out_dir, iter_num=0, lr=0.0, train_loss=0.0, val_loss=0.0,
                                model=self.state.model, cfg=cfg, append=False)
            timer = StepTimer(self._flops_per_iter, device_peak_flops(self.device))
            local_iter = 0
            epoch = self.iter_num // self.steps_per_epoch

            def stop() -> bool:
                return (local_iter >= tc.max_iters_per_launch or self.iter_num >= tc.max_iters
                        or self._time_limit_reached(tlaunch) or self.finished)

            while not stop():
                # a resumed launch skips the batches its epoch already trained on
                for imgs_u8, labels in self._timed(self._epoch_iter(
                    self.trainset, epoch=epoch, shuffle=True,
                    start_batch=max(0, self.iter_num - epoch * self.steps_per_epoch),
                )):
                    if stop():
                        break
                    if self.iter_num % tc.eval_interval == 0:
                        ev = self.evaluate()
                        if self.is_master:
                            write_stat_line(self.out_dir, iter_num=self.iter_num,
                                            lr=float(cosine_lr(cfg.optimizer, self.iter_num)),
                                            train_loss=ev["train/loss"], val_loss=ev["val/loss"],
                                            model=self.state.model, cfg=cfg)
                    # trace steps [1, 1 + profile_steps): step 0 warms up
                    if cfg.system.profile_steps > 0 and local_iter == 1:
                        self._trace = start_trace(self.out_dir, self.device)
                    images = self._preprocess(imgs_u8, train=True)
                    # the norms variant only on iterations whose metrics are logged
                    step_fn = (self._train_step_norms if (self.iter_num + 1) % tc.log_interval == 0
                               else self._train_step)
                    # the histogram variant on the step feeding an eval, whose
                    # evaluate() logs the counts; not on the step reaching
                    # max_iters, which leaves the loop before that eval
                    if (self._train_step_hist is not None
                            and (self.iter_num + 1) % tc.eval_interval == 0
                            and self.iter_num + 1 < tc.max_iters):
                        step_fn = self._train_step_hist
                    # the step rewrites the state in place: a signal handler
                    # that fires meanwhile defers to the boundary below
                    self._in_step = True
                    self.state, step_metrics = step_fn(self.state, images, labels)
                    self._in_step = False
                    self.iter_num += 1
                    local_iter += 1
                    hists = {k: step_metrics.pop(k) for k in list(step_metrics) if k.startswith("gradhist/")}
                    if hists:
                        self._pending_grad_hists = hists
                    if self._trace is not None and local_iter == 1 + cfg.system.profile_steps:
                        float(step_metrics["total_loss"])  # the window's device work, all in the trace
                        self._stop_trace()
                    if self._signalled():
                        self.logger.info("Handling deferred signal %s at step boundary",
                                         self._deferred_signal)
                        self.cleanup()
                        sys.exit(0)
                    if self.iter_num % tc.log_interval == 0:
                        self._log_step(step_metrics, timer)
                epoch += 1

            # a run that reached max_iters is done; launch limits do not mark it
            if self.iter_num >= tc.max_iters and not self.finished:
                self.logger.info("Reached max_iters (%d); writing finished sentinel", tc.max_iters)
                self.mark_training_finished(f"max_iters:{tc.max_iters}")
        except Exception as e:
            # raised inside the in-place update: the state may be torn; with
            # shards the other ranks may not join the final save's gather
            if self._in_step or (self.mesh is not None and self.mesh.sharded):
                self._skip_final_save = True
            self.logger.error("training failed: %s", e)
            raise
        finally:
            self.cleanup()

    def _sentinel_allows_resume(self) -> bool:
        """The ``finished`` sentinel rule (≙ trainer.py:470-498): a
        ``max_iters:N`` sentinel is cleared by a resume with ``max_iters > N``
        (an extension of a completed run); any other sentinel (early stop)
        is final."""
        sentinel = self.out_dir / "finished"
        if not sentinel.exists():
            return True
        try:
            text = sentinel.read_text().strip()
        except FileNotFoundError:  # rank 0 cleared it meanwhile: its verdict is "extend"
            text = "max_iters:-1"
        done_at = None
        if text.startswith("max_iters:"):
            try:
                done_at = int(text.split(":", 1)[1])
            except ValueError:
                done_at = None
        if done_at is None or self.cfg.training.max_iters <= done_at:
            return False
        self.logger.info("finished sentinel from a completed max_iters=%d run; extending to "
                         "max_iters=%d", done_at, self.cfg.training.max_iters)
        if self.is_master:
            sentinel.unlink(missing_ok=True)
        return True

    def _log_step(self, step_metrics: dict[str, torch.Tensor], timer: StepTimer) -> None:
        if not self.is_master:  # the metrics are the same on every rank
            return
        tc = self.cfg.training
        keys = list(step_metrics)
        # ONE device-to-host transfer for every step metric
        values = dict(zip(keys, torch.stack([step_metrics[k].float().reshape(()).to(self.device)
                                             for k in keys]).tolist()))
        dt, mfu = timer.tick()
        dt /= tc.log_interval
        wait, self._data_wait = self._data_wait / tc.log_interval, 0.0
        train_metrics = {
            "train/iter": self.iter_num,
            "train/batch_loss": values["total_loss"],
            "train/batch_time_ms": dt * 1000,
            "train/data_wait_ms": wait * 1000,
            "train/mfu": None if mfu is None else mfu * tc.log_interval,
            "optimizer/learning_rate": values["learning_rate"],
            **{f"train/{k}": v for k, v in values.items() if k.endswith(("_loss", "_norm"))},
            **{f"system/{k}": v for k, v in memory_stats(self.cfg.system.log_memory, self.device).items()},
        }
        self.metrics_writer.log(train_metrics, step=self.iter_num)
        self.logger.info("Iter: %d/%d Loss: %.4f LR: %.4e Time: %.1fms", self.iter_num,
                         tc.max_iters, values["total_loss"], values["learning_rate"], dt * 1000)

    # ------------------------------------------------------------------ eval
    def estimate_loss(self) -> dict[str, float]:
        """Mean weighted loss over ``eval_iters`` batches of both splits
        (≙ trainer.py:estimate_loss), over ranks too; the train batches
        rotate with the step."""
        out = {}
        for split, ds in (("train", self.trainset), ("val", self.valset)):
            train = split == "train"
            losses = []
            for k, (imgs_u8, labels) in enumerate(self._epoch_iter(
                    ds, epoch=self.iter_num if train else 0, shuffle=train, drop_last=False)):
                if k >= self.cfg.training.eval_iters:
                    break
                # the train split under the training distribution: each batch
                # augmented with its own key, step + k (≙ trainer.py:684-686)
                images = self._preprocess(imgs_u8, train=train, step=self.iter_num + k)
                m = self._eval_step(self.state.model, images, labels)
                losses.append(m["loss"])
            out[split] = float(np.mean(torch.stack(losses).cpu().numpy())) if losses else math.nan
        return out if self.world == 1 else mean_metrics(self.group, out)

    def validate(self, *, quick: bool = False) -> dict[str, float]:
        """Validation pass with top-1/top-5 (≙ trainer.py:validate), each
        rank over its shard, the means over ranks; ``quick`` caps it at
        ``quick_validation_size`` examples."""
        cfg = self.cfg
        max_batches = None
        if quick and cfg.system.quick_validation:
            max_batches = max(1, cfg.system.quick_validation_size // cfg.training.batch_size)
        # (eval-step key, logged name), the Kohonen terms under the JAX trainer's names
        keep = [("loss", "loss"), ("top1_accuracy", "top1_accuracy"), ("top5_accuracy", "top5_accuracy")]
        if cfg.model.use_kohonen:
            keep += [("kohonen_consistency", "consistency_loss"), ("kohonen_smoothness", "smoothness_loss"),
                     ("local_quantization", "local_quantization_loss"),
                     ("global_quantization", "global_quantization_loss")]
        collected = []
        for imgs_u8, labels in self._epoch_iter(self.valset, epoch=0, shuffle=False, drop_last=False):
            if max_batches is not None and len(collected) >= max_batches:
                break
            m = self._eval_step(self.state.model, self._preprocess(imgs_u8, train=False), labels)
            collected.append(torch.stack([m[k].float() for k, _ in keep]))
        if not collected:
            raise ValueError(f"validation produced zero batches: val set has {len(self.valset)} "
                             f"examples for batch {cfg.training.batch_size} over {self.data_world} "
                             "data rank(s)")
        means = torch.stack(collected).cpu().double().mean(dim=0).tolist()
        metrics = {f"val/{name}": v for (_, name), v in zip(keep, means)}
        return metrics if self.world == 1 else mean_metrics(self.group, metrics)

    def validate_only(self) -> dict[str, float]:
        """``eval_only``: the full validation pass on the resumed checkpoint
        (≙ trainer.py:738-746)."""
        self.logger.info("Running in validation-only mode")
        if self.cfg.training.init_from != "resume":
            raise ValueError("Must provide a checkpoint to run validation-only mode")
        self._load_data()
        metrics = self.validate()
        self.logger.info("Validation metrics: %s", metrics)
        return metrics

    def evaluate(self) -> dict[str, float]:
        """Periodic eval: validate + estimate_loss + early stop + checkpoints
        (≙ trainer.py:evaluate)."""
        cfg = self.cfg
        self._eval_count += 1
        full = (cfg.training.full_eval_interval > 0
                and self._eval_count % cfg.training.full_eval_interval == 0)
        metrics = {
            "train/loss": self.estimate_loss()["train"],
            **self.validate(quick=not full),
            "optimizer/learning_rate": float(cosine_lr(cfg.optimizer, self.iter_num)),
            "training/global_step": self.iter_num,
            **self._sqk_drift_metrics(),
        }
        if self._pending_grad_hists:
            # from the histogram step just before: one transfer for all the counts
            hists, self._pending_grad_hists = self._pending_grad_hists, None
            metrics.update(zip(hists, torch.stack(list(hists.values())).cpu().tolist()))
        self.last_metrics = dict(metrics)
        if self.metrics_writer is not None:
            self.metrics_writer.log(metrics, step=self.iter_num)
        # strict improvement, read before _should_stop_early updates the best
        val_loss = metrics["val/loss"]
        improved = self.best_val_loss is None or val_loss < self.best_val_loss
        if self._should_stop_early(val_loss):
            self.logger.info("Early stopping triggered!")
            self.mark_training_finished()
        if self.iter_num > 0:
            if cfg.training.always_save_checkpoint:
                self.save(metrics)
            if improved:
                # whatever always_save_checkpoint says, and only here: the
                # weights saved are the ones that earned the improvement
                self.save_best(metrics)
        return metrics

    def _should_stop_early(self, val_loss: float) -> bool:
        if self.best_val_loss is None:
            self.best_val_loss = math.inf
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            self.early_stopping_counter = 0
        else:
            self.early_stopping_counter += 1
        return self.early_stopping_counter >= self.cfg.training.early_stopping_patience

    # ------------------------------------------------------------ checkpoint
    def _join_pending_saves(self) -> None:
        """Wait for the file writes in flight; re-raise a failed one, so a run
        never goes on logging saves that did not land."""
        pending, self._pending_saves = self._pending_saves, []
        for save in pending:
            save.result()

    def _trainer_meta(self) -> dict[str, Any]:
        """The early-stop protocol's state, carried across launches in the meta."""
        return {"best_val_loss": self.best_val_loss,
                "early_stopping_counter": self.early_stopping_counter,
                "eval_count": self._eval_count}

    def _save_one(self, name: str, metrics: dict[str, Any] | None, leaves) -> None:
        self._pending_saves.append(save_checkpoint_async(
            self.out_dir, name, self.state, self.cfg, metrics, self._trainer_meta(), leaves))

    def _gathered(self):
        """Every rank: under TP/FSDP the whole state's leaves, gathered to
        rank 0 (None elsewhere, and without shards: the save copies)."""
        if self.mesh is None or not self.mesh.sharded:
            return None
        return gathered_leaves(self.state, self.mesh)

    def save(self, metrics: dict[str, Any] | None = None) -> None:
        """checkpoint_latest (and checkpoint_<iter> with save_numbered_checkpoints):
        the host copy now, the file writes on a thread; rank 0 writes (every
        rank gathers under TP/FSDP)."""
        t0 = time.time()
        leaves = self._gathered()
        if not self.is_master:
            return
        self._join_pending_saves()
        metrics = metrics or self.last_metrics
        self._save_one("checkpoint_latest", metrics, leaves)
        if self.cfg.training.save_numbered_checkpoints:
            self._save_one(f"checkpoint_{self.iter_num:07d}", metrics, leaves)
        self.logger.info("Checkpoint snapshot time: %.2f sec", time.time() - t0)

    def save_best(self, metrics: dict[str, Any]) -> None:
        """checkpoint_best, from evaluate() on a strict improvement only;
        rank 0 writes (every rank gathers under TP/FSDP)."""
        leaves = self._gathered()
        if not self.is_master:
            return
        self._join_pending_saves()
        self._save_one("checkpoint_best", metrics, leaves)
        self._maybe_log_artifact()

    def _maybe_log_artifact(self) -> None:
        """checkpoint_best as a wandb model artifact, the previous version
        deleted (≙ trainer.py:880-911); nothing without wandb."""
        mw = self.metrics_writer
        if mw is None or mw.wandb is None or not self.cfg.wandb.save_artifacts:
            return
        self._join_pending_saves()  # the artifact reads the files
        wandb = mw.wandb
        kind = "nvit" if self.cfg.model.use_nvit else "vit"
        name = f"model-{self.cfg.wandb.run_name}-{kind}-{time.strftime('%d_%m_%Y-%Hh%Mm')}"
        try:
            artifact = wandb.Artifact(name=name, type="model", metadata={
                "iter_num": self.iter_num, "metrics": self.last_metrics,
                "using_nvit": self.cfg.model.use_nvit})
            artifact.add_file(str(self.out_dir / "checkpoint_best.npz"))
            artifact.add_file(str(self.out_dir / "checkpoint_best.json"))
            wandb.log_artifact(artifact)
            if self._last_artifact:
                try:
                    wandb.Api().artifact(
                        f"{wandb.run.entity}/{wandb.run.project}/{self._last_artifact}").delete()
                except Exception as e:  # the new version is logged; the old one may stay
                    self.logger.info("Failed to delete old artifact: %s", e)
            self._last_artifact = name
        except Exception as e:  # the sink never stops the run
            self.logger.warning("artifact logging failed: %s", e)

    def mark_training_finished(self, reason: str = "early_stop") -> None:
        """The relaunch protocol's sentinel (≙ trainer.py:mark_training_finished):
        ``early_stop`` is final, ``max_iters:N`` lets a resume with a larger
        ``max_iters`` extend the run.  Every rank stops; rank 0 writes."""
        self.finished = True
        if self.is_master:
            (self.out_dir / "finished").write_text(reason)

    # --------------------------------------------------------------- cleanup
    def _install_signal_handlers(self) -> None:
        """SIGINT/SIGTERM → save checkpoint_latest, clean up, exit 0
        (≙ trainer.py:929-974), until cleanup() restores the previous ones.
        With several ranks every signal defers to the step boundary, where
        the ranks stop together; a second one exits 1 at once."""

        def handler(signum, frame):
            if self._in_step or self.world > 1:
                if self._deferred_signal is not None:
                    # a second signal while the same step still runs: the
                    # step may hang, so exit now, without the torn state
                    self.logger.warning(
                        "Second signal %s before the step boundary — forcing exit without "
                        "a final save (resume from the last periodic checkpoint)", signum)
                    self._skip_final_save = True
                    self.cleanup()
                    sys.exit(1)
                # the update rewrites parameters and moments one by one: a
                # save from here could hold half of them updated
                self._deferred_signal = signum
                self.logger.info("Received signal %s mid-step; deferring cleanup to the "
                                 "step boundary", signum)
                return
            self.logger.info("Received signal %s. Performing cleanup...", signum)
            self.cleanup()
            sys.exit(0)

        try:
            prev = {s: signal.signal(s, handler) for s in (signal.SIGINT, signal.SIGTERM)}
        except ValueError:
            return  # not the main thread
        if self._prev_handlers is None:
            self._prev_handlers = prev

    def _restore_signal_handlers(self) -> None:
        prev, self._prev_handlers = self._prev_handlers, None
        for signum, handler in (prev or {}).items():
            signal.signal(signum, handler)

    def _stop_trace(self) -> None:
        trace, self._trace = self._trace, None
        if trace is not None:
            stop_trace(trace)

    def cleanup(self) -> None:
        """The final checkpoint_latest (rank 0), the pending writes, the
        sinks, the group the Trainer formed (≙ trainer.py:976-1013).
        checkpoint_best is evaluate()'s alone.  Runs once per launch (a
        signal reaches it twice) and never raises."""
        self._restore_signal_handlers()
        if self._cleaned:
            return
        self._cleaned = True
        try:
            self._stop_trace()  # a run that ended inside the window
            if not self._skip_final_save and self.iter_num > 0:
                self.save(self.last_metrics)
            self._join_pending_saves()  # do not exit while a write is in flight
            if self.metrics_writer is not None:
                self.metrics_writer.finish()
                self.metrics_writer = None
            self.release_group()
        except Exception as e:  # teardown must not mask the exit path
            self.logger.error("Error during cleanup: %s", e)

    def release_group(self) -> None:
        """Destroy the data-parallel group if the Trainer formed it."""
        if self._owns_group:
            self._owns_group = False
            destroy(self.group)


def launch_argv(env: Mapping[str, str], cfg: Config, cards: int) -> list[str] | None:
    """The launcher command ``python -m nvit_tpu_torch`` re-executes itself
    under (≙ nvit_tpu/__main__.py:14-35: JAX drives every local chip from
    one process; the port runs one process per card), or None to train in
    this process.  ``cards``: the cards visible here.

    * ``NVIT_MULTIHOST=1`` with ``JAX_COORDINATOR_ADDRESS`` (host:port),
      ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``: ``torch.distributed.run``
      over that many hosts, this one ``--node_rank``, the coordinator as
      the master, one process per card here (one on the CPU); the same
      command runs on every host;
    * several cards and ``system.use_ddp``: ``--standalone`` with one
      process per card.

    Not under a launcher already (``WORLD_SIZE`` set)."""
    if "WORLD_SIZE" in env:
        return None
    on_cards = cfg.system.device != "cpu"
    per_host = max(1, cards) if on_cards else 1
    run = [sys.executable, "-m", "torch.distributed.run"]
    module = ["-m", "nvit_tpu_torch"]
    if env.get("NVIT_MULTIHOST") == "1":
        coord = env.get("JAX_COORDINATOR_ADDRESS")
        if not coord:
            raise ValueError("NVIT_MULTIHOST=1 needs JAX_COORDINATOR_ADDRESS (host:port), "
                             "JAX_NUM_PROCESSES and JAX_PROCESS_ID: the TPU pod auto-detection "
                             "of jax.distributed.initialize() has no counterpart here")
        host, sep, port = coord.rpartition(":")
        if not sep or not host or not port.isdigit():
            raise ValueError(f"JAX_COORDINATOR_ADDRESS must be host:port, got {coord!r}")
        try:
            nodes, node_rank = int(env["JAX_NUM_PROCESSES"]), int(env["JAX_PROCESS_ID"])
        except (KeyError, ValueError) as e:
            raise ValueError("NVIT_MULTIHOST=1 needs integer JAX_NUM_PROCESSES and JAX_PROCESS_ID") from e
        if not 0 <= node_rank < nodes:
            raise ValueError(f"JAX_PROCESS_ID={node_rank} not in [0, JAX_NUM_PROCESSES={nodes})")
        return [*run, f"--nnodes={nodes}", f"--node_rank={node_rank}", f"--master_addr={host}",
                f"--master_port={port}", f"--nproc_per_node={per_host}", *module]
    if on_cards and cfg.system.use_ddp and cards > 1:
        return [*run, "--standalone", f"--nproc_per_node={cards}", *module]
    return None


def main() -> None:
    """``python -m nvit_tpu_torch``: load the config (``settings.yaml``, the
    environment) and train, or validate under ``eval_only`` — on the card
    unless ``system.device`` is ``"cpu"``.  With several cards and
    ``use_ddp``, or under ``NVIT_MULTIHOST=1``, it re-executes itself under
    ``torch.distributed.run`` (``launch_argv``); under a launcher each
    process trains its rank."""
    cfg = load_config()
    argv = launch_argv(os.environ, cfg, torch.cuda.device_count() if cfg.system.device != "cpu" else 0)
    if argv is not None:
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(argv[0], argv)  # torchrun forwards SIGTERM/SIGINT to its workers
    trainer = Trainer(cfg, device="cpu" if cfg.system.device == "cpu" else "cuda")
    try:
        if trainer.cfg.training.eval_only:
            trainer.validate_only()
        else:
            trainer.train()
    finally:
        trainer.release_group()
