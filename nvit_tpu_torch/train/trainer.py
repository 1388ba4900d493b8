"""Trainer: the host loop around the train step (≙ nvit_tpu/train/trainer.py,
``Trainer.train`` :446-666 and ``estimate_loss`` / ``validate`` /
``evaluate`` :668-806).

Ported: evaluation at ``eval_interval`` over ``eval_iters`` batches of both
splits plus the (quick) validation pass, early stopping, a log every
``log_interval`` iterations to ``out_dir/metrics.jsonl`` (loss terms,
learning rate, ``train/batch_time_ms``, ``train/mfu``, norms, memory), the
``out_dir/stat`` line at every eval, the launch limits, and the ``finished``
sentinel at ``max_iters``.

Not ported yet, and refused at construction with ``NotImplementedError``
naming the ROADMAP.md item, never skipped silently: checkpoint save and
resume and ``eval_only``; wandb; AutoAugment and datasets other than
``synthetic``; ``remat`` and bf16 moments; more than one device; gradient
histograms, profiling and the NaN sanitizer; Kohonen (``ViT`` raises).  The JAX trainer also writes ``checkpoint_best`` on every
improvement and ``checkpoint_latest`` at exit whatever the config says;
this one logs a warning that it does not.  ``jit``, ``compile``,
``compilation_cache_dir``, ``clear_cache``, ``backend`` and ``device`` are
TPU/XLA settings with no PyTorch counterpart and are ignored, and so is
``system.use_tqdm``: the JAX trainer's progress bar changes no result.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from nvit_tpu_torch.configs import Config
from nvit_tpu_torch.data.augment import preprocess
from nvit_tpu_torch.data.datasets import load_dataset
from nvit_tpu_torch.data.pipeline import iterate_array, to_device
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
from nvit_tpu_torch.train.state import create_train_state
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


def check_ported(cfg: Config, device: torch.device) -> None:
    """Raise ``NotImplementedError`` for every setting that would take the
    JAX trainer into a part this port does not have yet."""
    t, s, d = cfg.training, cfg.system, cfg.data
    multi_gpu = s.model_parallel > 1 or (
        s.use_ddp and device.type == "cuda" and torch.cuda.device_count() > 1)
    unported = [
        (t.init_from != "scratch", f"training.init_from={t.init_from!r}", "checkpoint files"),
        (t.eval_only, "training.eval_only", "checkpoint files"),
        (t.always_save_checkpoint or t.save_numbered_checkpoints,
         "checkpoint saving (training.always_save_checkpoint / save_numbered_checkpoints)",
         "checkpoint files"),
        (cfg.wandb.mode != "disabled", f"wandb.mode={cfg.wandb.mode!r}", "wandb"),
        (d.augmentation.enabled and d.augmentation.auto_augment,
         "data.augmentation.auto_augment", "AutoAugment"),
        (d.dataset.lower() != "synthetic", f"data.dataset={d.dataset!r}",
         "datasets and the data pipeline"),
        (s.remat, "system.remat", "remat"),
        (cfg.optimizer.moments_dtype != "float32",
         f"optimizer.moments_dtype={cfg.optimizer.moments_dtype!r}", "bf16 moments"),
        (multi_gpu, "more than one device (system.use_ddp with several cards, model_parallel)",
         "multi-GPU"),
        (s.log_grad_histograms, "system.log_grad_histograms", "observability"),
        (s.profile_steps > 0, "system.profile_steps", "observability"),
        (s.debug_nans, "system.debug_nans", "observability"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, '{item}')")


class Trainer:
    def __init__(self, config: Config, *, device: torch.device | str = "cuda"):
        """Train ``config`` on ``device``: the card unless the caller asks for the CPU."""
        self.cfg = cfg = config
        self.device = torch.device(device)
        check_ported(cfg, self.device)
        if self.device.type == "cuda":
            # cuBLAS bf16 GEMMs (the dW/dx products) reduce split-K partials in
            # fp32, as the JAX step's preferred_element_type=f32 products do
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        accum = max(1, cfg.training.gradient_accumulation_steps)
        if cfg.training.batch_size % accum:
            raise ValueError(f"batch_size={cfg.training.batch_size} not divisible by "
                             f"gradient_accumulation_steps={accum}")
        self.out_dir = Path(cfg.data.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.logger = setup_logging(self.out_dir, level=cfg.system.log_level,
                                    to_file=cfg.system.log_to_file)
        self.iter_num = 0
        self.finished = False
        self.best_val_loss: float | None = None
        self.early_stopping_counter = 0
        self._eval_count = 0
        self._sqk_drift_warned = False  # the drift warning is logged once per Trainer
        self.last_metrics: dict[str, float] = {}
        self.metrics_writer: MetricsWriter | None = None

        self.state = create_train_state(cfg, device=self.device)
        self._train_step = make_train_step(cfg, log_norms=False)
        self._train_step_norms = (make_train_step(cfg, log_norms=True)
                                  if cfg.system.log_gpu_stats else self._train_step)
        self._eval_step = make_eval_step(cfg)

        n = num_params(self.state.model)
        self.logger.info("Model: %.2fM params | nvit=%s kohonen=%s | %s on %s", n / 1e6,
                         cfg.model.use_nvit, cfg.model.use_kohonen, cfg.data.dataset, self.device)
        self.logger.warning("checkpoint_best and the final checkpoint_latest are not written: "
                            "checkpoint files are not ported yet (ROADMAP.md, 'checkpoint files')")
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
        self._flops_per_iter = estimate_flops_per_iter(cfg.model, n) * cfg.training.batch_size

    # ------------------------------------------------------------------ data
    def _load_data(self) -> None:
        cfg = self.cfg
        kw = dict(image_size=cfg.model.image_size, num_classes=cfg.model.num_classes)
        t0 = time.perf_counter()
        self.trainset = load_dataset(cfg.data.dataset, cfg.data.data_dir, train=True, **kw)
        self.valset = load_dataset(cfg.data.dataset, cfg.data.data_dir, train=False, **kw)
        self.load_seconds = time.perf_counter() - t0
        self.logger.info("datasets: %d train, %d val images in %.1f s", len(self.trainset),
                         len(self.valset), self.load_seconds)
        self.steps_per_epoch = max(1, len(self.trainset) // cfg.training.batch_size)

    def _epoch_iter(self, ds, *, epoch: int, shuffle: bool, drop_last: bool = True, start_batch: int = 0):
        for batch in iterate_array(ds, batch_size=self.cfg.training.batch_size, epoch=epoch,
                                   seed=self.cfg.training.seed, shuffle=shuffle,
                                   drop_last=drop_last, start_batch=start_batch):
            yield to_device(batch, self.device)

    def _preprocess(self, imgs_u8: torch.Tensor, *, train: bool) -> torch.Tensor:
        aug = self.cfg.data.augmentation
        return preprocess(imgs_u8, train=train, auto_augment=aug.enabled and aug.auto_augment)

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

    # ----------------------------------------------------------------- train
    def train(self) -> None:
        """Main training loop (≙ trainer.py:Trainer.train)."""
        cfg = self.cfg
        tc = cfg.training
        try:
            tlaunch = time.time()
            self._load_data()
            if len(self.trainset) < tc.batch_size:
                raise ValueError(f"training dataset ({len(self.trainset)} examples) is smaller "
                                 f"than one batch ({tc.batch_size})")
            self.metrics_writer = MetricsWriter(self.out_dir, wandb_mode=cfg.wandb.mode)
            if self.iter_num == 0:
                write_stat_line(self.out_dir, iter_num=0, lr=0.0, train_loss=0.0, val_loss=0.0,
                                model=self.state.model, cfg=cfg, append=False)
            timer = StepTimer(self._flops_per_iter, device_peak_flops(self.device))
            local_iter = 0
            epoch = self.iter_num // self.steps_per_epoch

            def stop() -> bool:
                return (local_iter >= tc.max_iters_per_launch or self.iter_num >= tc.max_iters
                        or time.time() - tlaunch >= tc.time_limit_seconds or self.finished)

            while not stop():
                for imgs_u8, labels in self._epoch_iter(
                    self.trainset, epoch=epoch, shuffle=True,
                    start_batch=max(0, self.iter_num - epoch * self.steps_per_epoch),
                ):
                    if stop():
                        break
                    if self.iter_num % tc.eval_interval == 0:
                        ev = self.evaluate()
                        write_stat_line(self.out_dir, iter_num=self.iter_num,
                                        lr=float(cosine_lr(cfg.optimizer, self.iter_num)),
                                        train_loss=ev["train/loss"], val_loss=ev["val/loss"],
                                        model=self.state.model, cfg=cfg)
                    images = self._preprocess(imgs_u8, train=True)
                    # the norms variant only on iterations whose metrics are logged
                    step_fn = (self._train_step_norms if (self.iter_num + 1) % tc.log_interval == 0
                               else self._train_step)
                    self.state, step_metrics = step_fn(self.state, images, labels)
                    self.iter_num += 1
                    local_iter += 1
                    if self.iter_num % tc.log_interval == 0:
                        self._log_step(step_metrics, timer)
                epoch += 1

            if self.iter_num >= tc.max_iters and not self.finished:
                self.logger.info("Reached max_iters (%d); writing finished sentinel", tc.max_iters)
                self.mark_training_finished(f"max_iters:{tc.max_iters}")
        except Exception as e:
            self.logger.error("training failed: %s", e)
            raise
        finally:
            self.cleanup()

    def _log_step(self, step_metrics: dict[str, torch.Tensor], timer: StepTimer) -> None:
        tc = self.cfg.training
        keys = list(step_metrics)
        # ONE device-to-host transfer for every step metric
        values = dict(zip(keys, torch.stack([step_metrics[k].float().reshape(()).to(self.device)
                                             for k in keys]).tolist()))
        dt, mfu = timer.tick()
        dt /= tc.log_interval
        train_metrics = {
            "train/iter": self.iter_num,
            "train/batch_loss": values["total_loss"],
            "train/batch_time_ms": dt * 1000,
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
        (≙ trainer.py:estimate_loss); the train batches rotate with the step."""
        out = {}
        for split, ds in (("train", self.trainset), ("val", self.valset)):
            train = split == "train"
            losses = []
            for k, (imgs_u8, labels) in enumerate(self._epoch_iter(
                    ds, epoch=self.iter_num if train else 0, shuffle=train, drop_last=False)):
                if k >= self.cfg.training.eval_iters:
                    break
                m = self._eval_step(self.state.model, self._preprocess(imgs_u8, train=train), labels)
                losses.append(m["loss"])
            out[split] = float(np.mean(torch.stack(losses).cpu().numpy())) if losses else math.nan
        return out

    def validate(self, *, quick: bool = False) -> dict[str, float]:
        """Validation pass with top-1/top-5 (≙ trainer.py:validate);
        ``quick`` caps it at ``quick_validation_size`` examples."""
        cfg = self.cfg
        max_batches = None
        if quick and cfg.system.quick_validation:
            max_batches = max(1, cfg.system.quick_validation_size // cfg.training.batch_size)
        keep = ("loss", "top1_accuracy", "top5_accuracy")
        collected = []
        for imgs_u8, labels in self._epoch_iter(self.valset, epoch=0, shuffle=False, drop_last=False):
            if max_batches is not None and len(collected) >= max_batches:
                break
            m = self._eval_step(self.state.model, self._preprocess(imgs_u8, train=False), labels)
            collected.append(torch.stack([m[k].float() for k in keep]))
        if not collected:
            raise ValueError(f"validation produced zero batches: val set has {len(self.valset)} "
                             f"examples for batch {cfg.training.batch_size}")
        means = torch.stack(collected).cpu().double().mean(dim=0).tolist()
        return {f"val/{k}": v for k, v in zip(keep, means)}

    def evaluate(self) -> dict[str, float]:
        """Periodic eval: validate + estimate_loss + early stop
        (≙ trainer.py:evaluate, without its checkpoint writes)."""
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
        self.last_metrics = dict(metrics)
        self.metrics_writer.log(metrics, step=self.iter_num)
        if self._should_stop_early(metrics["val/loss"]):
            self.logger.info("Early stopping triggered!")
            self.mark_training_finished()
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

    def mark_training_finished(self, reason: str = "early_stop") -> None:
        """The relaunch protocol's sentinel (≙ trainer.py:mark_training_finished)."""
        self.finished = True
        (self.out_dir / "finished").write_text(reason)

    def cleanup(self) -> None:
        if self.metrics_writer is not None:
            self.metrics_writer.finish()
            self.metrics_writer = None
