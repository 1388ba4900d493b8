"""The train and eval steps (≙ nvit_tpu/train/step.py:44-214).

One training step: the forward and the weighted loss, the backward (K2 and K4
run inside it, behind ``FlashQKNormFn`` and ``GatedMLPFn``), then the fused
clip + AdamW + renorm update, then — with Kohonen and ``kohonen_hebbian`` not
"off" — the maps' Hebbian deltas added to their nodes (≙ :149-155).
Gradient accumulation runs over DISTINCT micro-batches: ``.grad`` sums them,
and the sum is divided by the count (≙ the JAX ``lax.scan``, :99-134); the
Hebbian deltas, each computed against the pre-step nodes, are summed and not
divided.  No GradScaler: bf16 needs no loss scaling.  PyTorch runs eagerly,
so there is no jit.

Across processes (``group``: a data-parallel group or a data × model
``Mesh``, ``parallel/mesh.py``; ≙ the step under a mesh, where XLA's
partitioner inserts the collectives) each data rank runs the step on its
rows of the global batch, the ranks of a model group on the same rows with
the trunk's shards (their collectives run inside the forward and backward,
``parallel/tensor.py``).  After the micro-batch loop, in this order: the
gradients of ``sqk`` and ``suv``, which each model rank reads at its own
heads and rows, are SUMMED over the model axis; the gradients and the loss
terms are averaged over the data axis (one all-reduce; every loss term is a
per-sample mean), but for the FSDP pieces, whose gradients the backward's
reduce-scatter summed already and which are divided by the data ranks; the
Hebbian deltas are SUMMED over the data axis only (a delta is a batch sum:
under SPMD it is the global batch's, and the model ranks of a group compute
the same one).  The clip's norm and the logged norms are those of the whole
tensors (``Mesh.global_norms``); clip, AdamW and the renorm run on each
rank's pieces, whose renorm axis is whole; the histograms count the whole
tensors' downsample.  So every rank holds the same replicated parameters,
bit for bit, without another broadcast.

``log_histograms`` gives the step variant that adds every gradient's
``gradhist/<JAX path>`` counts (``obs/grad_hist.py``, ≙ :162-165), which
the Trainer runs only on the step that feeds an eval.  Under
``system.debug_nans`` the step raises ``FloatingPointError`` naming the
first non-finite tensor: the loss and the gradients before the update,
the updated parameters after it (``obs/profiling.check_finite``, one host
sync each).

The step's phases are host spans (``obs/profiling.span``) for a profiler
to record: ``nvit.step.forward`` and ``nvit.step.backward`` once per
micro-batch, ``nvit.step.reduce`` around the exchange (with a group only)
and ``nvit.step.update`` around clip + AdamW + renorm.  The backward's
kernels are launched from autograd's device thread, inside the time of the
main thread's backward span.
"""

from __future__ import annotations

from typing import Callable

import torch

from nvit_tpu_torch.configs import Config
from nvit_tpu_torch.models.losses import topk_accuracy
from nvit_tpu_torch.models.schedules import cosine_lr
from nvit_tpu_torch.models.vit import total_loss
from nvit_tpu_torch.obs.grad_hist import tree_grad_histograms
from nvit_tpu_torch.obs.profiling import check_finite, span
from nvit_tpu_torch.parallel.mesh import DataGroup, Mesh, all_reduce_mean_, all_reduce_sum_, data_mesh, shard_dim
from nvit_tpu_torch.train.optim import fused_adamw_renorm_update, global_norm
from nvit_tpu_torch.train.state import TrainState, compute_dtype_of

Metrics = dict[str, torch.Tensor]

# per-group gradient norms: the JAX tree's group → the ViT parameter prefix
GRAD_NORM_GROUPS = {
    "cross_attention": "cross_attention.",
    "local_patch_embed": "local_patch_embed.",
    "global_patch_embed": "global_patch_embed.",
    "head": "mlp_head.1.",
}


def make_loss_fn(cfg: Config):
    """(model, images, labels, step=0) → (loss, (terms, SOM info)); the SOM
    info holds the BMU indices and the Hebbian deltas at ``step``."""
    dt = compute_dtype_of(cfg)

    def loss_fn(model, images: torch.Tensor, labels: torch.Tensor, step: int = 0):
        logits, aux, som_info = model.forward_train(
            images, step=step, compute_dtype=dt, remat=cfg.system.remat,
            remat_skip=cfg.system.remat_skip_blocks)
        loss, terms = total_loss(cfg.model, cfg.training.consistency_weight,
                                 cfg.training.smoothness_weight, logits, labels, aux)
        return loss, (terms, som_info)

    return loss_fn


# the maps the Hebbian deltas go to: SOM info key → the map's nodes parameter
HEBBIAN_DELTAS = {"local_delta": "local_kohonen.nodes", "global_delta": "global_kohonen.nodes"}
# replicated vectors each model rank reads at its heads' / u|v rows' slice
_READ_BY_SLICE = (".sqk", ".suv")


def reduce_gradients_(mesh: Mesh, grads: dict[str, torch.Tensor], terms: dict[str, torch.Tensor],
                      deltas: dict[str, torch.Tensor]) -> None:
    """The step's reductions across ranks, in place (see the module docstring)."""
    if mesh.model.world > 1:
        all_reduce_sum_(mesh.model, [g for n, g in grads.items()
                                     if n.startswith("transformer.h.") and n.endswith(_READ_BY_SLICE)])
    if mesh.data.world > 1:
        pieces = [n for n in grads if mesh.fsdp and shard_dim(n) is not None]
        for n in pieces:  # the reduce-scatter's sums
            grads[n].div_(mesh.data.world)
        all_reduce_mean_(mesh.data, [*(g for n, g in grads.items() if n not in pieces), *terms.values()])
        all_reduce_sum_(mesh.data, deltas.values())


def make_train_step(
    cfg: Config, log_norms: bool | None = None, log_histograms: bool = False,
    group: DataGroup | Mesh | None = None,
) -> Callable[[TrainState, torch.Tensor, torch.Tensor], tuple[TrainState, Metrics]]:
    """(state, images, labels) → (state, metrics); the state is updated in place.

    ``images``: [B, C, H, W] fp32 (normalized); ``labels``: [B] int — with
    ``group``, this data rank's rows of the global batch; with a sharded
    ``Mesh``, the state holds this rank's shards (``train.state.shard_state_``).  With
    gradient_accumulation_steps = k, B must divide by k.  ``log_norms``
    overrides ``cfg.system.log_gpu_stats`` for the grad/param norm metrics;
    ``log_histograms`` adds the gradients' ``gradhist/*`` int32[64] counts.
    ``system.remat`` recomputes the blocks' activations in the backward
    (``models/vit.py``)."""
    accum = max(1, cfg.training.gradient_accumulation_steps)
    want_norms = cfg.system.log_gpu_stats if log_norms is None else log_norms
    loss_fn = make_loss_fn(cfg)
    mesh = data_mesh(group) if isinstance(group, DataGroup) else group
    sharded = mesh is not None and mesh.sharded

    def norms(groups) -> list[torch.Tensor]:
        """The whole tensors' norm of each group of (name, tensor)."""
        if sharded:
            return mesh.global_norms(groups)
        return [global_norm(t for _, t in named) for named in groups]

    def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by gradient_accumulation_steps={accum}")
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        micro = b // accum
        terms = deltas = None
        for i in range(accum):
            sl = slice(i * micro, (i + 1) * micro)
            with span("nvit.step.forward"):
                loss, (t, som_info) = loss_fn(state.model, images[sl], labels[sl], state.step)
            with span("nvit.step.backward"):
                loss.backward()
            t = {k: v.detach() for k, v in t.items()}
            terms = t if terms is None else {k: terms[k] + t[k] for k in terms}
            d = {k: som_info[k] for k in HEBBIAN_DELTAS if k in som_info}
            deltas = d if deltas is None else {k: deltas[k] + d[k] for k in deltas}
        # a parameter outside the loss (the reconstruction head) has a zero
        # gradient, as in JAX; accumulated sums are divided by the count
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in params.items()}
        if accum > 1:
            grads = {n: g / accum for n, g in grads.items()}
            terms = {k: v / accum for k, v in terms.items()}
        if mesh is not None:
            with span("nvit.step.reduce"):
                reduce_gradients_(mesh, grads, terms, deltas)

        if cfg.system.debug_nans:
            check_finite([("the loss", terms["total_loss"]), *((f"the gradient of {n}", g)
                                                                for n, g in grads.items())])
        with span("nvit.step.update"):
            state.opt_state = fused_adamw_renorm_update(
                cfg.optimizer, params, grads, state.opt_state, renorm=cfg.model.use_nvit,
                grad_norm=norms([grads.items()])[0] if sharded and cfg.optimizer.grad_clip else None,
                layout=mesh if sharded else None)
        with torch.no_grad():
            for key, delta in deltas.items():
                nodes = params[HEBBIAN_DELTAS[key]]
                nodes.copy_(nodes + delta.to(nodes.dtype))
        if cfg.system.debug_nans:
            check_finite((f"the updated {n}", p) for n, p in params.items())
        metrics: Metrics = dict(terms)
        metrics["learning_rate"] = cosine_lr(cfg.optimizer, state.step)
        if log_histograms:
            metrics.update(tree_grad_histograms(grads, cfg.model.local_patch_size,
                                                layout=mesh if sharded else None))
        if want_norms:
            with torch.no_grad():
                groups = {"grad_norm": grads.items(), "param_norm": params.items()}
                for i in range(cfg.model.n_layer):
                    prefix = f"transformer.h.{i}."
                    groups[f"blocks.{i}_grad_norm"] = [(n, g) for n, g in grads.items() if n.startswith(prefix)]
                for part, prefix in GRAD_NORM_GROUPS.items():
                    groups[f"{part}_grad_norm"] = [(n, g) for n, g in grads.items() if n.startswith(prefix)]
                metrics.update(zip(groups, norms(list(groups.values()))))
        for p in params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: Config) -> Callable[[torch.nn.Module, torch.Tensor, torch.Tensor], Metrics]:
    """(model, images, labels) → per-batch metrics: the weighted loss, its
    terms (the Kohonen ones included), top-1 and top-5 accuracy
    (≙ step.py:make_eval_step, at step 0 and without the Hebbian deltas)."""
    dt = compute_dtype_of(cfg)

    @torch.no_grad()
    def eval_step(model, images: torch.Tensor, labels: torch.Tensor) -> Metrics:
        logits, aux, _ = model.forward_train(images, hebbian=False, compute_dtype=dt)
        loss, terms = total_loss(cfg.model, cfg.training.consistency_weight,
                                 cfg.training.smoothness_weight, logits, labels, aux)
        top1, top5 = topk_accuracy(logits, labels)
        return {**terms, "loss": loss, "top1_accuracy": top1, "top5_accuracy": top5}

    return eval_step
