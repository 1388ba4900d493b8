#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nvit_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and nvcc::

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. device   — card name and power limit, torch/CUDA versions; requires
               compute capability 9.0; TF32 off for matmuls and cuDNN;
2. build    — compiles the seven kernel sources from nvit_tpu_torch/csrc/,
               one nvcc per source, all started together, and prints ptxas's
               registers, shared memory and spills of the wgmma kernels —
               the attention kernels (K1/K2/K5, K7/K8/K9 and K10, on the
               tile loops of attn_fwd.cuh and attn_bwd.cuh), their projection
               prologues and the gated-MLP GEMMs (K3/K4/K6, on the main loop
               of gated_gemm.cuh) — which must not spill;
3. kernels  — K1/K2 (QK-norm flash attention fwd/bwd, on contiguous and
               strided QKV inputs; K2 and K5's backward bit-equal across two
               calls), their projection prologue, K3/K4 (gated MLP
               fwd/bwd; with K6, bit-equal across two calls), K5 (the bounded arm of K1/K2, with the clamp inert
               and firing in whole rows; "auto" on both sides of its gate),
               K6 (K3/K4 with a bias), K7 (flash attention fwd), K8 and K9
               (its fused and split backward, one source; below one tile too;
               bit-equal across two calls; their prologue against its twin)
               against their plain PyTorch twins at the main paths' shapes
               and at ragged ones, and
               the autograd Functions' CUDA gradients against autograd through
               the twins; K10 (the q-sub-tiled QK-norm backward) against its
               twin at the bench's shape, nsplit 2 and 7, and a ragged one,
               and bit-deterministic; the prologue against its twin (one bf16
               rounding of q̂_s, k̂, k̂_s; lse exact; Δ to fp32 order);
4. bench    — ``python -m nvit_tpu_torch.scripts.attn_bwd_split_bench``'s
               main() on the card (its 3e-2 asserts against K5's backward
               are not caught): K10's counter must rise by exactly the
               bench's K10 calls and K2's and K5's only by its integrated
               calls;
5. times    — K10 at nsplit 2 and 7 against K2 and K5's backward in turns,
               its twin, the unfused chain and SDPA's backward; K10's and
               K2's device time by kernel (torch.profiler);
then for each full path — nViT-B/16 (``use_nvit=True``), the baseline
ViT-B/16 (``flagship_config(use_nvit=False)``) and path A, nViT-B/16 as
settings.yaml runs it (``flagship_config(bias=True)``), random weights and
biases from a seed:
6. serve    — behind InferenceService + make_handler on a local
               ThreadingHTTPServer: /predict at batches 1, 4 and 32, /healthz,
               /stats; the path's attention forward (K1 and its prologue, or
               K7) and gated MLP (K3, or K6 with a bias) must launch 13 times
               per forward and no other kernel; served probabilities against the same weights
               on the plain path (flash_attn=False, gated MLP off);
7. times    — each of the path's kernels against its twin, the unfused chain
               and (attention) PyTorch's fused SDPA, by CUDA events (K9 at
               T = 1100, where the JAX package takes it; path A times K5 and
               K6; beside each gated kernel cuBLAS's bare [n, 2H] GEMM, a
               yardstick, and once K3/K4 at nViT-L's c_fc width against their
               unfused chains, the gated_mlp_kernel="auto" crossover); forward latency at batch 1 and 32 and img/s on the kernel
               and plain paths;
8. train    — training at batch 32, bf16: one make_train_step step launches
               the path's four kernels (K1–K4, K7/K8/K3/K4, or K1/K2/K6) 13
               times each (nViT's prologue 26 times, the baseline's 13) and
               no other; loss
               and per-group gradients (biases and suv included) against the
               plain path on the same weights and batch; ten steps on one batch lower the loss; step time,
               img/s, MFU and peak memory on both paths; Trainer.train() on
               synthetic 224 px data (made once and reused by every path)
               writes metrics.jsonl;
then, at full width with bias=True, the baseline ViT-B/16, path B (nViT-B/16
with ``bounded_softmax="bounded"``) and "auto" below its gate (sqk_eff = 1,
bound 8) and above it (sqk × 2, bound 32):
9. check    — one batch-32 forward through Predictor and one training step,
               each launching the path's kernels 13 times and no other;
               logits, loss and per-group gradients against the plain path;
               in "auto", the logits bit-equal to the static arm the gate
               picks and unequal to the other arm's;
then the run's lifecycle at nViT-B/16 full width:
10. lifecycle — Trainer.train() on 6 iterations against 3 and a relaunch with
               init_from=resume: every leaf of the final checkpoint_latest
               bit-equal, iter_num and meta["trainer"] carried across, each
               resumed step launching K1–K4 13 times and the prologue 26
               (counts set to 0 before the resumed launch, read after); the
               checkpoint's size, restore and save times (host copy, file
               write); ``python -m nvit_tpu_torch`` stopped by SIGTERM after
               its first logged step (exit 0, checkpoint_latest saved),
               relaunched with init_from=resume, then run eval-only on its
               checkpoint_best; ``python -m nvit_tpu_torch.ckpt.export`` (bf16)
               and ``python -m nvit_tpu_torch.serve --export --warm-buckets``:
               /predict at batches 1 and 32 against Predictor.from_checkpoint
               on the fp32 checkpoint, SIGHUP → "reloaded", SIGTERM →
               "drained; exiting" and exit 0.  The files live in a temporary
               directory, removed at the end;
then the data path:
11. data    — a CIFAR-100 python-format tree (50,000 + 10,000 class-structured
               images from a seed) and ``python -m nvit_tpu_torch`` with
               profiles/nvit1_k0.env, nvit0_k0.env and nvit1_k1.env (the
               packaged default's model: the Kohonen SOM, 2 × 16 nodes) on
               the packaged settings.yaml (batch 512, 32 px, 2 layers,
               d = 64, bias, AutoAugment, remat, num_workers 4, prefetch 2;
               only the directories, max_iters 60, eval_interval 30,
               eval_iters 2 and log_interval 10 set): exit 0, the logged
               steps, the loss falling, ``finished`` = max_iters:60, the
               Kohonen validation terms finite; path A (``flagship_config(bias=True)``) under
               remat against no remat on the same weights and batch: loss and
               every gradient bit-equal, step ms and peak memory, the launches
               per step (the QK-norm and gated forwards once more per
               rematted site, also with ``remat_skip_blocks=2``); AutoAugment's
               ms at [32, 3, 224, 224] (ImageNet policy) and [512, 3, 32, 32]
               (CIFAR), bit-equal for the same (run key, step);
               Trainer.train() with remat and AutoAugment through
               make_epoch_iterator and device_prefetch (the loop's wait for a
               batch); an ImageNet-layout folder of JPEGs decoded (the loader's
               route, ms per batch) and trained on through iterate_folder;
then this slice's path:
12. kohonen — the Kohonen flagship, ``flagship_config(use_kohonen=True,
               kohonen_nodes=512)`` (nViT-B/16 with two 256-node maps on a
               16×16 torus, Hebbian "reference"): served as in phase 6 with
               K1, K3 and the prologue 15 times a forward (12 blocks + the
               shared cross-attention three times) and no other kernel; at
               batch 32 the BMU indices and Hebbian deltas bit-equal on the
               kernel and plain paths; the SOM work of one map (BMU search,
               its backward, the Hebbian delta) by CUDA events beside its
               bound; trained as in phase 8 — K1–K4 15 times a step and the
               prologue 30, the loss and the gradients (both maps' nodes and
               the reconstruction head among them) against the plain path,
               ten steps lowering the loss, step ms, img/s, MFU, peak
               memory, Trainer.train().
13. settings — the trainer's single-card settings at nViT-B/16 (batch 32,
               bf16, synthetic data): the bf16-moment SR store of one leaf
               of each layout class, both dithers, bit-equal on the card and
               the CPU; ten steps with fp32, bf16 "hash" and bf16 "threefry"
               moments from the same weights (final loss within 1% of
               fp32's; step ms, peak memory, device launches a step by
               torch.profiler; K1–K4 13 a step, the prologue 26, and no
               other kernel); the trace window's cost; a save after 2 bf16
               steps and a resume bit-equal in all 459 leaves to 4 straight
               steps; debug_nans raising on a NaN input; Trainer.train()
               with bf16 moments, gradient histograms (152 gradhist/* keys
               at the eval, each summing to its downsampled size),
               profile_steps=2 (a trace holding K1–K4's and the prologue's
               kernels) and wandb offline through a recording stand-in
               module (its log calls and histograms, checkpoint_best's
               artifact of two files, init_from="wandb" from it); the
               reference .pt through ``python -m
               nvit_tpu_torch.ckpt.torch_interop`` export then import
               (params and moments bit-equal, the .pt's model strict-loaded
               without its 24 rmsnorm keys giving the checkpoint's logits).
14. serving modes — nViT-B/16 as a training checkpoint (random weights):
               int8 w8a8 (``Predictor(quantize="int8")``) over HTTP at batches
               1, 4 and 32, K1 and the prologue 13 times a forward and K3
               never (the int8 gated projection is unfused), against bf16
               serving (mean |Δp| < 0.02, logits relative L2 < 0.08, the JAX
               package's bounds); the batch-32 forward int8 against bf16 (CUDA
               events, host clock, device time by group); the int8 export
               (MB, seconds) and ``from_export`` bit-equal to the in-memory
               quantization; AOT artifacts (``ckpt/aot.py``) pinned at 32,
               bf16 (K1, the prologue, K3 13 times a forward) and int8 (K1,
               the prologue), and one symbolic (the plain path, batches 1, 4,
               32; no kernel), each within rtol 1e-4 / atol 1e-6 of
               Predictor, with export and load seconds, size and forward ms;
               ``python -m nvit_tpu_torch.serve --aot`` answering one request
               and draining; ``serve_bench`` at 8 clients × 4 requests, the
               batch window off and on, bf16 and int8; ``debug_model()`` on
               the packaged settings (its kernels once a pass, two PNGs).

15. data parallel — nViT-B/16 (flagship_config(), global batch 32, bf16):
               two ranks in two processes on the one card (``chip_smoke.py
               --dp-worker``; NCCL refuses two ranks on one card, so gloo,
               which stages each CUDA tensor through the host), each
               forming its group and taking its 16 rows through ``Trainer``
               and ``make_train_step``: the loss and per-group gradients of
               the global batch against one process's (phase 8's bounds),
               one step launching K1–K4 13 times and the prologue 26 and no
               other kernel, the parameters bit-equal across ranks after 3
               steps, the step's ms and the gradient buffer's all-reduce's ms
               (gloo through the host, not NVLink); ``python -m
               torch.distributed.run --nproc_per_node=1 -m nvit_tpu_torch``
               (one rank, NCCL) on synthetic 224 px data with path A's model:
               exit 0, ``finished``, its profile_steps trace holding K1, K2
               and K6, and the one-rank NCCL all-reduce's ms of the gradient
               buffer; ``Predictor(data_parallel=True, devices=[cuda:0,
               cuda:0])`` served as in phase 6 at batches 1, 4 and 32 (K1, K3
               and the prologue 13 times a replica-forward) against the one
               replica's forward.
16. tensor parallel and FSDP — path A (flagship_config(bias=True), biases
               random, global batch 32, bf16): two ranks on the one card over
               gloo (``chip_smoke.py --tp-worker``), data 1 × model 2 through
               ``Trainer`` (``system.model_parallel=2``): each rank's
               parameters and moments (``memory_allocated``) against one
               card's, the global batch's loss and per-group gradients
               (gathered from the shards) against one card's (phase 8's
               bounds), one step launching K1, K2, K6 and its backward 13
               times and the prologue 26 — K1 at 12 heads once and 6 heads
               12 times, K6 at H = 768 once and 1536 12 times — and no other
               kernel, the replicated parameters bit-equal across the ranks
               after each of 3 steps, the steps' ms (gloo through the host,
               not NVLink); gloo's all-gather and reduce-scatter on CUDA
               tensors probed, and if they run, data 2 × model 1 with
               ``system.fsdp``: half of each trunk matrix and its moments a
               rank, 3 steps against the unsharded two-rank step (relative
               L2 ≤ 1e-5), the renorm's norms 1 within 1e-5;
               ``Predictor(model_parallel=2, devices=[cuda:0, cuda:0])`` at
               batch 32 against one card, and served as in phase 6 (K1, K6
               and the prologue 25 times a forward: the cross-attention
               once, each block once a shard).

K9 is not on any main path (T = 784 ≤ 1024 takes K8), nor is K10 (only the
bench runs it), so their launch counts in the summary are 0 per training
step; the kernels phase checks both, the bench phase runs K10 (its count
there is the summary's ``bench_launches``) and the times phases time both.
The line before the last is a JSON summary of the kernels (``launches``
from the last full path that runs each, the Kohonen flagship's for K1–K4
and the prologue; ``path_launches`` per full path, per step of phase 13's
bf16-moment step, and per forward of phase 14's modes — ``int8``,
``aot-32``, ``aot-32-int8``, ``aot-symbolic`` — and the debug CLI's
forward, per step of a rank of phase 15's two, ``data-parallel-step``, and
per replica-forward of its two replicas, ``data-parallel-forward``, per
step of a model rank of phase 16's two, ``tensor-parallel-step``, and per
forward of its two model shards, ``tensor-parallel-forward``;
``profile_launches`` per profile); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import os
import queue
import signal
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# bf16 outputs: kernel and twin round q̂/k̂/P/O (K1) and the output (K3) to
# bf16 at the same points but sum in another order, and K1's online softmax
# rounds P against a running max — one bf16 ulp (2^-8 relative) either way
KERNEL_TOL = dict(rtol=2e-2, atol=2e-2)
# lse is fp32 from the same bf16 q̂/k̂: summation order only
LSE_TOL = dict(rtol=1e-4, atol=1e-4)
# served (kernel path) vs plain path, 12 bf16 layers: the two paths round at
# different points (K1 keeps x/‖x‖ in fp32 where the plain path rounds it to
# bf16; K3 gates in fp32 where the plain path gates in bf16).  Bound on the
# logits, relative to their spread; probabilities follow exp of the logits
LOGIT_TOL = 0.05
PROB_RTOL = 0.05
# K2's fp32 dsqk sums T·D products per (b, h): bound on max|Δ| relative to
# max|dsqk_ref|
DSQK_RTOL = 2e-2
# K10 vs its twin, relative L2 of dq/dk/dv: the two share every bf16
# rounding point (q̂_s, k̂, k̂_s, P, dS), which leaves well under 1e-4; one
# point moved to fp32 puts 2.5e-3 or more into some output
K10_REL_L2 = 1e-3
# kernel path vs plain path in training, same weights and batch, 12 bf16
# layers: loss within 1%, each parameter group's gradient within 5e-2
# relative L2 (the paths round at different points, as in serving)
TRAIN_LOSS_RTOL = 0.01
GRAD_REL_L2 = 5e-2
# FSDP against the unsharded two-rank step after three bf16 steps: the same
# products on the same gathered weights; only the clip's norm is summed in
# another order (relative L2 of all parameters)
FSDP_REL_L2 = 1e-5
# |‖w‖ − 1| of the renormed trunk matrices, in fp32
RENORM_TOL = 1e-5

# NVIDIA's data sheet, H100 SXM: HBM3 rate (the dense bf16 peak is the
# trainer's, train.trainer.device_peak_flops)
PEAK_BYTES_PER_S = 3.35e12
# the Trainer's logged peak device memory against one kernel-path step's:
# the eval and the log_norms step allocate little beyond the step
TRAINER_PEAK_MARGIN = 1.05
# device memory a train phase may find allocated at its start (0.094 GiB on
# an H100 before the first): far below any path's state of params and moments
PHASE_START_GIB = 0.5

KERNELS = {  # summary name → (source, TPU kernel it replaces)
    "qknorm_attn_fwd": ("nvit_tpu_torch/csrc/qknorm_attn_fwd.cu", "nvit_tpu/ops/flash_attention.py:389"),
    "qknorm_attn_bwd": ("nvit_tpu_torch/csrc/qknorm_attn_bwd.cu", "nvit_tpu/ops/flash_attention.py:558"),
    "gated_mlp_fwd": ("nvit_tpu_torch/csrc/gated_mlp_fwd.cu", "nvit_tpu/ops/gated_mlp.py:96"),
    "gated_mlp_bwd": ("nvit_tpu_torch/csrc/gated_mlp_bwd.cu", "nvit_tpu/ops/gated_mlp.py:104"),
    "flash_attn_fwd": ("nvit_tpu_torch/csrc/flash_attn_fwd.cu", "nvit_tpu/ops/flash_attention.py:83"),
    "flash_attn_bwd_fused": ("nvit_tpu_torch/csrc/flash_attn_bwd.cu", "nvit_tpu/ops/flash_attention.py:214"),
    "flash_attn_bwd_split": ("nvit_tpu_torch/csrc/flash_attn_bwd.cu", "nvit_tpu/ops/flash_attention.py:154"),
    "qknorm_attn_fwd_bounded": ("nvit_tpu_torch/csrc/qknorm_attn_fwd.cu", "nvit_tpu/ops/flash_attention.py:429"),
    "qknorm_attn_bwd_bounded": ("nvit_tpu_torch/csrc/qknorm_attn_bwd.cu", "nvit_tpu/ops/flash_attention.py:602"),
    "gated_mlp_fwd_bias": ("nvit_tpu_torch/csrc/gated_mlp_fwd.cu", "nvit_tpu/ops/gated_mlp.py:96"),
    "gated_mlp_bwd_bias": ("nvit_tpu_torch/csrc/gated_mlp_bwd.cu", "nvit_tpu/ops/gated_mlp.py:104"),
    "qknorm_attn_bwd_subtiled": ("nvit_tpu_torch/csrc/qknorm_attn_bwd.cu", "scripts/attn_bwd_split_bench.py:65"),
    # the q/k projection of K1/K2/K5, out of their tile walks: once per call
    "qknorm_project": ("nvit_tpu_torch/csrc/qknorm_project.cu", "nvit_tpu/ops/flash_attention.py:389"),
    # K8/K9's q·scale and k·scale fold (and K8's Δ), out of their tile walks
    "flash_project": ("nvit_tpu_torch/csrc/qknorm_project.cu", "nvit_tpu/ops/flash_attention.py:214"),
}
# the wgmma kernels whose ptxas report the build phase prints and holds to 0
# bytes of spill (mangled-name substrings)
NO_SPILL = ("qknorm_attn_fwd_kernel", "qknorm_attn_bwd_dkv_kernel", "qknorm_attn_bwd_dq_kernel",
            "qknorm_attn_bwd_subtiled_kernel", "qknorm_attn_bwd_subtiled_dq_kernel",
            "qknorm_project_kernel", "flash_attn_fwd_kernel", "flash_attn_bwd_dkv_kernel",
            "flash_attn_bwd_dq_kernel", "flash_project_kernel", "gated_mlp_fwd_kernel",
            "gated_mlp_bwd_kernel")
SOURCES = sorted({Path(src).stem for src, _ in KERNELS.values()})
# the kernels each path's serving forward and training step launch, 13 times
# each (12 blocks + the shared cross-attention) for every time they are
# listed; every other kernel never.  "qknorm_attn_fwd_auto" counts the "auto"
# launches, whose arm the card picks; the projection prologue runs before
# every QK-norm forward and backward, its plain mode before every K8/K9
PATHS = {
    "nvit": {"forward": ("qknorm_attn_fwd", "gated_mlp_fwd", "qknorm_project"),
             "step": ("qknorm_attn_fwd", "qknorm_attn_bwd", "gated_mlp_fwd", "gated_mlp_bwd", "qknorm_project",
                      "qknorm_project")},
    "baseline": {"forward": ("flash_attn_fwd", "gated_mlp_fwd"),
                 "step": ("flash_attn_fwd", "flash_attn_bwd_fused", "gated_mlp_fwd", "gated_mlp_bwd",
                          "flash_project")},
    "nvit-bias": {"forward": ("qknorm_attn_fwd", "gated_mlp_fwd_bias", "qknorm_project"),
                  "step": ("qknorm_attn_fwd", "qknorm_attn_bwd", "gated_mlp_fwd_bias", "gated_mlp_bwd_bias",
                           "qknorm_project", "qknorm_project")},
    "baseline-bias": {"forward": ("flash_attn_fwd", "gated_mlp_fwd_bias"),
                      "step": ("flash_attn_fwd", "flash_attn_bwd_fused", "gated_mlp_fwd_bias",
                               "gated_mlp_bwd_bias", "flash_project")},
    "bounded": {"forward": ("qknorm_attn_fwd_bounded", "gated_mlp_fwd_bias", "qknorm_project"),
                "step": ("qknorm_attn_fwd_bounded", "qknorm_attn_bwd_bounded", "gated_mlp_fwd_bias",
                         "gated_mlp_bwd_bias", "qknorm_project", "qknorm_project")},
    # the Kohonen flagship: nViT's kernels, over 3 cross-attention passes
    "nvit-kohonen": {"forward": ("qknorm_attn_fwd", "gated_mlp_fwd", "qknorm_project"),
                     "step": ("qknorm_attn_fwd", "qknorm_attn_bwd", "gated_mlp_fwd", "gated_mlp_bwd",
                              "qknorm_project", "qknorm_project")},
    # "auto"'s backward is K2's plain recompute (≙ _bwd_qknorm)
    "auto": {"forward": ("qknorm_attn_fwd_auto", "gated_mlp_fwd_bias", "qknorm_project"),
             "step": ("qknorm_attn_fwd_auto", "qknorm_attn_bwd", "gated_mlp_fwd_bias", "gated_mlp_bwd_bias",
                      "qknorm_project", "qknorm_project")},
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, iters: int) -> float:
    """Median host-clock milliseconds of ``fn`` (which ends in a device sync)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def bit_equal(a, b) -> bool:
    return all(torch.equal(as_bytes(x), as_bytes(y)) for x, y in zip(a, b))


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def peak_flops() -> float:
    from nvit_tpu_torch.train.trainer import device_peak_flops

    peak = device_peak_flops(torch.device("cuda"))
    check(peak is not None, f"no dense bf16 peak listed for {torch.cuda.get_device_name(0)}")
    return peak


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak_flops(), nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def launch_counts() -> dict:
    """counter name → (wrapper, attribute holding its launch count)"""
    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_fwd

    return {"qknorm_attn_fwd": (fa.qknorm_attention_fwd, "launches"),
            "qknorm_attn_fwd_bounded": (fa.qknorm_attention_fwd, "launches_bounded"),
            "qknorm_attn_fwd_auto": (fa.qknorm_attention_fwd, "launches_auto"),
            "qknorm_attn_bwd": (fa.qknorm_attention_bwd, "launches"),
            "qknorm_attn_bwd_bounded": (fa.qknorm_attention_bwd, "launches_bounded"),
            "gated_mlp_fwd": (gated_mlp_fwd, "launches"), "gated_mlp_fwd_bias": (gated_mlp_fwd, "launches_bias"),
            "gated_mlp_bwd": (gated_mlp_bwd_duv, "launches"),
            "gated_mlp_bwd_bias": (gated_mlp_bwd_duv, "launches_bias"),
            "flash_attn_fwd": (fa.flash_attention_fwd, "launches"),
            "flash_attn_bwd_fused": (fa.attention_bwd_fused, "launches"),
            "flash_attn_bwd_split": (fa.attention_bwd_split, "launches"),
            "qknorm_attn_bwd_subtiled": (fa.qknorm_attention_bwd_subtiled, "launches"),
            "qknorm_project": (fa.qknorm_project_bf16, "launches"),
            "flash_project": (fa.flash_project_bf16, "launches")}


def n_passes(m) -> int:
    """Passes of the attention and gated-MLP kernels per forward: every
    block, and the shared cross-attention once, or three times with the
    Kohonen SOM (its BMU representations fused with each stream, then the
    two results)."""
    return m.n_layer + (3 if m.use_kohonen else 1)


def per_pass(names, n: int) -> dict:
    """kernel → n launches for every time ``names`` lists it"""
    return {name: n * count for name, count in Counter(names).items()}


def check_launches(launches: dict, expected: dict, what: str) -> None:
    """Every kernel launched exactly as ``expected`` says, others never."""
    for name, count in launches.items():
        want = expected.get(name, 0)
        check(count == want, f"{what}: {name} launched {count} times, expected {want}")


def reset_counts() -> None:
    for fn, attr in launch_counts().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counts().items()}


# -------------------------------------------------------------------- phases
def device_phase() -> str:
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {torch.cuda.get_device_name(0)}, capability {cap}, count {torch.cuda.device_count()}")
    check(cap == (9, 0), f"the kernels are built for sm_90a; this card is {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # fp32 split-K reductions in the bf16 cuBLAS GEMMs, as the Trainer sets
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return smi


def build_phase() -> None:
    from nvit_tpu_torch.ops._build import build, load_library, ptxas_report

    phase("build")

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        for name, seconds in pool.map(timed, SOURCES):
            print(f"built {name} in {seconds:.3f} s")
    seen = set()
    for name in SOURCES:
        load_library(name)
        for kernel, use in ptxas_report(name).items():
            keys = [key for key in NO_SPILL if key in kernel]
            if keys:
                seen.update(keys)
                print(f"ptxas {name}: {kernel}: {use}")
                check(use.get("spill_stores", 1) == 0 and use.get("spill_loads", 1) == 0,
                      f"{kernel} spills: {use}")
    check(seen == set(NO_SPILL), f"no ptxas report for {set(NO_SPILL) - seen}")


def attn_inputs(b, h, t, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    sqk = 1.0 + 0.1 * torch.randn(h, d, generator=g, device="cuda")
    return q, k, v, sqk


def qkv_view_inputs(b, h, t, d, seed):
    """q, k, v as strided [B, H, T, D] views of one fused [B, T, 3·H·D]
    projection, as a Block makes them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d).permute(0, 2, 1, 3) for x in qkv.chunk(3, dim=-1))
    sqk = 1.0 + 0.1 * torch.randn(h, d, generator=g, device="cuda")
    do = torch.randn(b, t, h, d, generator=g, device="cuda").to(torch.bfloat16).permute(0, 2, 1, 3)
    return q, k, v, sqk, do


def mlp_inputs(n, k, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(2 * h, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
    return x, w


def mlp_grad(n, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n, h, generator=g, device="cuda").to(torch.bfloat16)


def kernel_phase() -> dict:
    from nvit_tpu_torch.ops.flash_attention import (
        flash_attention_qknorm,
        flash_attention_qknorm_ref,
        qknorm_attention_bwd,
        qknorm_attention_bwd_ref,
        qknorm_attention_fwd,
    )
    from nvit_tpu_torch.ops.gated_mlp import (
        gated_mlp,
        gated_mlp_bwd_duv,
        gated_mlp_duv_ref,
        gated_mlp_fwd,
        gated_mlp_ref,
    )

    phase("kernels vs plain twins")
    print(f"tolerance: bf16 outputs {KERNEL_TOL}, lse {LSE_TOL}, fp32 dsqk max|Δ| <= "
          f"{DSQK_RTOL} x max|dsqk_ref|")
    errs = {name: 0.0 for name in KERNELS}
    prof, _ = profile_shapes()  # the profiles' step (batch 512, 32 px): blocks and cross-attention
    for (b, h, t, d), view in (((4, 12, 784, 64), False), ((2, 4, 100, 32), False), (prof, False),
                               ((4, 12, 784, 64), True), ((2, 4, 100, 32), True), (prof, True)):
        q, k, v, sqk = qkv_view_inputs(b, h, t, d, seed=t + 5)[:4] if view else attn_inputs(b, h, t, d, seed=t)
        scale = float(d) ** 0.5
        o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
        o_ref, lse_ref = flash_attention_qknorm_ref(q, k, v, sqk, scale)
        torch.cuda.synchronize()
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        print(f"K1 [B={b}, H={h}, T={t}, D={d}]{' strided QKV views' if view else ''} scale {scale:g}: "
              f"max|o-o_ref| {eo:.3e}, max|lse-lse_ref| {el:.3e}")
        torch.testing.assert_close(o.float(), o_ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        errs["qknorm_attn_fwd"] = max(errs["qknorm_attn_fwd"], eo)

    for b, h, t, d in ((4, 12, 784, 64), (2, 4, 100, 32), prof):  # strided QKV views, ragged T
        q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=t + 1)
        scale = float(d) ** 0.5
        o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
        got = qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do)
        want = qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do)
        # no atomics: two calls give the same bytes, K2's and K5's backward alike
        same = bit_equal(got, qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do))
        o_b, lse_b = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
        same_b = bit_equal(*(qknorm_attention_bwd(q, k, v, sqk, scale, o_b, lse_b, do, "bounded")
                             for _ in range(2)))
        torch.cuda.synchronize()
        print(f"K2 / K5 backward [B={b}, H={h}, T={t}, D={d}]: two calls bit-equal: {same} / {same_b}")
        check(same and same_b, "K2 / K5 backward: two calls on the same inputs differ")
        e = [max_err(a, r) for a, r in zip(got, want)]
        dsqk_bound = DSQK_RTOL * want[3].abs().max().item()
        print(f"K2 [B={b}, H={h}, T={t}, D={d}]: max|Δ| dq {e[0]:.3e} dk {e[1]:.3e} dv {e[2]:.3e}, "
              f"dsqk {e[3]:.3e} (bound {dsqk_bound:.3e})")
        for a, r in zip(got[:3], want[:3]):
            torch.testing.assert_close(a.float(), r.float(), **KERNEL_TOL)
        check(e[3] <= dsqk_bound, f"K2 dsqk max|Δ| {e[3]:.3e} exceeds {dsqk_bound:.3e}")
        errs["qknorm_attn_bwd"] = max(errs["qknorm_attn_bwd"], *e[:3])

    for n, k, h, what in ((4 * 784, 768, 3072, "c_fc"), (4 * 784, 768, 768, "proj"),
                          (784 + 17, 768, 768, "ragged")):
        x, w = mlp_inputs(n, k, h, seed=n + h)
        g = mlp_grad(n, h, seed=n + h + 1)
        out, ref = gated_mlp_fwd(x, w), gated_mlp_ref(x, w)
        duv, duv_ref = gated_mlp_bwd_duv(x, w, g), gated_mlp_duv_ref(x, w, g)
        torch.cuda.synchronize()
        e3, e4 = max_err(out, ref), max_err(duv, duv_ref)
        print(f"K3 {what} [n={n}, K={k}, H={h}]: max|out-ref| {e3:.3e}; K4: max|duv-duv_ref| {e4:.3e}")
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(duv.float(), duv_ref.float(), **KERNEL_TOL)
        errs["gated_mlp_fwd"] = max(errs["gated_mlp_fwd"], e3)
        errs["gated_mlp_bwd"] = max(errs["gated_mlp_bwd"], e4)
    # no split-K and no atomics: two calls give the same bytes, K3/K4 and K6 alike
    x, w = mlp_inputs(2 * 784, 768, 3072, seed=10)
    g, bias = mlp_grad(2 * 784, 3072, seed=11), bias_inputs(3072, seed=12)
    calls = {"K3": lambda: gated_mlp_fwd(x, w), "K4": lambda: gated_mlp_bwd_duv(x, w, g),
             "K6": lambda: gated_mlp_fwd(x, w, bias), "K6 backward": lambda: gated_mlp_bwd_duv(x, w, g, bias)}
    same = {name: bit_equal([fn()], [fn()]) for name, fn in calls.items()}
    torch.cuda.synchronize()
    print(f"K3 / K4 / K6 / K6 backward [n={2 * 784}, K=768, H=3072]: two calls bit-equal: "
          f"{' / '.join(str(v) for v in same.values())}")
    check(all(same.values()), f"gated MLP kernels: two calls on the same inputs differ: {same}")

    # the autograd Functions: a CUDA forward carries gradients (K2, K4), and
    # they agree with autograd through the plain twins on the same tensors
    q, k, v, sqk, do = qkv_view_inputs(2, 12, 784, 64, seed=7)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    flash_attention_qknorm(*leaves, 8.0).backward(do)
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    flash_attention_qknorm_ref(*ref, 8.0)[0].backward(do)
    rel = [rel_l2(a.grad, r.grad) for a, r in zip(leaves, ref)]
    print("FlashQKNormFn on CUDA vs autograd through the twin: rel L2 dq {:.3e} dk {:.3e} dv {:.3e} "
          "dsqk {:.3e}".format(*rel))
    check(all(x.grad is not None for x in leaves), "FlashQKNormFn: a CUDA forward lost its gradient")
    check(max(rel) <= GRAD_REL_L2, f"FlashQKNormFn gradients disagree with the twin's: {rel}")
    x, w = (t.detach().clone().requires_grad_() for t in mlp_inputs(2 * 784, 768, 3072, seed=8))
    g = mlp_grad(2 * 784, 3072, seed=9)
    gated_mlp(x.reshape(2, 784, 768), w).backward(g.reshape(2, 784, 3072))
    xr, wr = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
    gated_mlp_ref(xr, wr).backward(g)
    rel = [rel_l2(x.grad, xr.grad), rel_l2(w.grad, wr.grad)]
    print("GatedMLPFn on CUDA vs autograd through the twin: rel L2 dx {:.3e} dW {:.3e}".format(*rel))
    check(x.grad is not None and w.grad is not None, "GatedMLPFn: a CUDA forward lost its gradient")
    check(max(rel) <= GRAD_REL_L2, f"GatedMLPFn gradients disagree with the twin's: {rel}")
    baseline_kernel_checks(errs)
    bias_bounded_kernel_checks(errs)
    subtiled_kernel_checks(errs)
    project_kernel_checks(errs)
    return errs


def project_kernel_checks(errs: dict) -> None:
    """The projection prologue against its twin at the batch-32 shape and a
    ragged one (strided QKV views): q̂_s, k̂, k̂_s within one bf16 rounding
    (both round the same fp32 product once; the fp32 norms' sums run in
    another order), the padded lse copied exactly, Δ to fp32 order."""
    from nvit_tpu_torch.ops import flash_attention as fa

    for b, h, t, d in ((32, 12, 784, 64), (2, 4, 100, 32), profile_shapes()[0]):
        q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=t + 30)
        scale = float(d) ** 0.5
        o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
        kw = dict(o=o, do=do, lse=lse)
        got = fa.qknorm_project_bf16(q, k, sqk, scale, **kw)
        want = fa.qknorm_project_bf16_ref(q, k, sqk, scale, **kw)
        torch.cuda.synchronize()
        parts = []
        for name, a, r in zip(("q̂_s", "k̂", "k̂_s"), got[:3], want[:3]):
            diff = (a.float() - r.float()).abs()
            unequal = (a != r).float().mean().item()
            parts.append(f"{name} max|Δ| {diff.max().item():.3e} ({100 * unequal:.4f}% of values unequal)")
            check(bool((diff <= r.float().abs() * 2.0 ** -7).all()), f"prologue {name}: more than one bf16 rounding")
            errs["qknorm_project"] = max(errs["qknorm_project"], diff.max().item())
        ed = max_err(got[4], want[4])
        print(f"prologue [B={b}, H={h}, T={t}, D={d}]: {', '.join(parts)}; lse copy exact: "
              f"{torch.equal(got[3], want[3])}; max|Δ-Δ_ref| {ed:.3e}")
        check(torch.equal(got[3], want[3]), "prologue: the padded lse differs from the forward's")
        torch.testing.assert_close(got[4], want[4], **LSE_TOL)
        del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()


def baseline_kernel_checks(errs: dict) -> None:
    """K7, K8 and K9 against their twins (q/k/v as views of a fused QKV
    buffer, as a Block makes them), K8 and K9 bit-equal across two calls,
    their prologue against its twin, and FlashAttnFn's CUDA gradients."""
    from nvit_tpu_torch.ops import flash_attention as fa

    # the flagship; ragged T, head dim 32; below one tile (one ragged tile in
    # the ring); the profiles' step
    for b, h, t, d in ((4, 12, 784, 64), (2, 4, 100, 32), (1, 2, 40, 64), profile_shapes()[0]):
        q, k, v, _, do = qkv_view_inputs(b, h, t, d, seed=t + 2)
        scale = 1.0 / float(d) ** 0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, scale)
        got = fa.attention_bwd_fused(q, k, v, o, lse, do, scale)
        want = fa.attention_bwd_fused_ref(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        e = [max_err(a, r) for a, r in zip(got, want)]
        print(f"K7 [B={b}, H={h}, T={t}, D={d}] scale {scale:g}: max|o-o_ref| {eo:.3e}, "
              f"max|lse-lse_ref| {el:.3e}; K8: max|Δ| dq {e[0]:.3e} dk {e[1]:.3e} dv {e[2]:.3e}")
        torch.testing.assert_close(o.float(), o_ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        for a, r in zip(got, want):
            torch.testing.assert_close(a.float(), r.float(), **KERNEL_TOL)
        errs["flash_attn_fwd"] = max(errs.get("flash_attn_fwd", 0.0), eo)
        errs["flash_attn_bwd_fused"] = max(errs.get("flash_attn_bwd_fused", 0.0), *e)
        # no atomics: two calls give the same bytes, K8's and K9's alike
        delta = fa.attention_delta(o, do)
        same = bit_equal(got, fa.attention_bwd_fused(q, k, v, o, lse, do, scale))
        same_split = bit_equal(*(fa.attention_bwd_split(q, k, v, do, lse, delta, scale) for _ in range(2)))
        torch.cuda.synchronize()
        print(f"K8 / K9 [B={b}, H={h}, T={t}, D={d}]: two calls bit-equal: {same} / {same_split}")
        check(same and same_split, "K8 / K9: two calls on the same inputs differ")
        # their prologue: qs, ks bit-equal to the twin's (one rounding of the
        # same product), lse copied exactly, Δ to fp32 order or copied (K9)
        for kw in (dict(o=o, do=do), dict(delta=delta)):
            pro = fa.flash_project_bf16(q, k, scale, lse=lse, **kw)
            pro_ref = fa.flash_project_bf16_ref(q, k, scale, lse=lse, **kw)
            torch.cuda.synchronize()
            exact = [(a is None) == (r is None) and (a is None or bit_equal([a], [r]))
                     for a, r in zip(pro[:3], pro_ref[:3])]
            ed = max_err(pro[3], pro_ref[3])
            print(f"backward prologue ({'K9' if 'delta' in kw else 'K8'}) [B={b}, H={h}, T={t}, D={d}]: "
                  f"qs, ks, lse bit-equal {exact}; max|Δ-Δ_ref| {ed:.3e}")
            check(all(exact), "backward prologue: qs, ks or lse differ from the twin's")
            torch.testing.assert_close(pro[3], pro_ref[3], **LSE_TOL)
            errs["flash_project"] = max(errs["flash_project"], ed)

    # K9 where the JAX package takes it (T_pad > 1024), and ragged at head dim 32
    for b, h, t, d in ((2, 12, 1100, 64), (2, 4, 1100, 32)):
        q, k, v, _, do = qkv_view_inputs(b, h, t, d, seed=t + d)
        scale = 1.0 / float(d) ** 0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
        delta = fa.attention_delta(o, do)
        got = fa.attention_bwd_split(q, k, v, do, lse, delta, scale)
        want = (fa.attention_dq_ref(q, k, v, do, lse, delta, scale),
                *fa.attention_dkv_ref(q, k, v, do, lse, delta, scale))
        torch.cuda.synchronize()
        e = [max_err(a, r) for a, r in zip(got, want)]
        print(f"K9 [B={b}, H={h}, T={t}, D={d}]: max|Δ| dq {e[0]:.3e} dk {e[1]:.3e} dv {e[2]:.3e}")
        for a, r in zip(got, want):
            torch.testing.assert_close(a.float(), r.float(), **KERNEL_TOL)
        errs["flash_attn_bwd_split"] = max(errs.get("flash_attn_bwd_split", 0.0), *e)

    # FlashAttnFn: a CUDA forward carries K8's (T ≤ 1024) or K9's gradients
    for t in (784, 1100):
        q, k, v, _, do = qkv_view_inputs(2, 12, t, 64, seed=t + 5)
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fa.flash_attention(*leaves, 0.125).backward(do)
        ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fa.flash_attention_ref(*ref, 0.125)[0].backward(do)
        check(all(x.grad is not None for x in leaves), "FlashAttnFn: a CUDA forward lost its gradient")
        rel = [rel_l2(a.grad, r.grad) for a, r in zip(leaves, ref)]
        print("FlashAttnFn on CUDA, T={}, vs autograd through the twin: rel L2 dq {:.3e} dk {:.3e} "
              "dv {:.3e}".format(t, *rel))
        check(max(rel) <= GRAD_REL_L2, f"FlashAttnFn gradients disagree with the twin's: {rel}")


def bias_inputs(h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (0.5 * torch.randn(2 * h, generator=g, device="cuda")).to(torch.bfloat16)


def fully_clamped_rows(lse, sqk, scale) -> float:
    """Share of rows whose every exp argument the −60 floor clamps: there
    lse = bound − 60 + log T exactly (uniform attention)."""
    from nvit_tpu_torch.ops.flash_attention import BOUNDED_EXP_FLOOR, head_bounds

    floor = head_bounds(sqk, scale).reshape(1, -1, 1) + BOUNDED_EXP_FLOOR + math.log(lse.shape[-1])
    return (lse <= floor + 1e-3).float().mean().item()


def bias_bounded_kernel_checks(errs: dict) -> None:
    """K5 (mode="bounded") and K6 against their twins at the batch-32 shapes
    and a ragged one; K5 with the clamp inert (sqk_eff ≈ 1) and firing in
    whole rows (sqk_eff ≈ 3); "auto" bit-equal to the arm of its gate; the
    autograd Functions' CUDA gradients in both."""
    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops.gated_mlp import (
        gated_mlp,
        gated_mlp_bwd_duv,
        gated_mlp_duv_ref,
        gated_mlp_fwd,
        gated_mlp_ref,
    )

    for (b, h, t, d), factor in ((shape, f) for shape in ((32, 12, 784, 64), (2, 4, 100, 32))
                                 for f in (1.0, 3.0)):
        q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=t + 9)
        sqk = factor * sqk
        scale = float(d) ** 0.5
        o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
        got = fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do, "bounded")
        o_ref, lse_ref = fa.flash_attention_qknorm_ref(q, k, v, sqk, scale, "bounded")
        want = fa.qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do, "bounded")
        torch.cuda.synchronize()
        clamped = fully_clamped_rows(lse_ref, sqk, scale)
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        e = [max_err(a, r) for a, r in zip(got, want)]
        dsqk_bound = DSQK_RTOL * want[3].abs().max().item()
        print(f"K5 [B={b}, H={h}, T={t}, D={d}] sqk_eff x{factor:g} (max bound "
              f"{fa.head_bounds(sqk, scale).max().item():.1f}, {100 * clamped:.1f}% of rows clamped whole): "
              f"max|o-o_ref| {eo:.3e}, max|lse-lse_ref| {el:.3e}; backward max|Δ| dq {e[0]:.3e} "
              f"dk {e[1]:.3e} dv {e[2]:.3e}, dsqk {e[3]:.3e} (bound {dsqk_bound:.3e})")
        check(all(torch.isfinite(x).all().item() for x in (o, lse, *got)), "K5: non-finite output")
        if (b, factor) == (32, 1.0):
            check(clamped == 0.0, "K5: the clamp fired where it should be inert")
        if (b, factor) == (32, 3.0):
            check(clamped > 0.5, f"K5: the clamp floored only {clamped:.3f} of the rows whole")
        torch.testing.assert_close(o.float(), o_ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        for a, r in zip(got[:3], want[:3]):
            torch.testing.assert_close(a.float(), r.float(), **KERNEL_TOL)
        check(e[3] <= dsqk_bound, f"K5 dsqk max|Δ| {e[3]:.3e} exceeds {dsqk_bound:.3e}")
        errs["qknorm_attn_fwd_bounded"] = max(errs["qknorm_attn_fwd_bounded"], eo)
        errs["qknorm_attn_bwd_bounded"] = max(errs["qknorm_attn_bwd_bounded"], *e[:3])
        del q, k, v, do, o, lse, got, o_ref, lse_ref, want

    # "auto": the card's gate picks the arm (bit-equal output), sqk_eff ≈ 1
    # gives bound ≈ 8·1.3² < 20 (bounded), × 2 gives > 20 (row-max)
    q, k, v, sqk, _ = qkv_view_inputs(32, 12, 784, 64, seed=21)
    for factor, arm, other in ((1.0, "bounded", "rowmax"), (2.0, "rowmax", "bounded")):
        s = factor * sqk
        o, lse = fa.qknorm_attention_fwd(q, k, v, s, 8.0, with_lse=True, mode="auto")
        o_arm, lse_arm = fa.qknorm_attention_fwd(q, k, v, s, 8.0, with_lse=True, mode=arm)
        _, lse_other = fa.qknorm_attention_fwd(q, k, v, s, 8.0, with_lse=True, mode=other)
        gate = 8.0 * (s * s).max().item()
        same, differs = torch.equal(o, o_arm) and torch.equal(lse, lse_arm), not torch.equal(lse, lse_other)
        print(f"auto, sqk_eff x{factor:g} (scale·max(sqk²) = {gate:.2f}, gate 20): output bit-equal to "
              f"the {arm} arm's: {same}; lse unequal to the {other} arm's: {differs}")
        check(same and differs and (gate < fa.BOUND_GATE) == (arm == "bounded"),
              f"auto did not take the {arm} arm at sqk_eff x{factor:g}")
    del q, k, v, o, lse, o_arm, lse_arm, lse_other

    for n, k, h, what in ((32 * 784, 768, 3072, "c_fc"), (32 * 784, 768, 768, "proj"),
                          (784 + 17, 768, 768, "ragged"), *profile_shapes()[1]):
        x, w = mlp_inputs(n, k, h, seed=n + h + 2)
        bias = bias_inputs(h, seed=h + 3)
        g = mlp_grad(n, h, seed=n + h + 4)
        out, ref = gated_mlp_fwd(x, w, bias), gated_mlp_ref(x, w, bias)
        duv, duv_ref = gated_mlp_bwd_duv(x, w, g, bias), gated_mlp_duv_ref(x, w, g, bias)
        torch.cuda.synchronize()
        e6, e6b = max_err(out, ref), max_err(duv, duv_ref)
        print(f"K6 {what} [n={n}, K={k}, H={h}]: max|out-ref| {e6:.3e}; backward max|duv-duv_ref| {e6b:.3e}")
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(duv.float(), duv_ref.float(), **KERNEL_TOL)
        errs["gated_mlp_fwd_bias"] = max(errs["gated_mlp_fwd_bias"], e6)
        errs["gated_mlp_bwd_bias"] = max(errs["gated_mlp_bwd_bias"], e6b)
        del x, w, g, out, ref, duv, duv_ref

    # the autograd Functions with a bias (folded through suv) and bounded
    x, w = mlp_inputs(2 * 784, 768, 3072, seed=23)
    b32 = bias_inputs(3072, seed=24).float() / 5
    suv = 1 + 0.1 * torch.randn(6144, generator=torch.Generator(device="cuda").manual_seed(25), device="cuda")
    g = mlp_grad(2 * 784, 3072, seed=26)
    grads = []
    for fn in (gated_mlp, gated_mlp_ref):
        w_, b_, s_ = (t.float().clone().requires_grad_() for t in (w, b32, suv))
        fn(x, (w_ * s_[:, None]).to(torch.bfloat16), (b_ * s_).to(torch.bfloat16)).backward(g)
        grads.append((w_.grad, b_.grad, s_.grad))
    rel = [rel_l2(a, r) for a, r in zip(*grads)]
    print("GatedMLPFn with a suv-folded bias on CUDA vs autograd through the twin: rel L2 dW {:.3e} "
          "db {:.3e} dsuv {:.3e}".format(*rel))
    check(max(rel) <= GRAD_REL_L2, f"GatedMLPFn (K6) gradients disagree with the twin's: {rel}")
    # against the twins' custom VJP, not autograd through the twin's forward:
    # where the floor clamps a row whole, the true gradient is 0 and the
    # TPU kernels' backward deliberately is not (flash_attention.py:461-477)
    q, k, v, sqk, do = qkv_view_inputs(2, 12, 784, 64, seed=27)
    for factor in (1.0, 3.0):
        s = factor * sqk
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, s)]
        fa.flash_attention_qknorm(*leaves, 8.0, mode="bounded").backward(do)
        o_ref, lse_ref = fa.flash_attention_qknorm_ref(q, k, v, s, 8.0, "bounded")
        *ref, dsqk = fa.qknorm_attention_bwd_ref(q, k, v, s, 8.0, o_ref, lse_ref, do, "bounded")
        rel = [rel_l2(a.grad, r) for a, r in zip(leaves, (*ref, dsqk.sum(dim=0)))]
        print("FlashQKNormFn bounded, sqk_eff x{:g}, on CUDA vs the twins' VJP: rel L2 dq {:.3e} "
              "dk {:.3e} dv {:.3e} dsqk {:.3e}".format(factor, *rel))
        check(all(torch.isfinite(a.grad).all().item() for a in leaves), "FlashQKNormFn (K5): non-finite gradient")
        check(max(rel) <= GRAD_REL_L2, f"FlashQKNormFn (K5) gradients disagree with the twin's: {rel}")


def subtiled_kernel_checks(errs: dict) -> None:
    """K10 against its twin at the bench's shape, nsplit 2 (chunks of 64
    rows) and 7 (112 = 64 + 48), and at a ragged one (112 rows in seven
    16-row sub-tiles), q/k/v as views of a fused QKV buffer; a second call
    on the same inputs gives the same bytes."""
    from nvit_tpu_torch.ops import flash_attention as fa

    for (b, h, t, d), nsplit in (((32, 12, 784, 64), 2), ((32, 12, 784, 64), 7), ((2, 3, 112, 64), 7)):
        q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=t + nsplit)
        o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True)
        got = fa.qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, do, nsplit)
        again = fa.qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, do, nsplit)
        want = fa.qknorm_attention_bwd_subtiled_ref(q, k, v, sqk, 8.0, o, lse, do, nsplit)
        torch.cuda.synchronize()
        e = [max_err(a, r) for a, r in zip(got, want)]
        rel = [rel_l2(a, r) for a, r in zip(got[:3], want[:3])]
        dsqk_bound = DSQK_RTOL * want[3].abs().max().item()
        same = bit_equal(got, again)
        print(f"K10 [B={b}, H={h}, T={t}, D={d}] nsplit {nsplit} (sub-tiles {fa.split_bounds(t, nsplit)}): "
              f"max|Δ| dq {e[0]:.3e} dk {e[1]:.3e} dv {e[2]:.3e}, dsqk {e[3]:.3e} (bound {dsqk_bound:.3e}); "
              "rel L2 dq {:.3e} dk {:.3e} dv {:.3e}; two calls bit-equal: {}".format(*rel, same))
        check(all(torch.isfinite(x).all().item() for x in got), "K10: non-finite output")
        for a, r in zip(got[:3], want[:3]):
            torch.testing.assert_close(a.float(), r.float(), **KERNEL_TOL)
        check(max(rel) <= K10_REL_L2, f"K10 rel L2 {rel} exceeds {K10_REL_L2}: a rounding point differs")
        check(e[3] <= dsqk_bound, f"K10 dsqk max|Δ| {e[3]:.3e} exceeds {dsqk_bound:.3e}")
        check(same, "K10: two calls on the same inputs differ")
        errs["qknorm_attn_bwd_subtiled"] = max(errs["qknorm_attn_bwd_subtiled"], *e[:3])
        del q, k, v, do, o, lse, got, again, want
    torch.cuda.empty_cache()


def bench_phase() -> int:
    """The port of scripts/attn_bwd_split_bench.py on the card, in this
    process; its asserts are not caught.  K10's counter rises by exactly the
    bench's K10 calls, K2's and K5's only by its integrated calls, K5's
    forward once, the projection prologue before each of those and each K10
    call → K10's launches in the bench."""
    from nvit_tpu_torch.scripts import attn_bwd_split_bench as bench

    phase("bench: python -m nvit_tpu_torch.scripts.attn_bwd_split_bench")
    reset_counts()
    result = bench.main(["--device", "cuda"])
    launches = read_counts()
    calls = result["calls"]
    print(f"launches in the bench: {launches}; the bench's calls: {calls}")
    check_launches(launches, {"qknorm_attn_bwd_subtiled": calls["subtiled"], "qknorm_attn_bwd": calls["rowmax"],
                              "qknorm_attn_bwd_bounded": calls["integrated"], "qknorm_attn_fwd_bounded": 1,
                              "qknorm_project": 1 + calls["rowmax"] + calls["integrated"] + calls["subtiled"]},
                   "the bench")
    check(calls["subtiled"] > 0, "the bench launched no K10")
    torch.cuda.empty_cache()
    return launches["qknorm_attn_bwd_subtiled"]


def subtiled_time_phase() -> dict:
    """K10 (nsplit 2 and 7) against K2 and K5's backward in turns, at the
    bench's shape, then its twin, the flash_attn=False chain and SDPA's
    backward on the projected q̂/k̂ (library_ms: a yardstick, used nowhere in
    the port); K10's and K2's device time by kernel (torch.profiler): the
    one-pass walk and the dq̂ sum against K2's two walks.  bound_ms counts
    the function's bytes (K2's); the design's dq̂ partial buffer, written
    once and read once, is counted apart."""
    import torch.nn.functional as F

    from nvit_tpu_torch.obs.profile_step import profile
    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops.attention import attention_qknorm, qknorm_project

    phase("times, K10 (q-sub-tiled backward) against K2 and K5's backward")
    b, h, t, d, scale = 32, 12, 784, 64, 8.0
    q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=13)
    o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    o_b, lse_b = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
    arms = {
        "K2": lambda: fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do),
        "K10 nsplit=2": lambda: fa.qknorm_attention_bwd_subtiled(q, k, v, sqk, scale, o, lse, do, 2),
        "K10 nsplit=7": lambda: fa.qknorm_attention_bwd_subtiled(q, k, v, sqk, scale, o, lse, do, 7),
        "K5 backward": lambda: fa.qknorm_attention_bwd(q, k, v, sqk, scale, o_b, lse_b, do, "bounded"),
    }
    runs = {name: [] for name in arms}
    for name in [*arms, *reversed(arms)]:  # in turns: drift on the card hits every arm alike
        runs[name].append(cuda_ms(arms[name]))
    ms = {name: statistics.mean(x) for name, x in runs.items()}
    for name in ("K2", "K10 nsplit=2", "K10 nsplit=7"):
        kernels = profile(arms[name], 5)[2]
        print(f"{name} by kernel (torch.profiler, device ms per call): " + "; ".join(
            f"{key.replace('void (anonymous namespace)::', '').split('(')[0][:48]} {t:.4f}" for key, t, _ in kernels))
    plain = cuda_ms(lambda: fa.qknorm_attention_bwd_subtiled_ref(q, k, v, sqk, scale, o, lse, do, 2), iters=5)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    out = attention_qknorm(*leaves, scale, use_flash=False)
    off = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=5)
    qh, kh = (x.detach().requires_grad_() for x in qknorm_project(q, k, sqk, v.dtype))
    vv = v.detach().clone().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vv, scale=scale)
    lib = cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vv), do, retain_graph=True))
    for name, x in runs.items():
        print(f"{name} [B={b}, H={h}, T={t}, D={d}]: {ms[name]:.4f} ms (medians of 20, in turns: "
              f"{', '.join(f'{m:.4f}' for m in x)})")
    print(f"K10 twin (nsplit 2) {plain:.4f} ms (median of 5), flash_attn=False autograd backward {off:.4f} ms "
          f"(median of 5), SDPA backward on projected q/k {lib:.4f} ms; K10 nsplit 2 / K2 "
          f"{ms['K10 nsplit=2'] / ms['K2']:.3f}, nsplit 7 / K2 {ms['K10 nsplit=7'] / ms['K2']:.3f}")
    flops = 10 * b * h * t * t * d
    nbytes = 8 * b * h * t * d * 2 + b * h * t * 4 + h * d * 4 + b * h * d * 4
    partials = 2 * b * h * -(-t // fa.BLOCK) * len(fa.subtile_chunks(t, 2)) * fa.BLOCK * d * 4
    bound_ms, bound_by = bound(flops, nbytes)
    design_ms, design_by = bound(flops, nbytes + partials)
    print(f"K10 bound {bound_ms:.4f} ms ({bound_by}); with the dq̂ partial buffer at nsplit 2 "
          f"({partials / 2 / 2**30:.3f} GiB, written once and read once) {design_ms:.4f} ms ({design_by})")
    del q, k, v, do, o, lse, o_b, lse_b, leaves, out, qh, kh, vv
    torch.cuda.empty_cache()
    return {"qknorm_attn_bwd_subtiled": dict(
        ms=ms["K10 nsplit=2"], ms_nsplit_7=ms["K10 nsplit=7"], plain_ms=plain, library_ms=lib,
        bound_ms=bound_ms, bound_by=bound_by, bound_ms_with_dq_partials=design_ms)}


def post(addr, path, body, content_type):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    conn.request("POST", path, body=body, headers={"Content-Type": content_type})
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    check(resp.status == 200, f"POST {path} → {resp.status}: {payload}")
    return payload


def get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    conn.close()
    check(resp.status == 200, f"GET {path} → {resp.status}: {payload}")
    return payload


def serve_phase(title, path, cfg, pred, plain, *, replicas: int = 1, versus: str = "the plain path",
                passes: int | None = None) -> dict:
    from http.server import ThreadingHTTPServer

    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.serve import InferenceService, make_handler

    phase(f"serve {title} over HTTP")
    n_cls = cfg.model.num_classes
    service = InferenceService(pred, max_batch=32)
    service.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    addr = server.server_address
    rng = np.random.default_rng(0)
    shape = (3, cfg.model.image_size, cfg.model.image_size)
    images = {b: rng.integers(0, 256, (b, *shape), dtype=np.uint8) for b in (1, 4, 32)}
    try:
        reset_counts()
        t0 = time.perf_counter()
        r1 = post(addr, "/predict", images[1][0].tobytes(), "application/octet-stream")
        r4 = post(addr, "/predict", json.dumps({"images": images[4].tolist(), "top_k": n_cls}).encode(),
                  "application/json")
        r32 = post(addr, "/predict", json.dumps({"images": images[32].tolist(), "top_k": 5}).encode(),
                   "application/json")
        served_s = time.perf_counter() - t0
        launches = read_counts()
        health = get(addr, "/healthz")
        stats = get(addr, "/stats")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        service.close()
    check(not thread.is_alive(), "server thread did not stop")
    print(f"3 requests (1 + 4 + 32 images) served in {served_s:.3f} s (JSON encode/parse included)")
    print(f"/healthz: {health}")
    print(f"/stats: {stats}")
    check(health["status"] == "ok" and health["model"]["n_embd"] == cfg.model.n_embd, "bad /healthz")
    check(stats["requests"] == 3 and stats["images"] == 37 and stats["errors"] == 0, "bad /stats counts")
    forwards = stats["device_programs"]
    check(forwards == 3, f"expected 3 device forwards, /stats counts {forwards}")
    # passes: a tensor-parallel forward runs each block's kernels once a shard
    per_forward = n_passes(cfg.model) if passes is None else passes
    print(f"launches in the served run: {launches} over {forwards} forwards")
    # each forward runs once on every replica of a data-parallel Predictor
    check_launches(launches, per_pass(PATHS[path]["forward"], per_forward * forwards * replicas),
                   f"serving {title}")

    for res, b in ((r1, 1), (r4, 4), (r32, 32)):
        labels, probs = np.asarray(res["labels"]), np.asarray(res["probs"])
        check(labels.shape[0] == b and ((labels >= 0) & (labels < n_cls)).all(), f"batch {b}: labels out of range")
        check(np.isfinite(probs).all() and (probs >= 0).all() and (probs <= 1).all(), f"batch {b}: bad probs")
    full = np.zeros((4, n_cls))
    np.put_along_axis(full, np.asarray(r4["labels"]), np.asarray(r4["probs"]), axis=-1)
    check(np.allclose(full.sum(-1), 1.0, atol=1e-4), f"batch 4 probabilities sum to {full.sum(-1)}")

    # the same weights on the plain path (no kernels), on the card
    x = torch.from_numpy(images[4]).to(pred.device)
    with torch.inference_mode():
        logits_k = pred.model(normalize(x), compute_dtype=torch.bfloat16)
        logits_p = plain.model(normalize(x), compute_dtype=torch.bfloat16)
    plain_probs = plain.predict_probs(images[4])
    spread = logits_p.std().item()
    dl = max_err(logits_k, logits_p)
    dp = np.abs(full - plain_probs).max()
    top1 = float((full.argmax(-1) == plain_probs.argmax(-1)).mean())
    print(f"served vs {versus}, batch 4: max|Δlogit| {dl:.3e} (logit std {spread:.3e}, "
          f"bound {LOGIT_TOL} × std), max|Δprob| {dp:.3e}, top-1 agreement {top1:.2f}")
    check(dl <= LOGIT_TOL * spread, f"served logits disagree with {versus}")
    check(np.all(np.abs(full - plain_probs) <= PROB_RTOL * plain_probs + 1e-6),
          f"served probabilities disagree with {versus}")
    return launches


def gated_times(what: str, n: int, d: int, hidden: int, seed: int, with_bias: bool) -> tuple[dict, dict]:
    """K3 and K4 (with a bias: K6 and its backward) at [n, K=d, H=hidden]
    against their twins, the unfused chains and cuBLAS's bare [n, 2H] GEMM
    (a yardstick only: not the same function, so not library_ms) → the two
    kernels' {ms, plain_ms, library_ms, bound_ms, bound_by}."""
    import torch.nn.functional as F

    from nvit_tpu_torch.ops.gated_mlp import (
        gated_mlp_bwd_duv,
        gated_mlp_duv_ref,
        gated_mlp_fwd,
        gated_mlp_ref,
        gated_mlp_xla,
    )
    # the gated_mlp_kernel="off" chain's work for K4's (K6's) function
    from nvit_tpu_torch.scripts.gated_mlp_bench import unfused_bwd

    x, w = mlp_inputs(n, d, hidden, seed=seed)
    bias = bias_inputs(hidden, seed=seed + 1) if with_bias else None
    g = mlp_grad(n, hidden, seed=seed + 2)
    gemm = cuda_ms(lambda: F.linear(x, w))
    fwd = dict(ms=cuda_ms(lambda: gated_mlp_fwd(x, w, bias)), plain_ms=cuda_ms(lambda: gated_mlp_ref(x, w, bias)),
               library_ms=None)
    # the gated_mlp_kernel="off" chain: cuBLAS bf16 matmul, (+ bias,) then a bf16 gate
    fwd_off = cuda_ms(lambda: gated_mlp_xla(x, w, bias))
    bwd = dict(ms=cuda_ms(lambda: gated_mlp_bwd_duv(x, w, g, bias)),
               plain_ms=cuda_ms(lambda: gated_mlp_duv_ref(x, w, g, bias)), library_ms=None)
    bwd_off = cuda_ms(lambda: unfused_bwd(x, w, g, bias))
    del x, w, g, bias
    # the bias: 2H more bf16 values in, 2·n·H more fp32 adds
    flops = 4 * n * d * hidden + (2 * n * hidden if with_bias else 0)
    nbytes = (n * d + 2 * hidden * d + (2 * hidden if with_bias else 0)) * 2
    fwd.update(zip(("bound_ms", "bound_by"), bound(flops, nbytes + n * hidden * 2)))
    bwd.update(zip(("bound_ms", "bound_by"), bound(flops, nbytes + 3 * n * hidden * 2)))
    names = ("K6", "K6 backward") if with_bias else ("K3", "K4")
    for name, tm, off, chain in ((names[0], fwd, fwd_off, "unfused bf16 chain"),
                                 (names[1], bwd, bwd_off, "unfused chain (cuBLAS recompute + bf16 gate backward)")):
        print(f"{name} {what} [n={n}, K={d}, H={hidden}]: kernel {tm['ms']:.4f} ms, plain twin "
              f"{tm['plain_ms']:.4f} ms, {chain} {off:.4f} ms ({off / tm['ms']:.2f}x the kernel's), cuBLAS bare "
              f"[n, 2H] GEMM {gemm:.4f} ms; bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), kernel at "
              f"{100 * tm['bound_ms'] / tm['ms']:.1f}% of it")
    return fwd, bwd


def time_phase(cfg, pred, plain) -> dict:
    """Each kernel at the batch-32 shapes against its plain twin, the
    unfused chain and, for attention, PyTorch's fused SDPA on the projected
    q̂/k̂ (library_ms: a yardstick, used nowhere in the port) → per kernel
    {ms, plain_ms, library_ms, bound_ms, bound_by}; then forward latency."""
    import torch.nn.functional as F

    from nvit_tpu_torch.ops.attention import attention_qknorm, qknorm_project
    from nvit_tpu_torch.ops.flash_attention import (
        flash_attention_qknorm_ref,
        qknorm_attention_bwd,
        qknorm_attention_bwd_ref,
        qknorm_attention_fwd,
        qknorm_project_bf16,
        qknorm_project_bf16_ref,
    )

    phase("times, nViT")
    b = 32
    d, h = cfg.model.n_embd, cfg.model.n_head
    t, hd = cfg.model.n_patches, d // h
    scale = float(hd) ** 0.5
    times = {}

    q, k, v, sqk = attn_inputs(b, h, t, hd, seed=1)
    qh, kh = qknorm_project(q, k, sqk, v.dtype)
    k1 = cuda_ms(lambda: qknorm_attention_fwd(q, k, v, sqk, scale))
    k1_plain = cuda_ms(lambda: flash_attention_qknorm_ref(q, k, v, sqk, scale))
    # the flash_attn=False chain (projection + sdpa, fp32 logits) for reference
    k1_off = cuda_ms(lambda: attention_qknorm(q, k, v, sqk, scale, use_flash=False))
    k1_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, v, scale=scale))
    print(f"K1 [B={b}, H={h}, T={t}, D={hd}]: kernel {k1:.4f} ms, plain twin {k1_plain:.4f} ms, "
          f"flash_attn=False chain {k1_off:.4f} ms, SDPA on projected q/k {k1_lib:.4f} ms")
    times["qknorm_attn_fwd"] = dict(ms=k1, plain_ms=k1_plain, library_ms=k1_lib, **dict(zip(
        ("bound_ms", "bound_by"), bound(4 * b * h * t * t * hd, 4 * b * h * t * hd * 2 + h * hd * 4))))
    # the prologue alone (inside K1's time above): q, k read, q̂_s, k̂ written;
    # per value a square, a sum, a divide and two multiplies
    kp = cuda_ms(lambda: qknorm_project_bf16(q, k, sqk, scale))
    kp_plain = cuda_ms(lambda: qknorm_project_bf16_ref(q, k, sqk, scale))
    print(f"projection prologue [B={b}, H={h}, T={t}, D={hd}] (forward's call): kernel {kp:.4f} ms, "
          f"plain twin {kp_plain:.4f} ms; K1's call without it ~{k1 - kp:.4f} ms")
    times["qknorm_project"] = dict(ms=kp, plain_ms=kp_plain, library_ms=None, **dict(zip(
        ("bound_ms", "bound_by"), bound(10 * b * h * t * hd, 4 * b * h * t * hd * 2 + h * hd * 4))))
    del q, k, v, qh, kh

    q, k, v, sqk, do = qkv_view_inputs(b, h, t, hd, seed=3)
    o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    k2 = cuda_ms(lambda: qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do))
    k2_plain = cuda_ms(lambda: qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do), iters=5)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    out = attention_qknorm(*leaves, scale, use_flash=False)
    k2_off = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=5)
    del out, leaves
    qh, kh = (x.detach().requires_grad_() for x in qknorm_project(q, k, sqk, v.dtype))
    vv = v.detach().clone().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vv, scale=scale)
    k2_lib = cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vv), do, retain_graph=True))
    del out, qh, kh, vv
    print(f"K2 [B={b}, H={h}, T={t}, D={hd}]: kernel {k2:.4f} ms, plain twin {k2_plain:.4f} ms, "
          f"flash_attn=False autograd backward {k2_off:.4f} ms, SDPA backward on projected q/k {k2_lib:.4f} ms")
    times["qknorm_attn_bwd"] = dict(ms=k2, plain_ms=k2_plain, library_ms=k2_lib, **dict(zip(
        ("bound_ms", "bound_by"),
        bound(10 * b * h * t * t * hd, 8 * b * h * t * hd * 2 + b * h * t * 4 + h * hd * 4 + b * h * hd * 4))))
    del q, k, v, o, lse, do

    n = b * t
    for hidden, what in ((4 * d, "c_fc"), (d, "proj")):
        fwd, bwd = gated_times(what, n, d, hidden, seed=2, with_bias=False)
        if what == "c_fc":
            times["gated_mlp_fwd"], times["gated_mlp_bwd"] = fwd, bwd
    # gated_mlp_kernel="auto" takes the kernels up to n_embd 768: nViT-L's
    # c_fc (d = 1024, H = 4096) against the unfused chains
    gated_times("c_fc at nViT-L width", n, 1024, 4096, seed=9, with_bias=False)
    torch.cuda.empty_cache()
    print_bounds(times)
    forward_latency(cfg, pred, plain)
    return times


def print_bounds(times: dict) -> None:
    for name, tm in times.items():
        lib = f", {tm['ms'] / tm['library_ms']:.2f}x the library call" if tm["library_ms"] else ""
        print(f"{name}: bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), kernel at "
              f"{100 * tm['bound_ms'] / tm['ms']:.1f}% of it{lib}")


def forward_latency(cfg, pred, plain) -> None:
    """Host-clock forward latency at batch 1 and 32, kernel and plain path."""
    rng = np.random.default_rng(1)
    shape = (3, cfg.model.image_size, cfg.model.image_size)
    for batch, iters in ((1, 30), (32, 10)):
        imgs = rng.integers(0, 256, (batch, *shape), dtype=np.uint8)
        for p in (pred, plain):  # warm both at this batch
            p.predict_probs(imgs)
        # plain, kernel, kernel, plain: drift on the card hits both alike
        order = [("plain", plain), ("kernel", pred), ("kernel", pred), ("plain", plain)]
        got = {"plain": [], "kernel": []}
        for name, p in order:
            got[name].append(host_ms(lambda: p.predict_probs(imgs), iters))
        for name in ("kernel", "plain"):
            ms = statistics.mean(got[name])
            print(f"forward batch {batch} ({name} path): {ms:.3f} ms median "
                  f"(runs {', '.join(f'{m:.3f}' for m in got[name])}), {batch * 1e3 / ms:.1f} img/s")


def baseline_time_phase(cfg, pred, plain) -> dict:
    """K7, K8 at the batch-32 shapes and K9 at T = 1100 (where the JAX
    package takes the split kernels), each against its plain twin, the
    flash_attn=False chain (autograd through ``sdpa`` for the backwards) and
    PyTorch's fused SDPA, which computes exactly the same function here
    (library_ms: a yardstick, used nowhere in the port); then the baseline
    forward's latency."""
    import torch.nn.functional as F

    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops.attention import sdpa

    phase("times, baseline")
    b = 32
    d, h = cfg.model.n_embd, cfg.model.n_head
    hd = d // h
    scale = 1.0 / float(hd) ** 0.5
    times = {}

    t = cfg.model.n_patches
    q, k, v, _, do = qkv_view_inputs(b, h, t, hd, seed=11)
    k7 = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, scale))
    k7_plain = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, scale))
    k7_off = cuda_ms(lambda: sdpa(q, k, v, scale))
    k7_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    print(f"K7 [B={b}, H={h}, T={t}, D={hd}]: kernel {k7:.4f} ms, plain twin {k7_plain:.4f} ms, "
          f"flash_attn=False chain {k7_off:.4f} ms, SDPA {k7_lib:.4f} ms")
    times["flash_attn_fwd"] = dict(ms=k7, plain_ms=k7_plain, library_ms=k7_lib, **dict(zip(
        ("bound_ms", "bound_by"), bound(4 * b * h * t * t * hd, 4 * b * h * t * hd * 2))))

    def backward_times(t, q, k, v, do, kernel):
        """(kernel, twin, flash_attn=False autograd, SDPA backward) ms."""
        ms = cuda_ms(kernel)
        o, lse = fa.flash_attention_ref(q, k, v, scale)
        twin = (lambda: fa.attention_bwd_fused_ref(q, k, v, o, lse, do, scale)) if t <= fa.FUSED_BWD_MAX_T \
            else (lambda: (fa.attention_dq_ref(q, k, v, do, lse, fa.attention_delta(o, do), scale),
                           fa.attention_dkv_ref(q, k, v, do, lse, fa.attention_delta(o, do), scale)))
        plain_ms = cuda_ms(twin, iters=5)
        del o, lse
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        out = sdpa(*leaves, scale)
        off = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=5)
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        lib = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
        return ms, plain_ms, off, lib

    o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
    k8 = backward_times(t, q, k, v, do, lambda: fa.attention_bwd_fused(q, k, v, o, lse, do, scale))
    print(f"K8 [B={b}, H={h}, T={t}, D={hd}]: kernel {k8[0]:.4f} ms, plain twin {k8[1]:.4f} ms (median "
          f"of 5), flash_attn=False autograd backward {k8[2]:.4f} ms (median of 5), SDPA backward {k8[3]:.4f} ms")
    times["flash_attn_bwd_fused"] = dict(ms=k8[0], plain_ms=k8[1], library_ms=k8[3], **dict(zip(
        ("bound_ms", "bound_by"), bound(10 * b * h * t * t * hd, 8 * b * h * t * hd * 2 + b * h * t * 4))))
    # the backward's prologue alone (inside K8's time above): q, k, o, dO and
    # lse read, qs, ks and the padded lse and Δ written; per value two
    # multiplies and a product summed into Δ
    kp = cuda_ms(lambda: fa.flash_project_bf16(q, k, scale, lse=lse, o=o, do=do))
    kp_plain = cuda_ms(lambda: fa.flash_project_bf16_ref(q, k, scale, lse=lse, o=o, do=do))
    print(f"backward prologue [B={b}, H={h}, T={t}, D={hd}] (K8's call): kernel {kp:.4f} ms, plain twin "
          f"{kp_plain:.4f} ms; K8's call without it ~{k8[0] - kp:.4f} ms")
    t_pad = -(-t // fa.BLOCK) * fa.BLOCK
    times["flash_project"] = dict(ms=kp, plain_ms=kp_plain, library_ms=None, **dict(zip(
        ("bound_ms", "bound_by"),
        bound(4 * b * h * t * hd, 6 * b * h * t * hd * 2 + b * h * t * 4 + 2 * b * h * t_pad * 4))))
    del q, k, v, do, o, lse

    t = 1100
    q, k, v, _, do = qkv_view_inputs(b, h, t, hd, seed=12)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, with_lse=True)
    delta = fa.attention_delta(o, do)
    k9 = backward_times(t, q, k, v, do, lambda: fa.attention_bwd_split(q, k, v, do, lse, delta, scale))
    print(f"K9 [B={b}, H={h}, T={t}, D={hd}]: kernel {k9[0]:.4f} ms, plain twins {k9[1]:.4f} ms (median "
          f"of 5), flash_attn=False autograd backward {k9[2]:.4f} ms (median of 5), SDPA backward {k9[3]:.4f} ms")
    times["flash_attn_bwd_split"] = dict(ms=k9[0], plain_ms=k9[1], library_ms=k9[3], **dict(zip(
        ("bound_ms", "bound_by"), bound(10 * b * h * t * t * hd, 7 * b * h * t * hd * 2 + 2 * b * h * t * 4))))
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    print_bounds(times)
    forward_latency(cfg, pred, plain)
    return times


def bias_bounded_time_phase(cfg, pred, plain) -> dict:
    """K6 (c_fc, proj) and K5 (mode="bounded", sqk_eff ≈ 1) at the batch-32
    shapes against their twins, the unfused chains and, for K5, PyTorch's
    fused SDPA on the projected q̂/k̂ (library_ms: a yardstick, used nowhere
    in the port); then path A's forward latency."""
    import torch.nn.functional as F

    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops.attention import attention_qknorm, qknorm_project

    phase("times, bias (K6) and bounded (K5) kernels")
    b = 32
    d, h = cfg.model.n_embd, cfg.model.n_head
    t, hd = cfg.model.n_patches, d // h
    scale = float(hd) ** 0.5
    times = {}
    n = b * t
    for hidden, what in ((4 * d, "c_fc"), (d, "proj")):
        fwd, bwd = gated_times(what, n, d, hidden, seed=5, with_bias=True)
        if what == "c_fc":
            times["gated_mlp_fwd_bias"], times["gated_mlp_bwd_bias"] = fwd, bwd

    q, k, v, sqk, do = qkv_view_inputs(b, h, t, hd, seed=8)
    qh, kh = qknorm_project(q, k, sqk, v.dtype)
    k5 = cuda_ms(lambda: fa.qknorm_attention_fwd(q, k, v, sqk, scale, mode="bounded"))
    k5_plain = cuda_ms(lambda: fa.flash_attention_qknorm_ref(q, k, v, sqk, scale, "bounded"))
    k5_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, v, scale=scale))
    print(f"K5 [B={b}, H={h}, T={t}, D={hd}] bounded, max bound {fa.head_bounds(sqk, scale).max().item():.2f}: "
          f"kernel {k5:.4f} ms, plain twin {k5_plain:.4f} ms, SDPA on projected q/k {k5_lib:.4f} ms")
    times["qknorm_attn_fwd_bounded"] = dict(ms=k5, plain_ms=k5_plain, library_ms=k5_lib, **dict(zip(
        ("bound_ms", "bound_by"), bound(4 * b * h * t * t * hd, 4 * b * h * t * hd * 2 + h * hd * 4))))
    o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
    k5b = cuda_ms(lambda: fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do, "bounded"))
    k5b_plain = cuda_ms(lambda: fa.qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do, "bounded"), iters=5)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    out = attention_qknorm(*leaves, scale, use_flash=False)
    k5b_off = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), iters=5)
    qh, kh = (x.detach().requires_grad_() for x in (qh, kh))
    vv = v.detach().clone().requires_grad_()
    out = F.scaled_dot_product_attention(qh, kh, vv, scale=scale)
    k5b_lib = cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vv), do, retain_graph=True))
    print(f"K5 backward [B={b}, H={h}, T={t}, D={hd}] bounded: kernel {k5b:.4f} ms, plain twin {k5b_plain:.4f} ms "
          f"(median of 5), flash_attn=False autograd backward {k5b_off:.4f} ms, SDPA backward on projected "
          f"q/k {k5b_lib:.4f} ms")
    times["qknorm_attn_bwd_bounded"] = dict(ms=k5b, plain_ms=k5b_plain, library_ms=k5b_lib, **dict(zip(
        ("bound_ms", "bound_by"),
        bound(10 * b * h * t * t * hd, 8 * b * h * t * hd * 2 + b * h * t * 4 + h * hd * 4 + b * h * hd * 4))))
    del q, k, v, sqk, do, qh, kh, vv, out, leaves, o, lse
    torch.cuda.empty_cache()
    print_bounds(times)
    forward_latency(cfg, pred, plain)
    return times


# parameter groups the kernel path's gradients are held against the plain path in
GRAD_GROUPS = {
    "blocks q/k/v": r"transformer\.h\.\d+\.(query|key|value)\.weight",
    "c_fc": r"transformer\.h\.\d+\.c_fc\.weight",
    "c_projs": r"transformer\.h\.\d+\.(att_c_proj|mlp_c_proj)\.weight",
    "sqk": r"transformer\.h\.\d+\.sqk",
    "suv": r"transformer\.h\.\d+\.suv",
    "alphas": r"transformer\.h\.\d+\.(attn_alpha|mlp_alpha|skip_param)",
    "cross-attention": r"cross_attention\..+",
    "embeds": r"(local_patch_embed|global_patch_embed|local_pos_embed|global_pos_embed).*",
    "head": r"(mlp_head\..+|sz)",
}
# baseline mode: no sqk, suv, alphas or sz; the blocks' RMSNorm gains.  The
# block returns x + …, with x = rms_norm(h) ∝ h, so norm_skip's justnorm VJP
# (⟂ its input) leaves d skip_param a near-cancellation; it is grouped with
# the other per-block gains and printed alone
BASELINE_GRAD_GROUPS = {
    "blocks q/k/v": GRAD_GROUPS["blocks q/k/v"],
    "c_fc": GRAD_GROUPS["c_fc"],
    "c_projs": GRAD_GROUPS["c_projs"],
    "rmsnorms, skip_param": r"transformer\.h\.\d+\.(rmsnorm_att\.weight|rmsnorm_mlp\.weight|skip_param)",
    "cross-attention": GRAD_GROUPS["cross-attention"],
    "embeds": GRAD_GROUPS["embeds"],
    "head": r"mlp_head\..+",
}
# bias=True adds the blocks' biases: c_fc's (K6's db, through the suv fold in
# nViT) apart from the rest (the cross-attention's, with its gated proj's,
# are in "cross-attention").  In baseline the key biases' gradient is 0 in
# exact arithmetic (softmax ignores a shift of a whole row of scores); theirs
# is rounding and weighs nothing beside the other biases of their group
BIAS_GROUPS = {
    "c_fc biases": r"transformer\.h\.\d+\.c_fc\.bias",
    "q/k/v, c_proj biases": r"transformer\.h\.\d+\.(query|key|value|att_c_proj|mlp_c_proj)\.bias",
}


def randomize_biases(model, seed: int) -> None:
    """normal(0, 0.02) biases in every block and the cross-attention (the
    init zeroes them), so the bias kernels' forwards add something."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("transformer.", "cross_attention.")) and name.endswith(".bias"):
                p.normal_(0.0, 0.02, generator=g)


def batch32(m):
    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.data.datasets import make_synthetic

    data = make_synthetic(num_examples=32, image_size=m.image_size, num_classes=m.num_classes, seed=0)
    return data.images, normalize(torch.from_numpy(data.images).cuda()), torch.from_numpy(data.labels).cuda().long()


def plain_twin(cfg, model):
    """(config, model) of the plain path (flash_attn=False, gated MLP off)
    with ``model``'s weights."""
    from nvit_tpu_torch.models.vit import ViT

    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, flash_attn=False,
                                                                   gated_mlp_kernel="off"))
    plain_model = ViT(plain_cfg.model, device="cuda")
    plain_model.load_state_dict(model.state_dict(), strict=True)
    return plain_cfg, plain_model


def compare_gradients(cfg, model, plain_cfg, plain_model, images, labels, grad_groups: dict) -> None:
    """The kernel path's loss and per-group gradients against the plain
    path's, same weights and batch; leaves no gradient behind."""
    import re

    from nvit_tpu_torch.train.step import make_loss_fn

    losses, grads = {}, {}
    for name, mdl, c in (("kernel", model, cfg), ("plain", plain_model, plain_cfg)):
        loss, _ = make_loss_fn(c)(mdl, images, labels)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {n: p.grad for n, p in mdl.named_parameters() if p.grad is not None}
    dl = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    print(f"loss: kernel path {losses['kernel']:.6f}, plain path {losses['plain']:.6f} "
          f"(relative gap {dl:.3e}, bound {TRAIN_LOSS_RTOL})")
    check(dl <= TRAIN_LOSS_RTOL, "the kernel path's loss disagrees with the plain path's")
    grouped = set()
    worst = 0.0
    for group, pattern in grad_groups.items():
        names = [n for n in grads["plain"] if re.fullmatch(pattern, n)]
        grouped.update(names)
        gk = torch.cat([grads["kernel"][n].flatten() for n in names])
        gp = torch.cat([grads["plain"][n].flatten() for n in names])
        rel = rel_l2(gk, gp)
        worst = max(worst, rel)
        print(f"grad {group} ({len(names)} tensors, {gp.numel()} values): relative L2 {rel:.3e}")
    check(grouped == set(grads["plain"]) == set(grads["kernel"]), "a gradient is in no group")
    check(worst <= GRAD_REL_L2, f"gradients disagree with the plain path: worst group {worst:.3e}")
    skips = [n for n in grads["plain"] if n.endswith("skip_param")]
    print("grad skip_param alone: relative L2 {:.3e}".format(rel_l2(
        torch.cat([grads["kernel"][n] for n in skips]), torch.cat([grads["plain"][n] for n in skips]))))
    del grads
    for mdl in (model, plain_model):
        mdl.zero_grad(set_to_none=True)


def step_launches(cfg, path, state, images, labels) -> dict:
    """One make_train_step step launches each of the path's kernels once per
    block and once for the shared cross-attention, and no other kernel."""
    from nvit_tpu_torch.scripts.step_time import sync_step
    from nvit_tpu_torch.train.step import make_train_step

    step = make_train_step(cfg)
    reset_counts()
    sync_step(step, state, images, labels)
    launches = read_counts()
    print(f"launches in one training step: {launches}")
    check_launches(launches, per_pass(PATHS[path]["step"], n_passes(cfg.model)), "one training step")
    return launches


def train_phase(smi: str, title: str, path: str, cfg, grad_groups: dict) -> dict:
    import shutil
    import tempfile

    from nvit_tpu_torch.configs import AugmentationConfig
    from nvit_tpu_torch.models.vit import estimate_flops_per_iter, num_params
    from nvit_tpu_torch.scripts.step_time import step_ms, sync_step
    from nvit_tpu_torch.train.optim import init_fused_adamw
    from nvit_tpu_torch.train.state import TrainState, create_train_state
    from nvit_tpu_torch.train.step import make_train_step
    from nvit_tpu_torch.train.trainer import Trainer

    phase(f"train {title} (flagship_config: batch 32, bf16, fp32 params and moments, no remat)")
    m = cfg.model
    check(m.flash_attn and not cfg.system.remat and cfg.training.batch_size == 32,
          "flagship training config drifted")
    b = cfg.training.batch_size
    held = torch.cuda.memory_allocated() / 2**30
    print(f"device memory allocated at the phase's start: {held:.3f} GiB")
    # an earlier path's state (a Trainer's is 1.34 GiB at this width) would
    # inflate this path's peaks and loosen the Trainer's memory check
    check(held <= PHASE_START_GIB, f"{held:.3f} GiB still allocated from earlier phases")
    _, images, labels = batch32(m)
    state = create_train_state(cfg, seed=0, device="cuda")
    if m.bias:
        randomize_biases(state.model, seed=1)
    plain_cfg, plain_model = plain_twin(cfg, state.model)
    compare_gradients(cfg, state.model, plain_cfg, plain_model, images, labels, grad_groups)
    launches = step_launches(cfg, path, state, images, labels)
    per_step = n_passes(m)

    # step time on both paths: plain, kernel, kernel, plain
    plain_state = TrainState(model=plain_model, opt_state=init_fused_adamw(plain_model.named_parameters()),
                             step=0, generator=torch.Generator())
    hot = {"kernel": (make_train_step(cfg, log_norms=False), state),
           "plain": (make_train_step(plain_cfg, log_norms=False), plain_state)}
    peak = {}
    for name, (fn, st) in hot.items():
        sync_step(fn, st, images, labels)  # warm
        torch.cuda.reset_peak_memory_stats()
        sync_step(fn, st, images, labels)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
    got = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn, st = hot[name]
        got[name].append(step_ms(fn, st, images, labels, 3))
    flops = estimate_flops_per_iter(m, num_params(state.model)) * b
    step_times = {}
    for name in ("kernel", "plain"):
        ms = statistics.mean(got[name])
        step_times[name] = ms
        print(f"train step ({name} path): {ms:.3f} ms (runs {', '.join(f'{x:.3f}' for x in got[name])}), "
              f"{b * 1e3 / ms:.1f} img/s, MFU {flops / (ms / 1e3) / peak_flops():.4f} against "
              f"{peak_flops() / 1e12:.0f} TFLOP/s, peak memory {peak[name]:.2f} GiB [{smi}]")
    del hot, plain_state, plain_model, state
    torch.cuda.empty_cache()
    print(f"device memory allocated after the timed steps: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")

    # ten steps on one repeated batch lower the loss (no warmup: the default
    # 500-step warmup leaves lr ≤ 2e-5 over ten steps)
    cfg10 = dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, warmup_iters=0))
    state = create_train_state(cfg10, seed=1, device="cuda")
    step10 = make_train_step(cfg10, log_norms=False)
    curve = [float(step10(state, images, labels)[1]["total_loss"]) for _ in range(10)]
    print("ten steps on one batch, loss: " + ", ".join(f"{x:.4f}" for x in curve))
    check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0], "ten steps did not lower the loss")
    del state
    torch.cuda.empty_cache()

    # Trainer.train() end to end: synthetic 224 px data, one eval, a log every 4
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    iters = 12
    tcfg = dataclasses.replace(
        cfg,
        training=dataclasses.replace(cfg.training, max_iters=iters, eval_interval=100, log_interval=4,
                                     eval_iters=2, always_save_checkpoint=False),
        system=dataclasses.replace(cfg.system, quick_validation_size=64),
        data=dataclasses.replace(cfg.data, dataset="synthetic", out_dir=str(out_dir),
                                 augmentation=AugmentationConfig(auto_augment=False)),
    )
    trainer = Trainer(tcfg, device="cuda")
    # the logged peak is the trainer's own: what the timed plain-path step
    # reached (above) must not show through
    torch.cuda.reset_peak_memory_stats()
    print(f"device memory before Trainer.train(): allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
          f"peak after reset {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    reset_counts()
    t0 = time.perf_counter()
    trainer.train()
    seconds = time.perf_counter() - t0
    trainer_launches = read_counts()
    lines = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    logs = [x for x in lines if "train/batch_loss" in x]
    evals = [x for x in lines if "val/loss" in x]
    print(f"Trainer.train(): {iters} iterations in {seconds:.1f} s, synthetic data "
          f"({len(trainer.trainset)} + {len(trainer.valset)} images at {m.image_size} px) made in "
          f"{trainer.load_seconds:.1f} s; launches {trainer_launches}")
    for x in logs:
        print(f"  iter {x['train/iter']}: loss {x['train/batch_loss']:.4f}, {x['train/batch_time_ms']:.1f} ms, "
              f"mfu {x['train/mfu']}, max mem {x.get('system/device_0/max_mem_allocated_gb')}")
    print(f"  eval at 0: val/loss {evals[0]['val/loss']:.4f}, train/loss {evals[0]['train/loss']:.4f}")
    check(len(evals) == 1 and [x["train/iter"] for x in logs] == [4, 8, 12], "unexpected metrics.jsonl lines")
    check(all(math.isfinite(x["train/batch_loss"]) and isinstance(x["train/mfu"], float) for x in logs),
          "metrics.jsonl lacks finite losses or train/mfu")
    check(math.isfinite(evals[0]["val/loss"]), "non-finite eval loss")
    trainer_peak = max(x["system/device_0/max_mem_allocated_gb"] for x in logs)
    print(f"Trainer peak device memory {trainer_peak:.3f} GiB against one kernel-path step's "
          f"{peak['kernel']:.3f} GiB (bound x{TRAINER_PEAK_MARGIN}) [{smi}]")
    check(trainer_peak <= TRAINER_PEAK_MARGIN * peak["kernel"],
          f"the Trainer's peak memory {trainer_peak:.3f} GiB is above one step's {peak['kernel']:.3f} GiB")
    check((out_dir / "finished").read_text() == f"max_iters:{iters}", "no finished sentinel")
    for name, count in trainer_launches.items():  # the evals add forwards, not backwards
        if name in PATHS[path]["forward"]:
            check(count >= iters * per_step, f"Trainer: {name} launched {count}")
        else:
            want = iters * per_step if name in PATHS[path]["step"] else 0
            check(count == want, f"Trainer: {name} launched {count}, expected {want}")
    shutil.rmtree(out_dir)
    return launches


def reuse_synthetic_data() -> None:
    """Trainer.train() makes its synthetic 224 px arrays itself (~13 s); the
    second mode's trainer gets the first one's, which are the same arrays
    from the same seeds."""
    import nvit_tpu_torch.train.trainer as trainer_module

    load, made = trainer_module.load_dataset, {}

    def load_once(dataset, data_dir, **kw):
        key = (dataset, *sorted(kw.items()))
        if key not in made:
            made[key] = load(dataset, data_dir, **kw)
        return made[key]

    trainer_module.load_dataset = load_once


def check_phase(title: str, path: str, cfg, grad_groups: dict, *, sqk_factor: float = 1.0,
                arm: str | None = None) -> dict:
    """One batch-32 forward through Predictor and one training step at full
    width, each launching the path's kernels 13 times and no other; logits,
    loss and per-group gradients against the plain path on the same weights.
    ``sqk_factor`` scales every sqk; for "auto", ``arm`` is the arm its gate
    must pick: the logits bit-equal to that static mode's and unequal to the
    other's → {"forward": launches, "step": launches}."""
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.vit import ViT
    from nvit_tpu_torch.train.state import create_train_state

    phase(f"check {title}: one batch-32 forward and one training step against the plain path")
    m = cfg.model
    u8, images, labels = batch32(m)
    state = create_train_state(cfg, seed=0, device="cuda")
    randomize_biases(state.model, seed=1)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            if name.endswith(".sqk"):
                p.mul_(sqk_factor)
    plain_cfg, plain_model = plain_twin(cfg, state.model)
    pred = Predictor(state.model, m, device="cuda")
    reset_counts()
    probs = pred.predict_probs(u8)
    forward = read_counts()
    print(f"launches in one batch-32 forward: {forward}")
    check_launches(forward, per_pass(PATHS[path]["forward"], n_passes(m)), f"forward, {title}")
    check(probs.shape == (len(u8), m.num_classes) and np.isfinite(probs).all(), "bad probabilities")
    with torch.inference_mode():
        logits = state.model(images, compute_dtype=torch.bfloat16)
        logits_p = plain_model(images, compute_dtype=torch.bfloat16)
    spread, dl = logits_p.std().item(), max_err(logits, logits_p)
    print(f"kernel vs plain path, batch 32: max|Δlogit| {dl:.3e} (logit std {spread:.3e}, "
          f"bound {LOGIT_TOL} × std)")
    check(dl <= LOGIT_TOL * spread, f"{title}: logits disagree with the plain path")
    if arm is not None:
        other = "rowmax" if arm == "bounded" else "bounded"
        static = {}
        for mode in (arm, other):
            model = ViT(dataclasses.replace(m, bounded_softmax=mode), device="cuda")
            model.load_state_dict(state.model.state_dict(), strict=True)
            with torch.inference_mode():
                static[mode] = model(images, compute_dtype=torch.bfloat16)
            del model
        same, differs = torch.equal(logits, static[arm]), not torch.equal(logits, static[other])
        print(f"auto: logits bit-equal to bounded_softmax={arm!r}'s: {same}; unequal to {other!r}'s: {differs}")
        check(same and differs, f"{title}: auto did not take the {arm} arm")
    state.model.train()
    compare_gradients(cfg, state.model, plain_cfg, plain_model, images, labels, grad_groups)
    stepped = step_launches(cfg, path, state, images, labels)
    del state, plain_model, pred
    return {"forward": forward, "step": stepped}


# the lifecycle phase: the checkpoint's size and speed, and the served export
LIFECYCLE_ITERS = 6  # the straight run; the relaunched run takes 3 + 3
EXPORT_LOGIT_TOL = 0.05  # max |Δ log p| of the bf16 export against the fp32 checkpoint


def env_of(cfg) -> dict:
    """NVIT_SECTION__KEY[__SUB] variables that pin every field of ``cfg``,
    so the CLI's config (settings.yaml under them) is ``cfg``."""
    out = {}

    def walk(prefix, tree):
        for key, value in tree.items():
            name = f"{prefix}__{key.upper()}"
            if isinstance(value, dict):
                walk(name, value)
            else:
                out[name] = str(value).lower() if isinstance(value, bool) else str(value)

    for section, tree in cfg.to_dict().items():
        walk(f"NVIT_{section.upper()}", tree)
    return out


class Cli:
    """One ``python -m ...`` of the port in a subprocess on this checkout,
    its output lines kept and readable while it runs."""

    def __init__(self, args, env: dict, cwd: Path, name: str):
        self.name = name
        self.proc = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**{k: v for k, v in os.environ.items() if not k.startswith("NVIT_")},
                            "PYTHONPATH": str(Path(__file__).resolve().parent), **env})
        self.lines = []
        self._queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            self._queue.put(line)

    def wait_for(self, *texts: str, timeout: float = 300) -> str:
        """The first output line holding one of ``texts``; fails if the process ends first."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._queue.get(timeout=max(0.1, min(5.0, deadline - time.monotonic())))
            except queue.Empty:
                check(self.proc.poll() is None, f"{self.name} exited {self.proc.returncode} before "
                      f"printing {texts}:\n" + "\n".join(self.lines[-30:]))
                check(time.monotonic() < deadline, f"{self.name}: no {texts} in {timeout} s")
                continue
            if any(t in line for t in texts):
                return line.rstrip("\n")

    def finish(self, timeout: float = 600) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:  # stop every process this script starts
                self.proc.kill()
                self.proc.wait()
        time.sleep(0.2)  # the reader drains the pipe
        return rc

    def run(self, timeout: float = 600) -> list:
        rc = self.finish(timeout)
        check(rc == 0, f"{self.name} exited {rc}:\n" + "\n".join(self.lines[-40:]))
        return self.lines


def npz_leaves(path: Path) -> list:
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def lifecycle_phase(smi: str) -> dict:
    """The run's lifecycle at nViT-B/16 full width (flagship_config(): batch
    32, bf16, fp32 params and moments, no remat, synthetic 224 px data): a
    straight run of 6 iterations against one relaunched after 3 with
    init_from=resume (every leaf of the final checkpoint_latest bit-equal,
    the resumed steps launching K1–K4 13 times each and the prologue 26);
    the checkpoint's size and save/restore times; ``python -m
    nvit_tpu_torch`` resumed, stopped by SIGTERM, relaunched, and run
    eval-only on its checkpoint_best; ``python -m nvit_tpu_torch.ckpt.export``
    (bf16) and ``python -m nvit_tpu_torch.serve --export`` answering
    /predict against ``Predictor.from_checkpoint`` on the fp32 checkpoint,
    reloading on SIGHUP and draining on SIGTERM → the resumed run's launches."""
    import shutil
    import tempfile

    from nvit_tpu_torch.ckpt.checkpoint import (
        load_checkpoint_meta,
        restore_for_resume,
        save_checkpoint_async,
        state_leaves,
    )
    from nvit_tpu_torch.configs import AugmentationConfig
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.train.trainer import Trainer

    phase("lifecycle nViT-B/16 (flagship_config: batch 32, bf16, fp32 params and moments, no remat): "
          "checkpoints, resume, the CLIs, export, serving from the export")
    base = flagship_config()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_lifecycle_"))

    def config(out: Path, **training):
        return dataclasses.replace(
            base,
            training=dataclasses.replace(base.training, max_iters=LIFECYCLE_ITERS, eval_interval=3,
                                         eval_iters=1, log_interval=1, always_save_checkpoint=True,
                                         **training),
            system=dataclasses.replace(base.system, quick_validation_size=32),
            data=dataclasses.replace(base.data, dataset="synthetic", out_dir=str(out),
                                     checkpoint_dir=str(out), augmentation=AugmentationConfig(auto_augment=False)))

    try:
        # A: 6 straight iterations (evals at 0 and 3, checkpoint_latest at 3 and 6)
        straight, relaunched = root / "straight", root / "relaunched"
        Trainer(config(straight), device="cuda").train()
        # B: 3 iterations, then a relaunch that resumes from checkpoint_latest
        first = Trainer(config(relaunched, max_iters_per_launch=3), device="cuda")
        first.train()
        check(first.iter_num == 3 and not (relaunched / "finished").exists(), "the first launch did not stop at 3")
        del first
        resumed = Trainer(config(relaunched, init_from="resume"), device="cuda")
        check(resumed.iter_num == 3 and resumed._eval_count == 1, "the resume did not restore iteration 3")
        per_step = []

        def counted(step):
            def run(state, images, labels):
                before = read_counts()
                out = step(state, images, labels)
                per_step.append({k: v - before[k] for k, v in read_counts().items()})
                return out
            return run

        resumed._train_step, resumed._train_step_norms = counted(resumed._train_step), counted(
            resumed._train_step_norms)
        reset_counts()
        resumed.train()
        launches = read_counts()
        del resumed
        torch.cuda.empty_cache()
        print(f"launches in the resumed launch (3 steps, one eval): {launches}")
        want = per_pass(PATHS["nvit"]["step"], n_passes(base.model))
        check(len(per_step) == 3, f"the resumed launch took {len(per_step)} steps")
        for counts in per_step:
            check_launches(counts, want, "one resumed training step")
        for name in PATHS["nvit"]["step"]:
            check(launches[name] > 0, f"the resumed launch never launched {name}")
        a, b = npz_leaves(straight / "checkpoint_latest.npz"), npz_leaves(relaunched / "checkpoint_latest.npz")
        differ = [i for i, (x, y) in enumerate(zip(a, b)) if not np.array_equal(x, y)]
        worst = max((float(np.abs(a[i].astype(np.float64) - b[i]).max()) for i in differ), default=0.0)
        print(f"straight vs relaunched checkpoint_latest: {len(a)} leaves, {len(differ)} differ "
              f"(max |Δ| {worst:.3e})")
        check(len(a) == len(b) and not differ, "the resumed run is not bit-equal to the straight run")
        ma, mb = (load_checkpoint_meta(d, "checkpoint_latest") for d in (straight, relaunched))
        print(f"meta: iter_num {ma['iter_num']} / {mb['iter_num']}, trainer {ma['trainer']} / {mb['trainer']}")
        check(ma["iter_num"] == mb["iter_num"] == LIFECYCLE_ITERS and ma["trainer"] == mb["trainer"],
              "iter_num or meta['trainer'] did not carry across the relaunch")

        # the checkpoint's size and speed: restore A's, save it again (the
        # host copy on this thread, the files on another)
        size = (straight / "checkpoint_latest.npz").stat().st_size
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg, meta = restore_for_resume(straight, "checkpoint_latest", device="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(all(np.array_equal(x, y) for x, y in zip(state_leaves(state), a)),
              "the restored state is not the checkpoint")
        cli_dir = root / "cli"
        # a checkpoint with no trainer state: the CLI's first eval after it is
        # an improvement by definition, so its checkpoint_best exists (on the
        # synthetic data the val split's classes are the train split's in name
        # only, and a later eval improves on the first by chance alone)
        t0 = time.perf_counter()
        pending = save_checkpoint_async(cli_dir, "checkpoint_latest", state, cfg, meta["metrics"])
        snapshot_s = time.perf_counter() - t0
        pending.result()
        write_s = time.perf_counter() - t0 - snapshot_s
        del state
        torch.cuda.empty_cache()
        print(f"checkpoint_latest: {len(a)} leaves, {size} bytes ({size / 2**30:.3f} GiB); restore "
              f"{restore_s:.3f} s; save: host copy {snapshot_s:.3f} s, then the file write {write_s:.3f} s "
              f"on its thread [{smi}]")

        # python -m nvit_tpu_torch: resume, SIGTERM after the first logged step
        env = {**env_of(config(cli_dir)), "NVIT_TRAINING__INIT_FROM": "resume",
               "NVIT_TRAINING__MAX_ITERS": "1000", "NVIT_TRAINING__ALWAYS_SAVE_CHECKPOINT": "false"}
        run = Cli(["nvit_tpu_torch"], env, root, "python -m nvit_tpu_torch")
        print(f"  {run.wait_for('Iter: ')}")
        run.proc.send_signal(signal.SIGTERM)
        rc = run.finish()
        stopped = load_checkpoint_meta(cli_dir, "checkpoint_latest")["iter_num"]
        got = [x for x in run.lines if "signal" in x]
        print(f"  SIGTERM → exit {rc}, checkpoint_latest at iteration {stopped}; " + " | ".join(got))
        check(rc == 0 and stopped >= LIFECYCLE_ITERS + 1 and got, "the CLI did not stop cleanly on SIGTERM")
        best = load_checkpoint_meta(cli_dir, "checkpoint_best")["iter_num"]
        check(best == LIFECYCLE_ITERS, f"checkpoint_best at {best}, not at the first eval")
        t0 = time.perf_counter()
        Cli(["nvit_tpu_torch"], {**env, "NVIT_TRAINING__MAX_ITERS": str(stopped + 2)}, root,
            "python -m nvit_tpu_torch (relaunch)").run()
        relaunch_s = time.perf_counter() - t0
        after = load_checkpoint_meta(cli_dir, "checkpoint_latest")["iter_num"]
        print(f"  relaunch with init_from=resume: iteration {stopped} → {after} in {relaunch_s:.1f} s "
              f"(process included); finished: {(cli_dir / 'finished').read_text()}")
        check(after == stopped + 2 and (cli_dir / "finished").read_text() == f"max_iters:{stopped + 2}",
              "the relaunch did not continue from the stopped run")
        lines = Cli(["nvit_tpu_torch"], {**env, "NVIT_TRAINING__EVAL_ONLY": "true",
                                         "NVIT_DATA__CHECKPOINT_FILE": "checkpoint_best"},
                    root, "python -m nvit_tpu_torch (eval_only)").run()
        got = [x for x in lines if "Validation metrics" in x]
        print(f"  eval_only on checkpoint_best: {got[-1].split(' - ')[-1] if got else 'nothing'}")
        check(len(got) == 1 and "nan" not in got[0], "eval_only printed no finite validation metrics")

        # export (bf16) and serve it; /predict against the fp32 checkpoint
        deploy = root / "deploy"
        lines = Cli(["nvit_tpu_torch.ckpt.export", "--checkpoint", str(cli_dir), "--name", "checkpoint_best",
                     "--dest", str(deploy)], {}, root, "python -m nvit_tpu_torch.ckpt.export").run()
        export_size = (deploy / "checkpoint_best.export.npz").stat().st_size
        print(f"  {lines[-1]}: {export_size} bytes [{smi}]")
        server = Cli(["nvit_tpu_torch.serve", "--export", "--checkpoint", str(deploy), "--name",
                      "checkpoint_best", "--warm-buckets", "--max-batch", "32", "--port", "0"], {}, root,
                     "python -m nvit_tpu_torch.serve")
        try:
            warmed = server.wait_for("warmed batches")
            addr = ("127.0.0.1", int(server.wait_for("serving").rsplit(":", 1)[1]))
            print(f"  serve: {warmed} [{smi}]")
            ref = Predictor.from_checkpoint(cli_dir, "checkpoint_best", device="cuda")
            n_cls = base.model.num_classes
            rng = np.random.default_rng(3)
            shape = (3, base.model.image_size, base.model.image_size)
            for b in (1, 32):
                images = rng.integers(0, 256, (b, *shape), dtype=np.uint8)
                res = post(addr, "/predict", json.dumps({"images": images.tolist(), "top_k": n_cls}).encode(),
                           "application/json")
                served = np.zeros((b, n_cls))
                np.put_along_axis(served, np.asarray(res["labels"]), np.asarray(res["probs"]), axis=-1)
                want = ref.predict_probs(images)
                dlog = float(np.abs(np.log(served) - np.log(want)).max())
                top1 = float((served.argmax(-1) == want.argmax(-1)).mean())
                print(f"  /predict batch {b}, bf16 export vs Predictor.from_checkpoint (fp32): "
                      f"max|Δ log p| {dlog:.3e} (bound {EXPORT_LOGIT_TOL}), top-1 agreement {top1:.2f}")
                check(np.isfinite(served).all() and dlog <= EXPORT_LOGIT_TOL,
                      f"batch {b}: the served export disagrees with the checkpoint")
            del ref
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            server.proc.send_signal(signal.SIGHUP)
            got = server.wait_for("reloaded", "reload failed")
            print(f"  SIGHUP: {got} in {time.perf_counter() - t0:.3f} s")
            check(got.startswith("reloaded"), "the reload failed")
            stats = get(addr, "/stats")
            check(stats["reloads"] == 1 and stats["errors"] == 0, f"bad /stats after the reload: {stats}")
            server.proc.send_signal(signal.SIGTERM)
            server.wait_for("drained; exiting")
        finally:
            rc = server.finish(timeout=120)
        print(f"  SIGTERM: drained; exit {rc}")
        check(rc == 0, f"the server exited {rc}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# the data phase: the profiles as users run them, path A under remat and
# AutoAugment, the ImageNet folder path
# the Kohonen terms the validation logs (the JAX trainer's names)
KOHONEN_VAL = ("consistency_loss", "smoothness_loss", "local_quantization_loss", "global_quantization_loss")
PROFILE_OVERRIDES = {"NVIT_TRAINING__MAX_ITERS": "60", "NVIT_TRAINING__EVAL_INTERVAL": "30",
                     "NVIT_TRAINING__EVAL_ITERS": "2", "NVIT_TRAINING__LOG_INTERVAL": "10"}
CIFAR_TRAIN, CIFAR_TEST = 50_000, 10_000
DATA_TRAINER_ITERS = 6  # path A, synthetic 224 px data, AutoAugment and remat on
FOLDER_ITERS = 4  # path A from a JPEG folder
# path A's remat_skip_blocks beside remat over every block
REMAT_SKIP = 2


def remat_launches(path: str, n_rematted: int, n_pass: int) -> dict:
    """Launches per step of ``path`` under remat: the step's own (once per
    pass: the cross-attention and each block), and the serving forward's
    kernels again for each of the ``n_rematted`` recomputed passes (the
    QK-norm prologue runs before every forward)."""
    want = per_pass(PATHS[path]["step"], n_pass)
    for name, count in per_pass(PATHS[path]["forward"], n_rematted).items():
        want[name] = want.get(name, 0) + count
    return want


def profile_config(name: str, **env):
    """(config, variables) of ``python -m nvit_tpu_torch`` with
    profiles/<name>.env and ``env``, run from a directory with no
    settings.yaml, .env or secrets.yaml of its own: the packaged settings."""
    import os

    import nvit_tpu_torch.configs
    from nvit_tpu_torch.configs import load_config, read_dotenv

    env = {**read_dotenv(Path(__file__).resolve().parent / "profiles" / f"{name}.env"), **env}
    settings = Path(nvit_tpu_torch.configs.__file__).parent / "settings.yaml"
    return load_config(settings, dotenv_path=os.devnull, secrets_file=os.devnull, env=env), env


def profile_shapes() -> tuple[tuple, list]:
    """The shapes the profiles' step gives the kernels (a profile changes
    no width): attention [B, H, T, D] — the blocks' and the
    cross-attention's, whose local and global streams both have T tokens —
    and the gated GEMMs (n, K, hidden, what): c_fc and the cross-attention's
    proj."""
    cfg, _ = profile_config("nvit1_k0")
    m, b = cfg.model, cfg.training.batch_size
    n = b * m.n_patches
    return ((b, m.n_head, m.n_patches, m.head_dim),
            [(n, m.n_embd, 4 * m.n_embd, "profile c_fc"), (n, m.n_embd, m.n_embd, "profile proj")])


def profile_step(name: str, cfg, smi: str) -> dict:
    """One training step of a profile's config in this process, at its
    batch from the CIFAR-100 files through the pipeline, AutoAugment and
    remat, with every count set to 0 just before → its launches, checked
    against the path's under remat; then its step time."""
    from nvit_tpu_torch.data.augment import preprocess
    from nvit_tpu_torch.data.autoaugment import step_generator
    from nvit_tpu_torch.data.datasets import load_dataset
    from nvit_tpu_torch.data.pipeline import device_prefetch, make_epoch_iterator
    from nvit_tpu_torch.scripts.step_time import step_ms, sync_step
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_train_step
    from nvit_tpu_torch.train.trainer import check_ported

    m, d, tc = cfg.model, cfg.data, cfg.training
    aug = d.augmentation.enabled and d.augmentation.auto_augment
    check(cfg.system.remat and aug and m.bias and tc.batch_size == 512 and m.image_size == 32,
          f"{name}: the profile's config drifted")
    check_ported(cfg)
    ds = load_dataset(d.dataset, d.data_dir, train=True, image_size=m.image_size, num_classes=m.num_classes)
    batches = device_prefetch(make_epoch_iterator(ds, batch_size=tc.batch_size, epoch=0, seed=tc.seed,
                                                  shuffle=True, num_workers=d.num_workers), "cuda", size=d.prefetch)
    imgs_u8, labels = next(batches)
    batches.close()
    state = create_train_state(cfg, device="cuda")
    images = preprocess(imgs_u8, step_generator(state.rng, 0), train=True, dataset=d.dataset, auto_augment=aug)
    step = make_train_step(cfg, log_norms=False)
    reset_counts()
    sync_step(step, state, images, labels)
    launches = read_counts()
    path = "nvit-bias" if m.use_nvit else "baseline-bias"
    n_pass = n_passes(m)
    launched = {k: v for k, v in launches.items() if v}
    print(f"  {name} in this process, one step at batch {tc.batch_size} ({path} kernels, remat over "
          f"{n_pass - cfg.system.remat_skip_blocks} of {n_pass} passes): launches {launched}")
    check_launches(launches, remat_launches(path, n_pass - cfg.system.remat_skip_blocks, n_pass),
                   f"{name}: one step")
    ms = step_ms(step, state, images, labels, 5)
    print(f"  {name} step alone (host clock, median of 5, after the counted one): {ms:.3f} ms, "
          f"{tc.batch_size * 1e3 / ms:.0f} img/s [{smi}]")
    del state, step, images
    torch.cuda.empty_cache()
    return launches


def write_cifar100(root: Path, seed: int) -> None:
    """A CIFAR-100 python-format tree (``cifar-100-python/train`` and
    ``test``): class-structured images from ``make_synthetic``."""
    import pickle

    from nvit_tpu_torch.data.datasets import make_synthetic

    base = root / "cifar-100-python"
    base.mkdir(parents=True)
    for split, n, s in (("train", CIFAR_TRAIN, seed), ("test", CIFAR_TEST, seed + 1)):
        d = make_synthetic(num_examples=n, image_size=32, num_classes=100, seed=s)
        (base / split).write_bytes(pickle.dumps({
            b"data": d.images.reshape(n, 3072), b"fine_labels": d.labels.tolist(),
            b"coarse_labels": (d.labels // 5).tolist()}, protocol=4))


def write_jpeg_folder(root: Path, classes: int, per_class: dict, seed: int) -> None:
    """``<root>/imagenet/<split>/n<class>/*.JPEG``, 320×256 class-coloured noise."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    tints = rng.integers(0, 256, (classes, 3))
    for split, n in per_class.items():
        for c in range(classes):
            folder = root / "imagenet" / split / f"n{c:08d}"
            folder.mkdir(parents=True)
            for i in range(n):
                px = np.clip(tints[c] + rng.integers(-60, 60, (256, 320, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(px).save(folder / f"img_{i:04d}.JPEG", quality=90)


def data_trainer(cfg, out_dir: Path, **data) -> tuple[list, list]:
    """Trainer.train() on ``cfg`` with ``data`` settings → (its logged
    lines, its eval lines); checks the finished sentinel."""
    from nvit_tpu_torch.train.trainer import Trainer

    trainer = Trainer(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, out_dir=str(out_dir), **data)),
                      device="cuda")
    trainer.train()
    lines = [json.loads(x) for x in (out_dir / "metrics.jsonl").read_text().splitlines()]
    iters = cfg.training.max_iters
    check((out_dir / "finished").read_text() == f"max_iters:{iters}", "no finished sentinel")
    del trainer
    torch.cuda.empty_cache()
    return [x for x in lines if "train/batch_loss" in x], [x for x in lines if "val/loss" in x]


def data_phase(smi: str) -> dict:
    """Phase 11: the data path.  (a) ``python -m nvit_tpu_torch`` with
    profiles/nvit1_k0.env and nvit0_k0.env on the packaged settings.yaml
    (batch 512, 32 px, AutoAugment, remat, num_workers 4, prefetch 2) from
    CIFAR-100 python-format files, 60 iterations; nvit1_k1.env refused
    naming Kohonen.  (b) path A at full width under remat against no remat
    (loss and gradients, step ms, peak memory, launches), AutoAugment's ms,
    its determinism, and Trainer.train() through make_epoch_iterator and
    device_prefetch with AutoAugment and remat.  (c) path A from a JPEG
    folder through iterate_folder → path A's launches under remat."""
    import shutil
    import tempfile

    from nvit_tpu_torch.data import native
    from nvit_tpu_torch.data.autoaugment import auto_augment_batch, step_generator
    from nvit_tpu_torch.data.datasets import load_imagenet, make_synthetic
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.scripts.step_time import step_ms, sync_step
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_loss_fn, make_train_step

    phase("data: CIFAR-100 files through the CLI's profiles, path A under remat and AutoAugment, "
          "an ImageNet folder")
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    route = native.route()
    print(f"host loader route: {route} (native = the g++ build of native/nvit_loader.cpp; python = "
          f"numpy gather and PIL decode, where it cannot build)")
    try:
        # (a) the profiles as users run them
        t0 = time.perf_counter()
        write_cifar100(root / "data", seed=5)
        print(f"wrote cifar-100-python ({CIFAR_TRAIN} + {CIFAR_TEST} images) in {time.perf_counter() - t0:.1f} s")
        profiles = {}
        for name in ("nvit1_k0", "nvit0_k0", "nvit1_k1"):
            out = root / f"out_{name}"
            cfg, env = profile_config(name, NVIT_DATA__DATA_DIR=str(root / "data"), NVIT_DATA__OUT_DIR=str(out),
                                      **PROFILE_OVERRIDES)
            profiles[name] = profile_step(name, cfg, smi)
            print(f"python -m nvit_tpu_torch, profiles/{name}.env, overrides: " +
                  " ".join(f"{k}={v}" for k, v in env.items() if not k.startswith("NVIT_WANDB")))
            t0 = time.perf_counter()
            lines = Cli(["nvit_tpu_torch"], env, root, f"python -m nvit_tpu_torch ({name})").run(timeout=600)
            seconds = time.perf_counter() - t0
            metrics = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
            logs = [x for x in metrics if "train/batch_loss" in x]
            evals = [x for x in metrics if "val/loss" in x]
            loaded = [x for x in lines if "native loader" in x or "datasets:" in x]
            for x in loaded:
                print(f"  {x.split(' - ')[-1]}")
            for x in logs:
                print(f"  iter {x['train/iter']}: loss {x['train/batch_loss']:.4f}, "
                      f"{x['train/batch_time_ms']:.1f} ms ({512e3 / x['train/batch_time_ms']:.0f} img/s), "
                      f"data wait {x['train/data_wait_ms']:.2f} ms [{smi}]")
            for x in evals:
                som = ", ".join(f"{k} {x[f'val/{k}']:.4f}" for k in KOHONEN_VAL if f"val/{k}" in x)
                print(f"  eval at {x['_step']}: val/loss {x['val/loss']:.4f}, top-1 "
                      f"{x['val/top1_accuracy']:.2f}{', ' + som if som else ''}")
            finished = (out / "finished").read_text()
            print(f"  {name}: exit 0 in {seconds:.1f} s (process included); finished: {finished}")
            check([x["train/iter"] for x in logs] == list(range(10, 61, 10)), f"{name}: unexpected logged steps")
            check(all(math.isfinite(x["train/batch_loss"]) for x in logs), f"{name}: non-finite loss")
            check(logs[-1]["train/batch_loss"] < logs[0]["train/batch_loss"], f"{name}: the loss did not fall")
            check(finished == "max_iters:60", f"{name}: finished reads {finished!r}")
            check(cfg.model.use_kohonen == (name == "nvit1_k1")
                  and all(math.isfinite(x[f"val/{k}"]) for x in evals for k in KOHONEN_VAL if cfg.model.use_kohonen),
                  f"{name}: the Kohonen setting or its validation terms")

        # (b) path A at full width under remat
        cfg = flagship_config(bias=True)
        check(cfg.training.batch_size == 32 and cfg.model.image_size == 224, "path A's config drifted")
        sys_remat = dataclasses.replace(cfg.system, remat=True)
        remat_cfg = dataclasses.replace(cfg, system=sys_remat)
        skip_cfg = dataclasses.replace(cfg, system=dataclasses.replace(sys_remat, remat_skip_blocks=REMAT_SKIP))
        _, images, labels = batch32(cfg.model)
        state = create_train_state(cfg, seed=0, device="cuda")
        randomize_biases(state.model, seed=1)
        grads, losses = {}, {}
        for name, c in (("no remat", cfg), ("remat", remat_cfg)):
            loss, _ = make_loss_fn(c)(state.model, images, labels)
            loss.backward()
            losses[name] = loss.detach()
            grads[name] = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
            state.model.zero_grad(set_to_none=True)
        same = torch.equal(losses["remat"], losses["no remat"]) and set(grads["remat"]) == set(grads["no remat"]) \
            and all(torch.equal(grads["remat"][n], g) for n, g in grads["no remat"].items())
        print(f"path A, remat against no remat, same weights and batch: loss {losses['remat'].item():.6f} / "
              f"{losses['no remat'].item():.6f}; loss and all {len(grads['remat'])} gradients bit-equal: {same}")
        check(same, "remat changed the loss or a gradient")
        del grads
        n_pass = n_passes(cfg.model)
        counted = {}
        for name, c, rematted in (("remat", remat_cfg, n_pass), (f"remat_skip_blocks={REMAT_SKIP}", skip_cfg,
                                                               n_pass - REMAT_SKIP), ("no remat", cfg, 0)):
            step = make_train_step(c, log_norms=False)
            sync_step(step, state, images, labels)  # warm
            reset_counts()
            sync_step(step, state, images, labels)
            counted[name] = {k: v for k, v in read_counts().items() if v}
            print(f"launches in one path A step, {name}: {counted[name]}")
            want = remat_launches("nvit-bias", rematted, n_pass)
            check_launches(read_counts(), want, f"one path A step, {name}")
        steps = {"no remat": make_train_step(cfg, log_norms=False), "remat": make_train_step(remat_cfg, log_norms=False)}
        peak, got = {}, {"no remat": [], "remat": []}
        for name, fn in steps.items():
            torch.cuda.reset_peak_memory_stats()
            sync_step(fn, state, images, labels)
            peak[name] = torch.cuda.max_memory_allocated() / 2**30
        for name in ("no remat", "remat", "remat", "no remat"):
            got[name].append(step_ms(steps[name], state, images, labels, 3))
        for name in ("no remat", "remat"):
            print(f"path A train step, {name}: {statistics.mean(got[name]):.3f} ms (runs "
                  f"{', '.join(f'{x:.3f}' for x in got[name])}), peak memory {peak[name]:.3f} GiB [{smi}]")
        check(peak["remat"] < peak["no remat"], "remat did not lower the step's peak memory")
        del steps, state
        torch.cuda.empty_cache()

        # AutoAugment on the card: ms per batch, determinism
        aug = {}
        rng_key = np.array([0, 42], np.uint32)
        for dataset, shape in (("imagenet", (32, 3, 224, 224)), ("cifar100", (512, 3, 32, 32))):
            u8 = torch.from_numpy(make_synthetic(num_examples=shape[0], image_size=shape[-1], num_classes=10,
                                                 seed=3).images).cuda()
            a = auto_augment_batch(u8, step_generator(rng_key, 7), dataset=dataset)
            b = auto_augment_batch(u8, step_generator(rng_key, 7), dataset=dataset)
            c = auto_augment_batch(u8, step_generator(rng_key, 8), dataset=dataset)
            step_no = iter(range(10**6))
            ms = cuda_ms(lambda: auto_augment_batch(u8, step_generator(rng_key, next(step_no)), dataset=dataset),
                         iters=20)
            host = host_ms(lambda: (auto_augment_batch(u8, step_generator(rng_key, next(step_no)),
                                                       dataset=dataset), torch.cuda.synchronize()), 20)
            changed = (a != u8).flatten(1).any(1).float().mean().item()
            aug[dataset] = ms
            print(f"AutoAugment {dataset} policy at {list(shape)}: {ms:.3f} ms per batch (CUDA events, median "
                  f"of 20), {host:.3f} ms host clock with a sync; same (rng, step) bit-equal: {torch.equal(a, b)}; "
                  f"another step differs: {not torch.equal(a, c)}; images changed {changed:.2f} [{smi}]")
            check(torch.equal(a, b) and not torch.equal(a, c), f"AutoAugment ({dataset}) is not keyed by the step")
            check(a.dtype == torch.uint8 and a.shape == u8.shape, "AutoAugment changed the batch's shape or dtype")

        # Trainer.train() with remat and AutoAugment through the prefetch
        tcfg = dataclasses.replace(
            remat_cfg,
            training=dataclasses.replace(cfg.training, max_iters=DATA_TRAINER_ITERS, eval_interval=100,
                                         log_interval=1, eval_iters=1, always_save_checkpoint=False),
            system=dataclasses.replace(sys_remat, quick_validation_size=32))
        torch.cuda.reset_peak_memory_stats()  # the logged peak is this Trainer's own
        reset_counts()
        t0 = time.perf_counter()
        logs, evals = data_trainer(tcfg, root / "trainer_remat", dataset="synthetic")
        seconds = time.perf_counter() - t0
        trainer_counts = read_counts()
        for x in logs:
            print(f"  iter {x['train/iter']}: loss {x['train/batch_loss']:.4f}, {x['train/batch_time_ms']:.1f} ms, "
                  f"data wait {x['train/data_wait_ms']:.3f} ms, max mem "
                  f"{x.get('system/device_0/max_mem_allocated_gb')} GiB [{smi}]")
        waits = [x["train/data_wait_ms"] for x in logs[1:]]
        print(f"Trainer.train(), path A, remat and AutoAugment, synthetic 224 px: {DATA_TRAINER_ITERS} iterations "
              f"in {seconds:.1f} s; the loop's wait for a prefetched batch after the first: median "
              f"{statistics.median(waits):.3f} ms, max {max(waits):.3f} ms [{smi}]; launches {trainer_counts}")
        trainer_peak = max(x["system/device_0/max_mem_allocated_gb"] for x in logs)
        print(f"the remat Trainer's peak device memory {trainer_peak:.3f} GiB against the step's "
              f"{peak['remat']:.3f} under remat and {peak['no remat']:.3f} without [{smi}]")
        check(len(logs) == DATA_TRAINER_ITERS and all(math.isfinite(x["train/batch_loss"]) for x in logs),
              "the remat Trainer logged no finite losses")
        check(trainer_peak < peak["no remat"], "the remat Trainer peaked as high as a step without remat")
        check(trainer_counts["qknorm_attn_bwd"] == DATA_TRAINER_ITERS * n_pass
              and trainer_counts["gated_mlp_bwd_bias"] == DATA_TRAINER_ITERS * n_pass,
              "the remat Trainer's backward launches are off")

        # (c) the ImageNet folder path
        write_jpeg_folder(root / "data", classes=4, per_class={"train": 40, "val": 8}, seed=6)
        ds = load_imagenet(root / "data", split="train", image_size=224)
        idx = np.arange(32)
        decode_ms = host_ms(lambda: ds.decode_batch(idx), 3)
        print(f"ImageNet folder ({len(ds)} JPEGs, 320x256, 4 classes): decode of a batch of 32 at 224 px "
              f"{decode_ms:.1f} ms (host clock, median of 3), decoder route {route}")
        fcfg = dataclasses.replace(tcfg, model=dataclasses.replace(cfg.model, num_classes=4),
                                   training=dataclasses.replace(tcfg.training, max_iters=FOLDER_ITERS))
        reset_counts()
        t0 = time.perf_counter()
        logs, evals = data_trainer(fcfg, root / "trainer_folder", dataset="imagenet",
                                   data_dir=str(root / "data"), num_workers=4, prefetch=2)
        seconds = time.perf_counter() - t0
        folder_counts = read_counts()
        for x in logs:
            print(f"  iter {x['train/iter']}: loss {x['train/batch_loss']:.4f}, {x['train/batch_time_ms']:.1f} ms, "
                  f"data wait {x['train/data_wait_ms']:.3f} ms [{smi}]")
        print(f"Trainer.train() from the folder: {FOLDER_ITERS} iterations in {seconds:.1f} s; val/loss at 0 "
              f"{evals[0]['val/loss']:.4f}; launches {folder_counts}")
        check(len(logs) == FOLDER_ITERS and all(math.isfinite(x["train/batch_loss"]) for x in logs),
              "the folder Trainer logged no finite losses")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"remat": counted, "aug_ms": aug, "profiles": profiles}


# the Kohonen phase: the SOM's parameters as gradient groups of their own,
# and the reconstruction head, whose loss term only Kohonen weighs in
KOHONEN_GROUPS = {"local_kohonen.nodes": r"local_kohonen\.nodes", "global_kohonen.nodes": r"global_kohonen\.nodes",
                  "reconstruction head": r"reconstruction_head\..+"}
# fp32 outside the tensor cores (NVIDIA's data sheet, H100 SXM): the SOM's
# fp32 products' peak
PEAK_FP32_FLOPS = 67e12


def som_times(model, images, smi: str) -> None:
    """Prints the CUDA-event ms of the SOM work of one batch-32 step for
    one map (a step runs it for both): the BMU search (fp32 distances of the
    bf16-rounded operands, argmin, gather), its backward (the one-hot
    product into the nodes) and the Hebbian delta, each beside its bound
    (fp32 products over the fp32 peak, or bytes)."""
    from nvit_tpu_torch.som.kohonen import bmu, hebbian_delta, neighborhood_kernel

    with torch.no_grad():
        local, _ = model.embed_patches(images, compute_dtype=torch.bfloat16)
    som = model.local_kohonen
    spec, nodes = som.spec, som.nodes.detach()
    kernel = neighborhood_kernel(spec, nodes.device)
    lr = torch.tensor(1e-3, device="cuda")
    s, n, d = local.shape[0] * local.shape[1], spec.num_nodes, local.shape[-1]
    with torch.no_grad():
        _, idx = bmu(nodes, local)
    leaf = nodes.clone().requires_grad_()
    rep, _ = bmu(leaf, local)
    cot = torch.randn_like(rep)
    product = 2.0 * s * n * d  # one [S, N] × [N or S, d] product
    work = {  # name → (fn, fp32 products' operations, bytes in and out once)
        "bmu": (lambda: bmu(nodes, local), product, 2 * s * d + 4 * n * d + 8 * s + 2 * s * d),
        "bmu_backward": (lambda: torch.autograd.grad(rep, leaf, cot, retain_graph=True), product,
                         2 * s * d + 8 * s + 4 * n * d),
        "hebbian_delta": (lambda: hebbian_delta(nodes, kernel, local, idx, lr, spec.alpha),
                          product + 2.0 * n * n * d, 2 * s * d + 8 * s + 4 * n * n + 8 * n * d),
    }
    total = 0.0
    for name, (fn, flops, nbytes) in work.items():
        ms = cuda_ms(fn)
        total += 2 * ms
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
        print(f"SOM {name}, one map at [S={s}, N={n}, d={d}]: {ms:.4f} ms (CUDA events, median of 20), "
              f"bound {max(t_ops, t_bytes) * 1e3:.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}, "
              f"fp32 peak {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s) [{smi}]")
    print(f"SOM work of one step, both maps: {total:.3f} ms")


def kohonen_phase(smi: str) -> dict:
    """Phase 12: the Kohonen flagship, ``flagship_config(use_kohonen=True,
    kohonen_nodes=512)`` — nViT-B/16 with two 256-node maps on a 16×16
    torus, Hebbian "reference" — served over HTTP (K1, K3 and the prologue
    15 times a forward), its BMU indices and Hebbian deltas bit-equal on
    the kernel and plain paths, its SOM work timed, then trained like the
    other full paths (train_phase: K1–K4 15 times a step, the prologue 30,
    the nodes' gradients against the plain path among the groups) →
    {"served": launches, "stepped": launches}."""
    import gc

    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.models.vit import ViT, kohonen_spec

    cfg = flagship_config(use_kohonen=True, kohonen_nodes=512)
    m = cfg.model
    spec = kohonen_spec(m)
    check(m.n_embd == 768 and m.n_layer == 12 and not m.bias and m.bounded_softmax == "rowmax"
          and m.kohonen_hebbian == "reference" and (spec.m, spec.n) == (16, 16) and n_passes(m) == 15,
          "the Kohonen flagship's config drifted")
    title = "nViT-B/16 with its 512-node Kohonen SOM"
    pred = Predictor.from_config(cfg, seed=0, device="cuda")
    plain_cfg = dataclasses.replace(m, flash_attn=False, gated_mlp_kernel="off")
    plain_model = ViT(plain_cfg, device="cuda")
    plain_model.load_state_dict(pred.model.state_dict(), strict=True)
    plain = Predictor(plain_model, plain_cfg, device="cuda")
    served = serve_phase(title, "nvit-kohonen", cfg, pred, plain)

    # both paths read the same embeddings: the same BMUs and deltas, bit for bit
    _, images, _ = batch32(m)
    with torch.no_grad():
        _, aux_k, som_k = pred.model.forward_train(images, step=1500, compute_dtype=torch.bfloat16)
        _, aux_p, som_p = plain.model.forward_train(images, step=1500, compute_dtype=torch.bfloat16)
    keys = {"local_indices", "global_indices", "local_delta", "global_delta"}
    same = set(som_k) == set(som_p) == keys and all(torch.equal(som_k[k], som_p[k]) for k in keys)
    used = {k: int(torch.unique(som_k[k]).numel()) for k in ("local_indices", "global_indices")}
    print(f"batch 32, step 1500: BMU indices and Hebbian deltas bit-equal on the kernel and plain paths: "
          f"{same}; nodes in use {used} of {spec.num_nodes}; max|delta| "
          f"{som_k['local_delta'].abs().max().item():.3e} / {som_k['global_delta'].abs().max().item():.3e}")
    print("aux terms, kernel / plain path: " + ", ".join(
        f"{k} {aux_k[k].item():.5f} / {aux_p[k].item():.5f}" for k in sorted(aux_k)))
    check(same, "the kernel and plain paths disagree on the BMUs or the Hebbian deltas")
    check(all(math.isfinite(v.item()) for v in (*aux_k.values(), *aux_p.values())), "non-finite aux term")
    som_times(pred.model, images, smi)
    del pred, plain, plain_model, som_k, som_p
    gc.collect()
    torch.cuda.empty_cache()
    stepped = train_phase(smi, title, "nvit-kohonen", cfg, {**GRAD_GROUPS, **KOHONEN_GROUPS})
    gc.collect()
    torch.cuda.empty_cache()
    return {"served": served, "stepped": stepped}


# the training settings phase: bf16 moments, observability, reference .pt interop
SETTINGS_STEPS = 10  # steps of each moment storage against the others
BF16_LOSS_RTOL = 0.01  # the bf16-moment runs' final loss against the fp32 run's
# the trace must hold the path's kernels: K1, K2 (both walks), K3, K4 and the prologue
TRACE_KERNELS = ("qknorm_attn_fwd_kernel", "qknorm_attn_bwd_dkv_kernel", "qknorm_attn_bwd_dq_kernel",
                 "gated_mlp_fwd_kernel", "gated_mlp_bwd_kernel", "qknorm_project_kernel")


def device_launches(fn) -> int:
    """Kernels and copies the card runs in ``fn`` (torch.profiler's device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and "Command Buffer Full" not in ev.key)


def recording_wandb(calls: dict, download_dir: Path):
    """A stand-in ``wandb`` module that records what the port sends it (the
    card's machine has no wandb package)."""
    import types

    mod = types.ModuleType("wandb")
    mod.login = lambda key=None: calls["login"].append(key)
    mod.init = lambda **kw: calls["init"].append(kw)
    mod.log = lambda metrics, step=None: calls["log"].append((step, metrics))
    mod.finish = lambda: calls["finish"].append(True)
    mod.Histogram = lambda np_histogram: types.SimpleNamespace(np_histogram=np_histogram)

    class Artifact:
        def __init__(self, name, type, metadata=None):
            self.name, self.files = name, []

        def add_file(self, path):
            self.files.append(Path(path))

    mod.Artifact = Artifact
    mod.log_artifact = lambda a: calls["artifacts"].append(
        (a.name, [f.name for f in a.files], [f.stat().st_size for f in a.files]))
    class Api:
        def artifact(self, name, type=None):
            calls["requested"].append(name)
            return types.SimpleNamespace(download=lambda: str(download_dir),
                                         delete=lambda: calls["deleted"].append(name))

    mod.Api = Api
    mod.run = types.SimpleNamespace(entity="chip", project="smoke")
    return mod


def settings_phase(smi: str) -> dict:
    """Phase 13: the trainer's single-card settings at nViT-B/16 full width
    (flagship_config(): batch 32, bf16, synthetic data) → the launches of one
    bf16-moment training step."""
    import shutil
    import tempfile

    from nvit_tpu_torch.ckpt.checkpoint import restore_for_resume, save_checkpoint, state_leaves
    from nvit_tpu_torch.ckpt.convert import jax_path
    from nvit_tpu_torch.configs import AugmentationConfig
    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.models.vit import ViT
    from nvit_tpu_torch.obs.grad_hist import MAX_ELEMS
    from nvit_tpu_torch.obs.metrics import MetricsWriter
    from nvit_tpu_torch.obs.profiling import start_trace, stop_trace
    from nvit_tpu_torch.scripts.step_time import step_ms, sync_step
    from nvit_tpu_torch.train import optim
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_train_step
    from nvit_tpu_torch.train.trainer import Trainer

    phase("training settings nViT-B/16 (flagship_config: batch 32, bf16): bf16 moments with stochastic "
          "rounding, gradient histograms, the trace window, wandb, the NaN sanitizer, reference .pt interop")
    t_phase = time.perf_counter()
    base = flagship_config()
    m = base.model
    check(m.use_nvit and not m.use_kohonen and m.n_embd == 768 and base.training.batch_size == 32,
          "the flagship config drifted")
    want = per_pass(PATHS["nvit"]["step"], n_passes(m))
    u8, images, labels = batch32(m)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_settings_"))

    def with_opt(cfg, **kw):
        return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, **kw))

    # one leaf of each layout class (a linear, both patch embeds, 1-D, 0-D):
    # the store on the card bit-equal to the store on the CPU, both dithers
    d, c, lp, gp = m.n_embd, m.channels, m.local_patch_size, m.global_patch_size
    leaves = [("transformer.h.0.query.weight", (d, d)), ("local_patch_embed.weight", (d, c, lp, lp)),
              ("global_patch_embed.1.weight", (d, c, gp, gp)), ("sz", (m.num_classes,)), ("map_balance", ())]
    gen = torch.Generator().manual_seed(13)
    special = torch.tensor([math.inf, -math.inf, math.nan, 0.99999994, 3.4028235e38, 0.0])
    for dither in ("hash", "threefry"):
        ocfg = dataclasses.replace(base.optimizer, moments_dtype="bfloat16", sr_dither=dither)
        for name, shape in leaves:
            x = torch.randn(shape, generator=gen) * 1e-3
            if x.numel() > special.numel():
                x.view(-1)[:special.numel()] = special
            got = {dev: optim.sr_store(ocfg, 7, name, optim.jax_index(name, shape, lp, dev))(x.to(dev), 1)
                   for dev in ("cpu", "cuda")}
            same = torch.equal(got["cpu"].view(torch.int16), got["cuda"].cpu().view(torch.int16))
            check(same, f"SR store ({dither}) of {name} {tuple(shape)}: the card differs from the CPU")
    print(f"SR stores of {len(leaves)} leaves (a linear, both patch embeds, 1-D, 0-D; ±inf, NaN, a carry, "
          "the largest float), hash and threefry: the card bit-equal to the CPU")

    # ten steps each: fp32 moments, bf16 hash, bf16 threefry, from the same weights
    cfg0 = with_opt(base, warmup_iters=0)
    runs = {}
    for label, kw in (("fp32", dict(moments_dtype="float32")),
                      ("bf16 hash", dict(moments_dtype="bfloat16", sr_dither="hash")),
                      ("bf16 threefry", dict(moments_dtype="bfloat16", sr_dither="threefry"))):
        cfg = with_opt(cfg0, **kw)
        state = create_train_state(cfg, seed=1, device="cuda")
        step = make_train_step(cfg, log_norms=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(SETTINGS_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(state, images, labels)[1]["total_loss"]))  # ends in a sync
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        reset_counts()
        sync_step(step, state, images, labels)
        counts = read_counts()
        check_launches(counts, want, f"one training step, {label} moments")
        dev = device_launches(lambda: sync_step(step, state, images, labels))
        runs[label] = dict(loss=losses[-1], ms=statistics.median(times[2:]), peak=peak, device_launches=dev,
                           counts=counts, moments_gib=sum(t.numel() * t.element_size() for t in (
                               *state.opt_state.mu.values(), *state.opt_state.nu.values())) / 2**30)
        print(f"{label} moments, {SETTINGS_STEPS} steps on one batch: loss {losses[0]:.5f} → {losses[-1]:.5f}; "
              f"step {runs[label]['ms']:.3f} ms (median of steps 3–{SETTINGS_STEPS}; "
              f"{', '.join(f'{t:.1f}' for t in times)}); peak {peak:.3f} GiB; moments "
              f"{runs[label]['moments_gib']:.3f} GiB; {dev} device launches a step [{smi}]")
        if label == "fp32":
            # the trace window's cost: three steps untraced, then three traced
            plain_ms = step_ms(step, state, images, labels, 3)
            prof = start_trace(root / "trace_cost", torch.device("cuda"))
            traced_ms = step_ms(step, state, images, labels, 3)
            t0 = time.perf_counter()
            stop_trace(prof)
            runs["trace"] = dict(plain=plain_ms, traced=traced_ms, write_s=time.perf_counter() - t0)
            print(f"trace window: a step {traced_ms:.3f} ms traced against {plain_ms:.3f} ms untraced; "
                  f"writing the trace {runs['trace']['write_s']:.2f} s [{smi}]")
        del state, step
        torch.cuda.empty_cache()
    for label in ("bf16 hash", "bf16 threefry"):
        r, f = runs[label], runs["fp32"]
        rel = abs(r["loss"] - f["loss"]) / abs(f["loss"])
        print(f"{label} against fp32 moments: final loss rel. diff {rel:.2e} (bound {BF16_LOSS_RTOL}); step "
              f"{r['ms'] - f['ms']:+.3f} ms ({r['ms'] / f['ms'] - 1:+.1%}); peak {r['peak'] - f['peak']:+.3f} GiB; "
              f"device launches {r['device_launches'] - f['device_launches']:+d} a step [{smi}]")
        check(math.isfinite(r["loss"]) and rel <= BF16_LOSS_RTOL, f"{label}: the loss left fp32's")

    # save after 2 steps, restore, 2 more: bit-equal to 4 straight steps
    cfgh = with_opt(cfg0, moments_dtype="bfloat16", sr_dither="hash")
    step = make_train_step(cfgh, log_norms=False)
    batches = [(images.roll(k, 0), labels.roll(k, 0)) for k in range(4)]
    state = create_train_state(cfgh, seed=2, device="cuda")
    for b in batches:
        step(state, *b)
    straight = state_leaves(state)
    state = create_train_state(cfgh, seed=2, device="cuda")
    for b in batches[:2]:
        step(state, *b)
    save_checkpoint(root / "half", "checkpoint_latest", state, cfgh)
    del state
    state, _, _ = restore_for_resume(root / "half", "checkpoint_latest", device="cuda")
    check(all(t.dtype == torch.bfloat16 for t in state.opt_state.mu.values()), "the restore lost the bf16 moments")
    for b in batches[2:]:
        step(state, *b)
    resumed = state_leaves(state)
    del state, step
    torch.cuda.empty_cache()
    differ = [i for i, (x, y) in enumerate(zip(straight, resumed)) if x.dtype != y.dtype or x.tobytes() != y.tobytes()]
    n_bf16 = sum(x.dtype.kind == "V" for x in straight)
    print(f"bf16 moments, save after 2 steps and resume for 2 against 4 straight: {len(straight)} leaves "
          f"({n_bf16} bf16), {len(differ)} differ")
    check(len(straight) == len(resumed) == 459 and n_bf16 == 304 and not differ,
          "the resumed bf16-moment run is not bit-equal to the straight run")

    # the NaN sanitizer: raises on a NaN input; launches as without it
    cfgn = dataclasses.replace(base, system=dataclasses.replace(base.system, debug_nans=True))
    state = create_train_state(cfgn, seed=3, device="cuda")
    step = make_train_step(cfgn, log_norms=False)
    reset_counts()
    sync_step(step, state, images, labels)
    check_launches(read_counts(), want, "one training step under debug_nans")
    bad = images.clone()
    bad[0, 0, 5, 7] = math.nan
    try:
        step(state, bad, labels)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    print(f"debug_nans on a step with a NaN input: {raised}")
    check(raised is not None, "debug_nans did not raise on a NaN input")
    del state, step
    torch.cuda.empty_cache()

    # Trainer.train(): bf16 moments, histograms, the trace window, wandb offline (stand-in)
    calls = {k: [] for k in ("login", "init", "log", "finish", "artifacts", "requested", "deleted")}
    out = root / "run"
    saved_wandb = sys.modules.get("wandb")
    sys.modules["wandb"] = recording_wandb(calls, out)
    try:
        tcfg = dataclasses.replace(
            with_opt(base, moments_dtype="bfloat16"),
            training=dataclasses.replace(base.training, max_iters=4, eval_interval=2, eval_iters=1, log_interval=1,
                                         always_save_checkpoint=True),
            system=dataclasses.replace(base.system, quick_validation_size=32, log_grad_histograms=True,
                                       profile_steps=2),
            wandb=dataclasses.replace(base.wandb, mode="offline", run_name="chip_smoke"),
            data=dataclasses.replace(base.data, dataset="synthetic", out_dir=str(out), checkpoint_dir=str(out),
                                     augmentation=AugmentationConfig(auto_augment=False)))
        trainer = Trainer(tcfg, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        trainer.train()
        train_s = time.perf_counter() - t0
        counts = read_counts()
        print(f"Trainer.train(), 4 iterations (evals at 0 and 2): {train_s:.1f} s; launches {counts}")
        for name in PATHS["nvit"]["step"]:
            check(counts[name] >= 4 * want[name], f"Trainer: {name} launched {counts[name]} times")
        traces = list((out / "profile").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"{len(traces)} trace files under out_dir/profile")
        text = traces[0].read_text()
        missing = [k for k in TRACE_KERNELS if k not in text]
        print(f"trace {traces[0].name}: {traces[0].stat().st_size} bytes; the path's kernels missing: {missing}")
        check(not missing, f"the trace lacks {missing}")
        lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        numel = {"gradhist/" + ".".join(map(str, jax_path(n))): p.numel()
                 for n, p in trainer.state.model.named_parameters()}
        with_hist = [x for x in lines if any(k.startswith("gradhist/") for k in x)]
        check([x["_step"] for x in with_hist] == [2], "gradhist/* not logged at the eval of iteration 2 alone")
        hists = {k: v for k, v in with_hist[0].items() if k.startswith("gradhist/")}
        kept = {k: len(range(0, n, -(-n // MAX_ELEMS))) for k, n in numel.items()}
        wrong = [k for k, v in hists.items() if len(v) != 64 or sum(v) != kept[k]]
        print(f"eval at 2: {len(hists)} gradhist/* keys; counts that do not sum to their downsampled size: {wrong}")
        check(len(hists) == 152 and set(hists) == set(numel) and not wrong, "bad gradient histograms")
        logged = [s for s, _ in calls["log"]]
        rendered = sum(hasattr(v, "np_histogram") for _, met in calls["log"] for k, v in met.items()
                       if k.startswith("gradhist/"))
        print(f"wandb stand-in: init {[(kw['mode'], kw['project']) for kw in calls['init']]}, {len(logged)} log "
              f"calls (metrics.jsonl {len(lines)} lines), {rendered} histograms, finish {len(calls['finish'])}")
        check(logged == [x["_step"] for x in lines] and rendered == 152 and len(calls["finish"]) == 1
              and not calls["login"], "the wandb stand-in did not see the run")
        trainer.metrics_writer = MetricsWriter(out, wandb_mode="offline", run_name="chip_smoke")
        calls["artifacts"].clear()
        trainer.save_best(trainer.last_metrics)
        trainer.metrics_writer.finish()
        print(f"checkpoint_best as an artifact: {calls['artifacts']}")
        check(len(calls["artifacts"]) == 1
              and calls["artifacts"][0][1] == ["checkpoint_best.npz", "checkpoint_best.json"], "no artifact")
        best = trainer.state.model.state_dict()
        del trainer
        torch.cuda.empty_cache()
        # init_from="wandb" from that artifact (online: the stand-in needs no login)
        calls["requested"].clear()  # save_best asked for the previous version to delete it
        wcfg = dataclasses.replace(tcfg, training=dataclasses.replace(tcfg.training, init_from="wandb"),
                                   wandb=dataclasses.replace(tcfg.wandb, mode="online"),
                                   data=dataclasses.replace(tcfg.data, out_dir=str(root / "from_wandb")))
        t0 = time.perf_counter()
        resumed = Trainer(wcfg, device="cuda")
        print(f"init_from=wandb: artifact {calls['requested']}, iteration {resumed.iter_num}, "
              f"{time.perf_counter() - t0:.1f} s")
        check(resumed.iter_num == 4 and calls["requested"] == [tcfg.wandb.artifact_name]
              and all(torch.equal(v, best[k]) for k, v in resumed.state.model.state_dict().items()),
              "init_from=wandb did not restore the artifact's checkpoint_best")
        del resumed, best
        torch.cuda.empty_cache()
    finally:
        if saved_wandb is None:
            sys.modules.pop("wandb", None)
        else:
            sys.modules["wandb"] = saved_wandb

    # the reference .pt: export, then import, through the CLI
    pt = root / "checkpoint_latest.pt"
    t0 = time.perf_counter()
    said = Cli(["nvit_tpu_torch.ckpt.torch_interop", "export", "--checkpoint", str(out), "--name",
                "checkpoint_latest", "--dest", str(pt)], {}, root,
               "python -m nvit_tpu_torch.ckpt.torch_interop export").run()[-1]
    export_s = time.perf_counter() - t0
    print(f"  {said}")
    t0 = time.perf_counter()
    said = Cli(["nvit_tpu_torch.ckpt.torch_interop", "import", "--pt", str(pt), "--dest", str(root / "imported"),
                "--name", "checkpoint_latest"], {}, root, "python -m nvit_tpu_torch.ckpt.torch_interop import").run()[-1]
    import_s = time.perf_counter() - t0
    print(f"  {said}")
    a, b = npz_leaves(out / "checkpoint_latest.npz"), npz_leaves(root / "imported" / "checkpoint_latest.npz")
    n = (len(a) - 3) // 3
    upcast = [(x.view(np.uint16).astype(np.uint32) << 16).view(np.float32) if x.dtype.kind == "V" else x
              for x in a]
    differ = [i for i in range(len(a) - 1) if not np.array_equal(upcast[i], b[i])]
    print(f"export {pt.name}: {pt.stat().st_size} bytes, {export_s:.1f} s; import {import_s:.1f} s (each with "
          f"its process start); {n} params, {2 * n} moments (bf16 → fp32), count, step: {len(differ)} differ [{smi}]")
    check(len(a) == len(b) == 459 and not differ and all(b[i].dtype == np.float32 for i in range(n + 1, 3 * n + 1)),
          "export then import did not give the checkpoint's params and moments back")
    ref = torch.load(pt, map_location="cpu", weights_only=False)
    unused = [k for k in ref["model"] if "rmsnorm" in k]
    check(len(unused) == 2 * m.n_layer, f"{len(unused)} rmsnorm keys in the .pt")
    model = ViT(m, device="cuda")
    model.load_state_dict({k: v for k, v in ref["model"].items() if k not in unused}, strict=True)
    with torch.inference_mode():
        x = normalize(torch.from_numpy(u8).cuda())
        got = model.eval()(x, compute_dtype=torch.bfloat16)
        want_logits = Predictor.from_checkpoint(out, "checkpoint_latest", device="cuda").model(
            x, compute_dtype=torch.bfloat16)
    print(f"the .pt's model (strict, without its {len(unused)} rmsnorm keys) against the checkpoint: logits "
          f"bit-equal {torch.equal(got, want_logits)}")
    check(torch.equal(got, want_logits), "the .pt's model gives other logits than the checkpoint")
    del model, ref
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    print(f"training settings phase: {time.perf_counter() - t_phase:.1f} s of wall time")
    return runs["bf16 hash"]["counts"]


# the serving-modes phase: int8 w8a8, AOT artifacts, serve --aot, serve_bench, the debug CLI
INT8_MEAN_DP = 0.02  # mean |Δp| of int8 against bf16 serving (≙ tests/test_quant.py:163)
INT8_LOGIT_REL = 0.08  # relative L2 of int8 logits against bf16's (≙ tests/test_quant.py:122)
AOT_TOL = dict(rtol=1e-4, atol=1e-6)  # an AOT artifact's probabilities against Predictor's
AOT_BATCH = 32
SERVE_FORWARDS = 3  # /predict at batches 1, 4 and 32
INT8_FORWARD = ("qknorm_attn_fwd", "qknorm_project")  # the int8 gated projection is unfused: no K3


def modes_forward_names(m) -> tuple:
    """The kernels one served forward of model config ``m`` launches, once a pass."""
    from nvit_tpu_torch.models.blocks import use_mlp_kernel

    arm = {"rowmax": "", "bounded": "_bounded", "auto": "_auto"}[m.bounded_softmax]
    names = (f"qknorm_attn_fwd{arm}", "qknorm_project") if m.use_nvit else ("flash_attn_fwd",)
    if use_mlp_kernel(m):
        names += ("gated_mlp_fwd_bias" if m.bias else "gated_mlp_fwd",)
    return names


def serving_modes_phase(smi: str) -> dict:
    """nViT-B/16 (flagship_config(), random weights from a seed, as a training
    checkpoint): int8 served over HTTP at batches 1, 4 and 32 against bf16
    serving; the int8 forward's time and its GEMM / elementwise split; the
    int8 export and ``from_export`` bit-equal to the in-memory quantization;
    AOT artifacts pinned at 32 (bf16, int8) and one symbolic, against
    Predictor, with their launches counted; ``serve --aot`` answering a
    request; ``serve_bench`` at 8 clients × 4 requests, bf16 and int8; the
    debug CLI on the packaged settings → launches per forward, per mode."""
    import os
    import shutil
    import tempfile
    from http.server import ThreadingHTTPServer

    from nvit_tpu_torch.ckpt.aot import export_aot, load_aot
    from nvit_tpu_torch.ckpt.checkpoint import restore_params, save_checkpoint
    from nvit_tpu_torch.ckpt.export import export_for_inference
    from nvit_tpu_torch.configs import load_config
    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.debug import debug_model
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.obs.profile_step import profile, report
    from nvit_tpu_torch.scripts import serve_bench
    from nvit_tpu_torch.serve import InferenceService, make_handler
    from nvit_tpu_torch.train.state import create_train_state

    phase("serving modes nViT-B/16: int8 w8a8, AOT artifacts, serve --aot, serve_bench, the debug CLI")
    t_phase = time.perf_counter()
    cfg = flagship_config()
    m = cfg.model
    passes = n_passes(m)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    rng = np.random.default_rng(14)
    images = {b: rng.integers(0, 256, (b, 3, m.image_size, m.image_size), dtype=np.uint8) for b in (1, 4, 32)}
    by_path = {}
    try:
        save_checkpoint(root, "ckpt", create_train_state(cfg, seed=0, device="cuda"), cfg)
        torch.cuda.empty_cache()
        ckpt_mb = (root / "ckpt.npz").stat().st_size / 1e6
        bf16 = Predictor.from_checkpoint(root, "ckpt", device="cuda")
        int8 = Predictor(bf16.model.state_dict(), m, device="cuda", quantize="int8")

        # int8 over HTTP at batches 1, 4 and 32, against bf16 serving
        service = InferenceService(int8, max_batch=32)
        service.warmup()
        server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            reset_counts()
            answers = {b: post(server.server_address, "/predict",
                               json.dumps({"images": images[b].tolist(), "top_k": m.num_classes}).encode(),
                               "application/json") for b in (1, 4, 32)}
            launches = read_counts()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
            service.close()
        print(f"int8 served at batches 1, 4, 32: launches {launches}")
        check_launches(launches, per_pass(INT8_FORWARD, passes * SERVE_FORWARDS), "serving int8")
        by_path["int8"] = {k: launches[k] // SERVE_FORWARDS for k in (*INT8_FORWARD, "gated_mlp_fwd")}
        for b, res in answers.items():
            probs = np.zeros((b, m.num_classes))
            np.put_along_axis(probs, np.asarray(res["labels"]), np.asarray(res["probs"]), axis=-1)
            want = bf16.predict_probs(images[b])
            x = normalize(torch.from_numpy(images[b]).cuda())
            with torch.inference_mode():
                rel = rel_l2(int8.model(x, compute_dtype=torch.bfloat16), bf16.model(x, compute_dtype=torch.bfloat16))
            dp = float(np.abs(probs - want).mean())
            top1 = float((probs.argmax(-1) == want.argmax(-1)).mean())
            print(f"int8 against bf16, batch {b}: mean|Δp| {dp:.3e} (bound {INT8_MEAN_DP}), logits relative L2 "
                  f"{rel:.4f} (bound {INT8_LOGIT_REL}), top-1 agreement {top1:.3f}, max p {want.max():.4f}")
            check(np.isfinite(probs).all() and np.allclose(probs.sum(-1), 1.0, atol=1e-4), f"int8 batch {b}: bad probs")
            check(dp < INT8_MEAN_DP and rel < INT8_LOGIT_REL, f"int8 batch {b} disagrees with bf16 serving")

        # the batch-32 forward, int8 against bf16: host clock, CUDA events, device time by group
        x32 = normalize(torch.from_numpy(images[32]).cuda())
        fwd = {name: (lambda p=p: p.model(x32, compute_dtype=torch.bfloat16)) for name, p in (("bf16", bf16), ("int8", int8))}
        with torch.inference_mode():
            for name in ("bf16", "int8", "int8", "bf16"):
                print(f"batch-32 forward {name}: {cuda_ms(fwd[name], iters=10):.3f} ms (CUDA events), "
                      f"predict_probs {host_ms(lambda p=(bf16 if name == 'bf16' else int8): p.predict_probs(images[32]), 10):.3f} ms "
                      f"(host clock) [{smi}]")
            for name in ("bf16", "int8"):
                report(f"batch-32 forward {name} (torch.profiler, 3 forwards)", *profile(fwd[name], 3))

        # the int8 export, and from_export bit-equal to the in-memory quantization
        t0 = time.perf_counter()
        path = export_for_inference(root, "ckpt", root / "deploy", dtype="int8")
        export_s = time.perf_counter() - t0
        served = Predictor.from_export(root / "deploy", "ckpt", device="cuda", quantize="int8")
        a, b = served.model.state_dict(), int8.model.state_dict()
        differ = [k for k in b if not bit_equal([a[k]], [b[k]])]
        print(f"int8 export: {path.stat().st_size / 1e6:.1f} MB ({export_s:.1f} s) against the checkpoint's "
              f"{ckpt_mb:.1f} MB; from_export against the in-memory quantization: {len(b)} tensors, "
              f"{len(differ)} differ [{smi}]")
        check(a.keys() == b.keys() and not differ, f"the int8 export's tensors differ: {differ[:4]}")
        del served, a, b
        torch.cuda.empty_cache()

        # AOT artifacts: pinned at 32 (bf16, int8) and one symbolic (the plain path)
        sd, _, _ = restore_params(root, "ckpt")
        plain = Predictor(sd, dataclasses.replace(m, flash_attn=False), device="cuda")
        del sd
        artifacts = (("aot-32", dict(batch=AOT_BATCH), bf16, per_pass(PATHS["nvit"]["forward"], passes)),
                     ("aot-32-int8", dict(batch=AOT_BATCH, quantize="int8"), int8, per_pass(INT8_FORWARD, passes)),
                     ("aot-symbolic", {}, plain, {}))
        for name, kw, ref, want_counts in artifacts:
            t0 = time.perf_counter()
            pt2 = export_aot(root, "ckpt", root / name, device="cuda", **kw)
            export_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            art = load_aot(root / name, "ckpt", device="cuda")
            load_s = time.perf_counter() - t0
            for bsz in ((AOT_BATCH,) if kw else (1, 4, 32)):
                reset_counts()
                got = art.predict_probs(images[bsz])
                counts = read_counts()
                want = ref.predict_probs(images[bsz])
                err = float(np.abs(got - want).max())
                print(f"{name}: batch {bsz}, max|Δp| against Predictor {err:.3e}, launches {counts}")
                check_launches(counts, want_counts, f"{name} forward")
                check(got.shape == want.shape and np.allclose(got, want, **AOT_TOL),
                      f"{name} disagrees with Predictor at batch {bsz}")
            by_path[name] = {k: counts[k] for k in ("qknorm_attn_fwd", "qknorm_project", "gated_mlp_fwd")}
            x = images[AOT_BATCH]
            ms = {"artifact": [], "Predictor": []}
            for which in ("artifact", "Predictor", "Predictor", "artifact"):
                ms[which].append(host_ms(lambda: (art if which == "artifact" else ref).predict_probs(x), 10))
            print(f"{name}: export {export_s:.1f} s, .pt2 {pt2.stat().st_size / 1e6:.1f} MB, load {load_s:.1f} s; "
                  f"batch-32 predict_probs {statistics.mean(ms['artifact']):.3f} ms against Predictor's "
                  f"{statistics.mean(ms['Predictor']):.3f} ms (host clock, two medians of 10 each) [{smi}]")
            del art
            torch.cuda.empty_cache()
        del plain

        # python -m nvit_tpu_torch.serve --aot answering one request
        t0 = time.perf_counter()
        srv = Cli(["nvit_tpu_torch.serve", "--aot", "--checkpoint", str(root / "aot-32"), "--name", "ckpt",
                   "--port", "0"], {}, root, "python -m nvit_tpu_torch.serve --aot")
        try:
            port = int(srv.wait_for("serving").rsplit(":", 1)[1])
            up_s = time.perf_counter() - t0
            res = post(("127.0.0.1", port), "/predict", images[1][0].tobytes(), "application/octet-stream")
            want = bf16.predict_probs(images[1])[0]
            print(f"serve --aot: serving after {up_s:.1f} s; one image → label {res['labels'][0][0]} p "
                  f"{res['probs'][0][0]:.5f} (bf16 Predictor: {int(want.argmax())}, {want.max():.5f})")
            check(res["labels"][0][0] == int(want.argmax()) and abs(res["probs"][0][0] - want.max()) <= 1e-3,
                  "serve --aot answered otherwise than the bf16 Predictor")
            srv.proc.send_signal(signal.SIGTERM)
            srv.wait_for("drained; exiting")
        finally:
            rc = srv.finish(timeout=60)
        check(rc == 0, f"serve --aot exited {rc}")
        del bf16, int8
        torch.cuda.empty_cache()

        # serve_bench: 8 clients × 4 single-image requests, the window off and on, bf16 and int8
        for flags in ([], ["--int8"]):
            lines = serve_bench.main(["--clients", "8", "--requests", "4", *flags])
            check(len(lines) == 2 and all(x["stats"]["errors"] == 0 and x["stats"]["requests"] == 32 for x in lines),
                  "serve_bench did not answer every request")
            torch.cuda.empty_cache()
        print(f"serve_bench above: flagship_config(), random weights [{smi}]")

        # the debug CLI on the packaged settings (the Kohonen model, 32 px), in this process
        cwd, saved = os.getcwd(), {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("NVIT_")}
        os.environ["NVIT_DATA__OUT_DIR"] = str(root / "debug_out")
        os.chdir(root)
        try:
            dm = load_config().model
            reset_counts()
            out = debug_model()
            counts = read_counts()
        finally:
            os.chdir(cwd)
            os.environ.pop("NVIT_DATA__OUT_DIR")
            os.environ.update(saved)
        print(f"debug CLI: {out}; launches {counts}")
        check_launches(counts, per_pass(modes_forward_names(dm), n_passes(dm)), "the debug CLI's forward")
        check(out["logits_shape"] == (256, dm.num_classes) and np.isfinite(list(out["aux_losses"].values())).all()
              and all(Path(f).stat().st_size > 0 for f in out["figures"]) and len(out["figures"]) == 2,
              "the debug CLI's summary or figures are wrong")
        by_path["debug"] = counts
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"serving modes phase: {time.perf_counter() - t_phase:.1f} s of wall time")
    return by_path


# the data-parallel phase: two ranks of the flagship step on the one card
DP_WORLD = 2
DP_TIMEOUT_S = 300  # the group's timeout and the wait for its workers
DP_CLI_ITERS = 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_worker(out: Path) -> int:
    """One rank of phase 15's two-rank run: ``python3 chip_smoke.py
    --dp-worker OUT`` with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``LOCAL_RANK=0`` from the parent, so both ranks take
    cuda:0 (NCCL refuses two ranks on one card: the group is gloo, which
    stages every CUDA tensor through the host).  Writes ``OUT/rank<r>.json``;
    the parent checks it."""
    import tempfile

    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.parallel.mesh import all_reduce_mean_, any_flag, broadcast_, destroy, init_data_parallel
    from nvit_tpu_torch.scripts.step_time import step_ms, sync_step
    from nvit_tpu_torch.train.step import make_loss_fn, make_train_step
    from nvit_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = init_data_parallel("cuda", backend="gloo", timeout_s=DP_TIMEOUT_S)
    r = group.rank
    base = flagship_config()
    cfg = dataclasses.replace(
        base, system=dataclasses.replace(base.system, use_ddp=True),
        data=dataclasses.replace(base.data, dataset="synthetic",
                                 out_dir=tempfile.mkdtemp(prefix=f"chip_smoke_dp{r}_")))
    trainer = Trainer(cfg, device="cuda", group=group)  # rank 0's weights and moments, broadcast
    state, model = trainer.state, trainer.state.model
    params = dict(model.named_parameters())
    _, images, labels = batch32(cfg.model)
    b = images.shape[0] // group.world
    rows = slice(r * b, (r + 1) * b)
    res: dict = {"rank": r, "device": str(trainer.device)}

    # the global batch's loss and gradients: this rank's rows, then the mean over ranks
    loss_fn = make_loss_fn(cfg)
    loss, _ = loss_fn(model, images[rows], labels[rows])
    loss.backward()
    grads = {n: p.grad for n, p in params.items() if p.grad is not None}
    dp_loss = loss.detach().float().reshape(1)
    all_reduce_mean_(group, [*grads.values(), dp_loss])
    if r == 0:  # against this process's one-process pass over all 32 rows
        dp = {n: g.clone() for n, g in grads.items()}
        model.zero_grad(set_to_none=True)
        one_loss, _ = loss_fn(model, images, labels)
        one_loss.backward()
        one = {n: p.grad for n, p in params.items() if p.grad is not None}
        res["loss"] = [dp_loss.item(), one_loss.item()]
        res["grad_names"] = [sorted(dp), sorted(one)]
        res["grad_rel_l2"] = {}
        import re

        for name, pattern in GRAD_GROUPS.items():
            names = [n for n in one if re.fullmatch(pattern, n)]
            res["grad_rel_l2"][name] = rel_l2(torch.cat([dp[n].flatten() for n in names]),
                                              torch.cat([one[n].flatten() for n in names]))
        del dp, one
    del grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # one step counted from 0, then two timed: 3 steps in all
    step = make_train_step(cfg, log_norms=False, group=group)
    reset_counts()
    sync_step(step, state, images[rows], labels[rows])
    res["launches"] = read_counts()
    res["step_ms"] = step_ms(step, state, images[rows], labels[rows], 2)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # bit-equal parameters: rank 0's flat copy against this rank's own
    mine = torch.cat([p.detach().reshape(-1) for p in params.values()])
    theirs = mine.clone()
    broadcast_(group, [theirs])
    res["bit_equal"] = not any_flag(group, not torch.equal(as_bytes(mine), as_bytes(theirs)))
    del theirs

    # the gradient buffer's all-reduce alone: one fp32 value a parameter
    buf = torch.ones_like(mine)
    res["grad_numel"] = buf.numel()
    res["allreduce_ms"] = cuda_ms(lambda: all_reduce_mean_(group, [buf]), iters=3, warmup=1)
    res["allreduce_ok"] = bool(torch.all(buf == 1.0).item())
    destroy(group)
    (out / f"rank{r}.json").write_text(json.dumps(res))
    return 0


def nccl_allreduce_ms(numel: int) -> float:
    """The flat fp32 gradient buffer's mean all-reduce in a one-rank NCCL
    group formed in this process (the launcher's variables set here, then
    put back): what a rank pays beside its step on one card — no link is
    crossed."""
    from nvit_tpu_torch.parallel.mesh import all_reduce_mean_, destroy, init_data_parallel

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    try:
        group = init_data_parallel("cuda", timeout_s=DP_TIMEOUT_S)
        buf = torch.ones(numel, device="cuda")
        ms = cuda_ms(lambda: all_reduce_mean_(group, [buf]), iters=10, warmup=2)
        check(bool(torch.all(buf == 1.0).item()), "the one-rank NCCL mean changed the buffer")
        destroy(group)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return ms


def data_parallel_phase(smi: str) -> dict:
    """Phase 15 → path_launches of the two-rank step (per rank, one step)
    and of the two-replica serving forward (per replica-forward)."""
    import shutil
    import tempfile

    from nvit_tpu_torch.configs import Config, ViTConfig
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config, preset

    phase("data parallel nViT-B/16 (flagship_config: global batch 32, bf16): two ranks on cuda:0 over gloo, "
          "one rank under torch.distributed.run over NCCL, Predictor(data_parallel=True) over HTTP")
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    try:
        # two ranks, two processes, one card, gloo
        _, worker_s = run_workers("--dp-worker", root, DP_WORLD)
        res = [json.loads((root / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
        m = flagship_config().model
        want = per_pass(PATHS["nvit"]["step"], n_passes(m))
        for r, got in enumerate(res):
            print(f"rank {r} on {got['device']}: launches in one step of its 16 rows {got['launches']}")
            check_launches(got["launches"], want, f"data-parallel rank {r}")
            check(got["allreduce_ok"], f"rank {r}: the mean of two equal buffers is not the buffer")
        check(all(got["bit_equal"] for got in res), "the ranks' parameters differ after 3 steps")
        dp_loss, one_loss = res[0]["loss"]
        gap = abs(dp_loss - one_loss) / abs(one_loss)
        names_dp, names_one = res[0]["grad_names"]
        print(f"global batch 32: loss over two ranks {dp_loss:.6f}, one process {one_loss:.6f} "
              f"(relative gap {gap:.3e}, bound {TRAIN_LOSS_RTOL})")
        for name, rel in res[0]["grad_rel_l2"].items():
            print(f"grad {name}: two ranks against one process, relative L2 {rel:.3e}")
        check(gap <= TRAIN_LOSS_RTOL, "the two ranks' loss disagrees with one process's")
        check(names_dp == names_one, "the two ranks reduce other gradients than one process has")
        check(max(res[0]["grad_rel_l2"].values()) <= GRAD_REL_L2, "the two ranks' gradients disagree")
        gib = res[0]["grad_numel"] * 4 / 2**30
        for got in res:
            print(f"rank {got['rank']}: step {got['step_ms']:.1f} ms (16 rows, its all-reduce included), "
                  f"peak {got['peak_gib']:.2f} GiB; all-reduce of the {gib:.3f} GiB fp32 gradient buffer "
                  f"{got['allreduce_ms']:.1f} ms — gloo through the host, both ranks on one card, not NVLink "
                  f"[{smi}]")
        print(f"three steps on two ranks, bit-equal parameters after them; workers {worker_s:.1f} s")

        # one rank under the real launcher, NCCL: the CLI on path A, synthetic 224 px data
        out = root / "cli"
        cli_cfg = flagship_config(bias=True)
        cli_env = {**env_of(cli_cfg), "NVIT_DATA__DATASET": "synthetic", "NVIT_DATA__OUT_DIR": str(out),
                   "NVIT_DATA__CHECKPOINT_DIR": str(out), "NVIT_DATA__AUGMENTATION__AUTO_AUGMENT": "false",
                   "NVIT_TRAINING__MAX_ITERS": str(DP_CLI_ITERS), "NVIT_TRAINING__EVAL_INTERVAL": "100",
                   "NVIT_TRAINING__EVAL_ITERS": "1", "NVIT_TRAINING__LOG_INTERVAL": "1",
                   "NVIT_SYSTEM__QUICK_VALIDATION_SIZE": "32", "NVIT_SYSTEM__PROFILE_STEPS": "2",
                   "NVIT_SYSTEM__USE_DDP": "true"}
        t0 = time.perf_counter()
        cli = Cli(["torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m", "nvit_tpu_torch"],
                  cli_env, root, "torchrun -m nvit_tpu_torch")
        lines = cli.run(timeout=DP_TIMEOUT_S)
        cli_s = time.perf_counter() - t0
        check(any("data parallel: rank 0 of 1 on cuda:0" in x for x in lines), "the CLI formed no group")
        check((out / "finished").read_text() == f"max_iters:{DP_CLI_ITERS}", "the CLI under torchrun did not finish")
        traces = list((out / "profile").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"{len(traces)} trace files under out_dir/profile")
        text = traces[0].read_text()
        missing = [k for k in TRACE_KERNELS if k not in text]
        check(not missing, f"the launcher's run traced no {missing}")
        logged = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
        steps = [x for x in logged if "train/batch_loss" in x]
        check([x["train/iter"] for x in steps] == list(range(1, DP_CLI_ITERS + 1))
              and all(math.isfinite(x["train/batch_loss"]) for x in steps), "the CLI's logged steps")
        step_list = ", ".join(f"{x['train/batch_time_ms']:.1f}" for x in steps)
        print(f"python -m torch.distributed.run --nproc_per_node=1 -m nvit_tpu_torch (path A, NCCL, one rank): "
              f"exit 0 in {cli_s:.1f} s with the process start; its trace holds K1, K2 (both walks), K6's "
              f"forward and backward and the prologue; step ms {step_list} [{smi}]")
        nccl_ms = nccl_allreduce_ms(res[0]["grad_numel"])
        print(f"NCCL mean all-reduce of the {gib:.3f} GiB gradient buffer on ONE rank: {nccl_ms:.3f} ms "
              f"(a one-rank figure: no link crossed) [{smi}]")

        # two replicas on cuda:0 behind the HTTP service, against the one replica
        cfg = Config(model=ViTConfig(**preset("nvit-b16"), num_classes=1000))
        pred = Predictor.from_config(cfg, seed=0, device="cuda", data_parallel=True,
                                     devices=["cuda:0", "cuda:0"])
        check(pred.batch_multiple == 2 and pred.replicas[0] is not pred.replicas[1], "not two replicas")
        one = Predictor(pred.model, cfg.model, device="cuda")
        served = serve_phase("nViT-B/16 on two replicas (Predictor(data_parallel=True, devices=[cuda:0, "
                             "cuda:0]))", "nvit", cfg, pred, one, replicas=2, versus="one replica")
        del pred, one
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"data-parallel phase: {time.perf_counter() - t_phase:.1f} s")
    forwards = 3 * 2  # three requests, two replica-forwards each
    return {"data-parallel-step": res[0]["launches"],
            "data-parallel-forward": {k: v // forwards for k, v in served.items()}}


# the tensor-parallel and FSDP phase: two ranks of path A on the one card
TP_WORLD = 2


def gloo_takes_fsdp_collectives(group) -> bool:
    """Whether gloo runs FSDP's all-gather and reduce-scatter on CUDA
    tensors (PyTorch's backend table lists only broadcast and all-reduce
    there): both ranks call both on a small tensor; a refusal raises on
    each before anything is sent."""
    import torch.distributed as dist

    from nvit_tpu_torch.parallel.tensor import _reduce_scatter

    x = torch.full((4,), float(group.rank + 1), device="cuda")
    try:
        out = x.new_empty(4 * group.world)
        dist.all_gather_into_tensor(out, x)
        part = x.new_empty(4 // group.world)
        _reduce_scatter(part, x)
    except RuntimeError as e:
        print(f"rank {group.rank}: gloo refuses FSDP's collectives on CUDA tensors: {e}", flush=True)
        return False
    return (bool(torch.equal(out, torch.tensor([1.0] * 4 + [2.0] * 4, device="cuda")))
            and bool(torch.all(part == 3.0).item()))


def tp_worker(out: Path) -> int:
    """One rank of phase 16's two-rank runs: ``python3 chip_smoke.py
    --tp-worker OUT``, started as ``--dp-worker`` is (both ranks on cuda:0,
    gloo).  Path A (``flagship_config(bias=True)``, biases randomised) at
    global batch 32, bf16: data 1 × model 2, then — when gloo takes FSDP's
    collectives on CUDA tensors — data 2 × model 1 with ``system.fsdp``
    against the unsharded two-rank step.  Writes ``OUT/tp_rank<r>.json``."""
    import gc
    import re
    import tempfile
    from unittest import mock

    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops import gated_mlp as gm
    from nvit_tpu_torch.parallel.mesh import any_flag, broadcast_, destroy, init_data_parallel, shard_dim
    from nvit_tpu_torch.scripts.step_time import sync_step
    from nvit_tpu_torch.train import trainer as trainer_mod
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_loss_fn, reduce_gradients_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = init_data_parallel("cuda", backend="gloo", timeout_s=DP_TIMEOUT_S)
    r = group.rank
    base = flagship_config(bias=True)

    def config(**system):
        return dataclasses.replace(
            base, system=dataclasses.replace(base.system, use_ddp=True, **system),
            data=dataclasses.replace(base.data, dataset="synthetic",
                                     out_dir=tempfile.mkdtemp(prefix=f"chip_smoke_tp{r}_")))

    def with_biases(cfg, seed=None, *, device):  # the same random biases on every rank, before any shard
        state = create_train_state(cfg, seed, device=device)
        randomize_biases(state.model, seed=2)
        return state

    def trainer_for(cfg):
        with mock.patch.object(trainer_mod, "create_train_state", with_biases):
            return trainer_mod.Trainer(cfg, device="cuda", group=group)

    def state_bytes() -> int:
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    def replicated_equal(model) -> bool:
        mine = torch.cat([p.detach().reshape(-1) for n, p in model.named_parameters() if shard_dim(n) is None])
        theirs = mine.clone()
        broadcast_(group, [theirs])
        return not any_flag(group, not torch.equal(as_bytes(mine), as_bytes(theirs)))

    _, images, labels = batch32(base.model)
    res: dict = {"rank": r}
    groups = {**GRAD_GROUPS, **BIAS_GROUPS}

    # (a) data 1 × model 2: the state, the global batch's gradients, three steps
    held = state_bytes()
    cfg = config(model_parallel=2)
    trainer = trainer_for(cfg)
    state, model, mesh = trainer.state, trainer.state.model, trainer.mesh
    res["state_gib"] = (state_bytes() - held) / 2**30
    res["coords"] = [mesh.data.rank, mesh.model.rank]
    loss, _ = make_loss_fn(cfg)(model, images, labels)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: p.grad for n, p in params.items() if p.grad is not None}
    reduce_gradients_(mesh, grads, {}, {})
    whole = {n: mesh.gather(n, g) for n, g in grads.items()}
    model.zero_grad(set_to_none=True)
    del grads
    if r == 0:  # one card: the same weights, the same 32 rows
        held1 = state_bytes()
        one = with_biases(dataclasses.replace(cfg, system=dataclasses.replace(cfg.system, model_parallel=1)),
                          device="cuda")
        res["one_card_state_gib"] = (state_bytes() - held1) / 2**30
        one_loss, _ = make_loss_fn(cfg)(one.model, images, labels)
        one_loss.backward()
        ref = {n: p.grad for n, p in one.model.named_parameters() if p.grad is not None}
        res["loss"] = [loss.item(), one_loss.item()]
        res["grad_names"] = [sorted(whole), sorted(ref)]
        res["grad_rel_l2"] = {}
        for name, pattern in groups.items():
            names = [n for n in ref if re.fullmatch(pattern, n)]
            res["grad_rel_l2"][name] = rel_l2(torch.cat([whole[n].flatten() for n in names]),
                                              torch.cat([ref[n].flatten() for n in names]))
        del one, ref, one_loss
    del whole, loss
    state_bytes()

    # the shapes the kernels see: heads of K1, H of K6.  A spy keeps its
    # wrapper's counters, which the wrapper bumps through its module's name
    heads, hidden = Counter(), Counter()

    def spy(fn, record):
        def wrapped(*args, **kwargs):
            record(*args)
            return fn(*args, **kwargs)
        for attr in ("launches", "launches_bounded", "launches_auto", "launches_bias"):
            if hasattr(fn, attr):
                setattr(wrapped, attr, getattr(fn, attr))
        return wrapped

    step = trainer._train_step
    res["step_ms"], res["bit_equal"] = [], []
    for i in range(3):
        t0 = time.perf_counter()
        if i == 0:  # counted from 0, read before the spies go
            reset_counts()
            with mock.patch.object(fa, "qknorm_attention_fwd", spy(fa.qknorm_attention_fwd,
                                                                    lambda q, *_: heads.update([q.shape[1]]))), \
                    mock.patch.object(gm, "gated_mlp_fwd", spy(gm.gated_mlp_fwd,
                                                              lambda x, w, *_: hidden.update([w.shape[0] // 2]))):
                sync_step(step, state, images, labels)
                res["launches"] = read_counts()
        else:
            sync_step(step, state, images, labels)
        res["step_ms"].append((time.perf_counter() - t0) * 1e3)
        res["bit_equal"].append(replicated_equal(model))
    res["heads"], res["hidden"] = dict(heads), dict(hidden)
    res["c_fc_shape"] = list(params["transformer.h.0.c_fc.weight"].shape)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer, state, model, params, step
    state_bytes()

    # (c) data 2 × model 1 with FSDP, against the unsharded two-rank step
    res["fsdp_collectives"] = gloo_takes_fsdp_collectives(group)
    if res["fsdp_collectives"]:
        b = images.shape[0] // 2
        rows = slice(r * b, (r + 1) * b)
        after = {}
        for name, system in (("dp", dict(model_parallel=1)), ("fsdp", dict(model_parallel=1, fsdp=True))):
            held = state_bytes()
            t = trainer_for(config(**system))
            res[f"{name}_state_gib"] = (state_bytes() - held) / 2**30
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                sync_step(t._train_step, t.state, images[rows], labels[rows])
                ms.append((time.perf_counter() - t0) * 1e3)
            res[f"{name}_step_ms"] = ms
            named = dict(t.state.model.named_parameters())
            if name == "fsdp":
                res["fsdp_shapes"] = {n: [list(named[n].shape), list(t.state.opt_state.mu[n].shape)]
                                      for n in ("transformer.h.0.c_fc.weight", "transformer.h.0.att_c_proj.weight")}
                worst = 0.0
                for n, p in named.items():
                    if shard_dim(n) is not None and n.endswith(".weight"):
                        norms = torch.linalg.vector_norm(p.detach().float(), dim=1 - shard_dim(n))
                        worst = max(worst, (norms - 1).abs().max().item())
                res["renorm_worst"] = worst
            # on the host: the next leg's state is measured without it
            after[name] = {n: t.mesh.gather(n, p.detach()).cpu() for n, p in named.items()}
            del t, named
            state_bytes()
        res["fsdp_rel_l2"] = rel_l2(torch.cat([after["fsdp"][n].flatten() for n in after["dp"]]),
                                    torch.cat([after["dp"][n].flatten() for n in after["dp"]]))
        res["fsdp_max_err"] = max(max_err(after["fsdp"][n], after["dp"][n]) for n in after["dp"])
    destroy(group)
    (out / f"tp_rank{r}.json").write_text(json.dumps(res))
    return 0


def run_workers(flag: str, root: Path, world: int) -> tuple[list, float]:
    """``world`` processes of ``chip_smoke.py <flag> root`` on cuda:0 (gloo)
    → (their exit codes' checks done, their wall seconds)."""
    port = str(free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith("NVIT_")}
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent)
    logs = [open(root / f"{flag.strip('-')}{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(root)],
        env={**env, "RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
             "MASTER_ADDR": "localhost", "MASTER_PORT": port},
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:  # stop every process this script starts
            if p.poll() is None:
                p.kill()
            p.wait()
    seconds = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        check(p.returncode == 0, f"{flag} rank {r} exited {p.returncode}:\n" + text[-4000:])
    return procs, seconds


def tensor_parallel_phase(smi: str) -> dict:
    """Phase 16 → path_launches of a tensor-parallel rank's step and of the
    two-shard serving forward (both shards, per forward)."""
    import shutil
    import tempfile

    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config

    phase("tensor parallel and FSDP, path A (flagship_config(bias=True): global batch 32, bf16): two ranks on "
          "cuda:0 over gloo, data 1 × model 2, then data 2 × model 1 with system.fsdp; "
          "Predictor(model_parallel=2, devices=[cuda:0, cuda:0]) over HTTP")
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    try:
        _, worker_s = run_workers("--tp-worker", root, TP_WORLD)
        res = [json.loads((root / f"tp_rank{r}.json").read_text()) for r in range(TP_WORLD)]
        m = flagship_config(bias=True).model
        want = per_pass(PATHS["nvit-bias"]["step"], n_passes(m))
        # the cross-attention on all heads and the whole gated width, the blocks on the rank's share
        want_heads = {str(m.n_head): 1, str(m.n_head // 2): m.n_layer}
        want_hidden = {str(m.n_embd): 1, str(4 * m.n_embd // 2): m.n_layer}
        for got in res:
            r = got["rank"]
            print(f"rank {r} (data, model) = {tuple(got['coords'])}: launches in one step {got['launches']}; "
                  f"K1 heads a call {got['heads']}, K6 H a call {got['hidden']}")
            check_launches(got["launches"], want, f"tensor-parallel rank {r}")
            check({str(k): v for k, v in got["heads"].items()} == want_heads, f"rank {r}: K1's heads {got['heads']}")
            check({str(k): v for k, v in got["hidden"].items()} == want_hidden, f"rank {r}: K6's H {got['hidden']}")
            check(got["c_fc_shape"] == [8 * m.n_embd // 2, m.n_embd], f"rank {r}: c_fc shard {got['c_fc_shape']}")
            check(all(got["bit_equal"]), f"rank {r}: the replicated parameters differ after a step")
        tp_loss, one_loss = res[0]["loss"]
        gap = abs(tp_loss - one_loss) / abs(one_loss)
        print(f"global batch 32: loss over model 2 {tp_loss:.6f}, one card {one_loss:.6f} (relative gap "
              f"{gap:.3e}, bound {TRAIN_LOSS_RTOL})")
        for name, rel in res[0]["grad_rel_l2"].items():
            print(f"grad {name}: two model ranks against one card, relative L2 {rel:.3e} (bound {GRAD_REL_L2})")
        check(gap <= TRAIN_LOSS_RTOL, "the model ranks' loss disagrees with one card's")
        check(res[0]["grad_names"][0] == res[0]["grad_names"][1], "the model ranks have other gradients")
        check(max(res[0]["grad_rel_l2"].values()) <= GRAD_REL_L2, "the model ranks' gradients disagree")
        one_gib = res[0]["one_card_state_gib"]
        for got in res:
            print(f"rank {got['rank']}: parameters + moments {got['state_gib']:.3f} GiB against one card's "
                  f"{one_gib:.3f} GiB (torch.cuda.memory_allocated); steps "
                  f"{', '.join(f'{x:.1f}' for x in got['step_ms'])} ms (the row-parallel all-reduces through "
                  f"the host: gloo, both ranks on one card, not NVLink), peak {got['peak_gib']:.2f} GiB [{smi}]")
        check(all(got["state_gib"] < 0.75 * one_gib for got in res), "a model rank holds most of one card's state")
        if res[0]["fsdp_collectives"]:
            for got in res:
                print(f"rank {got['rank']} FSDP: shapes (param, mu) {got['fsdp_shapes']}; parameters + moments "
                      f"{got['fsdp_state_gib']:.3f} GiB against {got['dp_state_gib']:.3f} unsharded; steps "
                      f"{', '.join(f'{x:.1f}' for x in got['fsdp_step_ms'])} ms against "
                      f"{', '.join(f'{x:.1f}' for x in got['dp_step_ms'])} ms (gloo through the host) [{smi}]")
                check(got["fsdp_shapes"]["transformer.h.0.c_fc.weight"] == [[4 * m.n_embd, m.n_embd]] * 2
                      and got["fsdp_shapes"]["transformer.h.0.att_c_proj.weight"]
                      == [[m.n_embd, m.n_embd // 2]] * 2, f"rank {got['rank']}: FSDP pieces")
                print(f"rank {got['rank']}: after 3 steps FSDP against the unsharded two-rank step: relative L2 "
                      f"{got['fsdp_rel_l2']:.3e}, max|Δ| {got['fsdp_max_err']:.3e}; renorm |‖w‖ − 1| ≤ "
                      f"{got['renorm_worst']:.3e}")
                check(got["fsdp_rel_l2"] <= FSDP_REL_L2, "FSDP's parameters disagree with the unsharded step")
                check(got["renorm_worst"] <= RENORM_TOL, "FSDP's renorm norms are not 1")
                check(got["fsdp_state_gib"] < 0.75 * got["dp_state_gib"], "an FSDP rank holds most of the state")
        else:
            print("gloo refuses all_gather_into_tensor / reduce_scatter_tensor on CUDA tensors: no FSDP leg on "
                  "this card; FSDP across ranks is held on the CPU only")
        print(f"tensor-parallel workers: {worker_s:.1f} s")

        # two model shards on cuda:0 behind the HTTP service, against one card
        cfg = flagship_config(bias=True)
        one = Predictor.from_config(cfg, seed=0, device="cuda")
        randomize_biases(one.model, seed=2)
        tp = Predictor(one.model.state_dict(), cfg.model, device="cuda", model_parallel=2,
                       devices=["cuda:0", "cuda:0"])
        check(tp.layout["model"] == 2 and tp.batch_multiple == 1, f"layout {tp.layout}")
        x = np.random.default_rng(9).integers(0, 256, (32, 3, 224, 224), dtype=np.uint8)
        p_tp, p_one = tp.predict_probs(x), one.predict_probs(x)
        dp = float(np.abs(p_tp - p_one).max())
        top1 = float((p_tp.argmax(-1) == p_one.argmax(-1)).mean())
        print(f"batch 32: two model shards against one card: max|Δprob| {dp:.3e} (bound {PROB_RTOL} × prob + 1e-6), "
              f"top-1 agreement {top1:.3f}")
        check(np.all(np.abs(p_tp - p_one) <= PROB_RTOL * p_one + 1e-6), "the model shards disagree with one card")
        served = serve_phase("nViT-B/16 path A on two model shards (Predictor(model_parallel=2, devices=[cuda:0, "
                             "cuda:0]))", "nvit-bias", cfg, tp, one, versus="one card",
                             passes=1 + 2 * cfg.model.n_layer)
        del tp, one
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"tensor-parallel phase: {time.perf_counter() - t_phase:.1f} s")
    return {"tensor-parallel-step": res[0]["launches"],
            "tensor-parallel-forward": {k: v // 3 for k, v in served.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs only on the card", file=sys.stderr)
        return 1
    import gc

    from nvit_tpu_torch.configs import Config, ViTConfig
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import flagship_config, preset
    from nvit_tpu_torch.models.vit import ViT

    t_start = time.perf_counter()
    smi = device_phase()
    build_phase()
    errs = kernel_phase()
    bench_launches = bench_phase()
    k10_times = subtiled_time_phase()
    reuse_synthetic_data()

    nvit_cfg = Config(model=ViTConfig(**preset("nvit-b16"), num_classes=1000))
    check(nvit_cfg.model.flash_attn and nvit_cfg.model.bounded_softmax == "rowmax", "flagship config drifted")
    base_cfg = flagship_config(use_nvit=False)
    path_a = flagship_config(bias=True)  # settings.yaml's model flags, profiles/nvit1_k0.env
    check(path_a.model.bias and path_a.model.use_nvit and path_a.model.bounded_softmax == "rowmax"
          and path_a.model.n_embd == 768 and path_a.model.n_layer == 12, "path A's config drifted")
    bias_groups = {**GRAD_GROUPS, **BIAS_GROUPS}
    full = (  # (path, title, serving config, training config, times, gradient groups)
        ("nvit", "nViT-B/16", nvit_cfg, flagship_config(), time_phase, GRAD_GROUPS),
        ("baseline", "baseline ViT-B/16", base_cfg, base_cfg, baseline_time_phase, BASELINE_GRAD_GROUPS),
        ("nvit-bias", "nViT-B/16, bias=True (path A)", path_a, path_a, bias_bounded_time_phase, bias_groups),
    )
    times, launches, by_path = {}, {}, {}
    for path, title, serve_cfg, train_cfg, time_fn, groups in full:
        pred = Predictor.from_config(serve_cfg, seed=0, device="cuda")
        if serve_cfg.model.bias:
            randomize_biases(pred.model, seed=2)
        plain_cfg = dataclasses.replace(serve_cfg.model, flash_attn=False, gated_mlp_kernel="off")
        plain_model = ViT(plain_cfg, device="cuda")
        plain_model.load_state_dict(pred.model.state_dict(), strict=True)
        plain = Predictor(plain_model, plain_cfg, device="cuda")
        served = serve_phase(title, path, serve_cfg, pred, plain)
        times.update(time_fn(serve_cfg, pred, plain))
        del pred, plain, plain_model
        gc.collect()
        torch.cuda.empty_cache()
        stepped = train_phase(smi, title, path, train_cfg, groups)
        # launches: the forwards' from the serving path, the backwards' from
        # one training step (each path driven with every count set to 0 just
        # before); a later path's count of a kernel replaces an earlier one's
        for name in PATHS[path]["step"]:
            launches[name] = served[name] if name in PATHS[path]["forward"] else stepped[name]
        by_path[path] = {name: launches[name] for name in PATHS[path]["step"]}
        gc.collect()
        torch.cuda.empty_cache()
    launches["flash_attn_bwd_split"] = stepped["flash_attn_bwd_split"]  # 0: T = 784 takes K8
    launches["qknorm_attn_bwd_subtiled"] = stepped["qknorm_attn_bwd_subtiled"]  # 0: only the bench runs K10
    times.update(k10_times)
    times["qknorm_attn_bwd_subtiled"]["bench_launches"] = bench_launches

    checks = (  # (path, title, config, gradient groups, sqk factor, the arm "auto" must take)
        ("baseline-bias", "baseline ViT-B/16, bias=True", flagship_config(use_nvit=False, bias=True),
         {**BASELINE_GRAD_GROUPS, **BIAS_GROUPS}, 1.0, None),
        ("bounded", "nViT-B/16, bias=True, bounded softmax (path B)",
         flagship_config(bias=True, bounded_softmax="bounded"), bias_groups, 1.0, None),
        ("auto", "nViT-B/16, bias=True, auto softmax below its gate (sqk_eff = 1, bound 8)",
         flagship_config(bias=True, bounded_softmax="auto"), bias_groups, 1.0, "bounded"),
        ("auto", "nViT-B/16, bias=True, auto softmax above its gate (sqk x 2, bound 32)",
         flagship_config(bias=True, bounded_softmax="auto"), bias_groups, 2.0, "rowmax"),
    )
    for path, title, cfg, groups, factor, arm in checks:
        got = check_phase(title, path, cfg, groups, sqk_factor=factor, arm=arm)
        if path == "bounded":
            launches["qknorm_attn_fwd_bounded"] = got["forward"]["qknorm_attn_fwd_bounded"]
            launches["qknorm_attn_bwd_bounded"] = got["step"]["qknorm_attn_bwd_bounded"]
        gc.collect()
        torch.cuda.empty_cache()

    lifecycle_phase(smi)
    profiles = data_phase(smi)["profiles"]
    gc.collect()
    torch.cuda.empty_cache()
    kohonen = kohonen_phase(smi)
    # this slice's path: K1–K4 and the prologue over its 3 + 12 passes
    for name in PATHS["nvit-kohonen"]["step"]:
        launches[name] = kohonen["served"][name] if name in PATHS["nvit-kohonen"]["forward"] \
            else kohonen["stepped"][name]
    by_path["nvit-kohonen"] = {name: launches[name] for name in PATHS["nvit-kohonen"]["step"]}
    gc.collect()
    torch.cuda.empty_cache()
    # the trainer's settings: one bf16-moment step of nViT-B/16, counted from 0
    by_path["nvit-bf16-moments"] = settings_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()
    # the serving modes: one forward of each (int8, the AOT artifacts), the debug CLI's
    by_path.update(serving_modes_phase(smi))
    gc.collect()
    torch.cuda.empty_cache()
    # data parallelism: one step of a rank of two, one forward of a replica of two
    by_path.update(data_parallel_phase(smi))
    gc.collect()
    torch.cuda.empty_cache()
    # tensor parallelism: one step of a model rank of two, one two-shard forward
    by_path.update(tensor_parallel_phase(smi))

    # launches: the flagship paths' (above; the Kohonen flagship's last);
    # path_launches: each full path's own; profile_launches: one step of
    # each profile's config (batch 512, 32 px, remat), counted from 0
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name], **times[name],
         "path_launches": {p: got[name] for p, got in by_path.items() if name in got},
         "profile_launches": {p: got[name] for p, got in profiles.items()}}
        for name, (src, tpu) in KERNELS.items()
    ]}
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s of wall time")
    print(smi)  # the card and its power limit, as nvidia-smi gives them
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 15, started by the phase
        sys.exit(dp_worker(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of phase 16, started by the phase
        sys.exit(tp_worker(Path(sys.argv[2])))
    sys.exit(main())
