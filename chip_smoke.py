#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nvit_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and nvcc::

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. device   — card name and power limit, torch/CUDA versions; requires
               compute capability 9.0; TF32 off for matmuls and cuDNN;
2. build    — compiles the four kernels from nvit_tpu_torch/csrc/, one nvcc
               per source, all started together;
3. kernels  — K1/K2 (QK-norm flash attention fwd/bwd) and K3/K4 (gated MLP
               fwd/bwd) against their plain PyTorch twins at the main paths'
               shapes and at ragged ones, and the autograd Functions' CUDA
               gradients against autograd through the twins;
4. serve    — nViT-B/16 (random weights from a seed) behind InferenceService
               + make_handler on a local ThreadingHTTPServer: /predict at
               batches 1, 4 and 32, /healthz, /stats; K1 and K3 must launch
               13 times per forward and K2/K4 never; served probabilities
               against the same weights on the plain path (flash_attn=False,
               gated MLP off);
5. train    — flagship_config() nViT-B/16 training at batch 32, bf16: one
               make_train_step step launches K1–K4 13 times each; loss and
               per-group gradients against the plain path on the same
               weights and batch; ten steps on one batch lower the loss;
               step time, img/s, MFU and peak memory on both paths;
               Trainer.train() on synthetic 224 px data writes metrics.jsonl;
6. times    — each kernel against its twin, the unfused chain and (attention)
               PyTorch's fused SDPA, by CUDA events; forward latency at batch
               1 and 32 and img/s on the kernel and plain paths.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import statistics
import subprocess
import sys
import threading
import time
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
# kernel path vs plain path in training, same weights and batch, 12 bf16
# layers: loss within 1%, each parameter group's gradient within 5e-2
# relative L2 (the paths round at different points, as in serving)
TRAIN_LOSS_RTOL = 0.01
GRAD_REL_L2 = 5e-2

# NVIDIA's data sheet, H100 SXM: HBM3 rate (the dense bf16 peak is the
# trainer's, train.trainer.device_peak_flops)
PEAK_BYTES_PER_S = 3.35e12
# the Trainer's logged peak device memory against one kernel-path step's:
# the eval and the log_norms step allocate little beyond the step
TRAINER_PEAK_MARGIN = 1.05

KERNELS = {  # summary name → (source, TPU kernel it replaces)
    "qknorm_attn_fwd": ("nvit_tpu_torch/csrc/qknorm_attn_fwd.cu", "nvit_tpu/ops/flash_attention.py:389"),
    "qknorm_attn_bwd": ("nvit_tpu_torch/csrc/qknorm_attn_bwd.cu", "nvit_tpu/ops/flash_attention.py:558"),
    "gated_mlp_fwd": ("nvit_tpu_torch/csrc/gated_mlp_fwd.cu", "nvit_tpu/ops/gated_mlp.py:96"),
    "gated_mlp_bwd": ("nvit_tpu_torch/csrc/gated_mlp_bwd.cu", "nvit_tpu/ops/gated_mlp.py:104"),
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
    from nvit_tpu_torch.ops.flash_attention import qknorm_attention_bwd, qknorm_attention_fwd
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_fwd

    return {"qknorm_attn_fwd": qknorm_attention_fwd, "qknorm_attn_bwd": qknorm_attention_bwd,
            "gated_mlp_fwd": gated_mlp_fwd, "gated_mlp_bwd": gated_mlp_bwd_duv}


def reset_counts() -> None:
    for fn in launch_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in launch_counts().items()}


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
    from nvit_tpu_torch.ops._build import build, load_library

    phase("build")

    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, together
        for name, seconds in pool.map(timed, KERNELS):
            print(f"built {name} in {seconds:.3f} s")
    for name in KERNELS:
        load_library(name)


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
    for b, h, t, d in ((4, 12, 784, 64), (2, 4, 100, 32)):
        q, k, v, sqk = attn_inputs(b, h, t, d, seed=t)
        scale = float(d) ** 0.5
        o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
        o_ref, lse_ref = flash_attention_qknorm_ref(q, k, v, sqk, scale)
        torch.cuda.synchronize()
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        print(f"K1 [B={b}, H={h}, T={t}, D={d}] scale {scale:g}: max|o-o_ref| {eo:.3e}, max|lse-lse_ref| {el:.3e}")
        torch.testing.assert_close(o.float(), o_ref.float(), **KERNEL_TOL)
        torch.testing.assert_close(lse, lse_ref, **LSE_TOL)
        errs["qknorm_attn_fwd"] = max(errs["qknorm_attn_fwd"], eo)

    for b, h, t, d in ((4, 12, 784, 64), (2, 4, 100, 32)):  # strided QKV views, ragged T
        q, k, v, sqk, do = qkv_view_inputs(b, h, t, d, seed=t + 1)
        scale = float(d) ** 0.5
        o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
        got = qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do)
        want = qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do)
        torch.cuda.synchronize()
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
    return errs


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


def serve_phase(cfg, pred, plain) -> dict:
    from http.server import ThreadingHTTPServer

    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.serve import InferenceService, make_handler

    phase("serve nViT-B/16 over HTTP")
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
    per_forward = 1 + cfg.model.n_layer  # the shared cross-attention + every block
    print(f"launches in the served run: {launches} over {forwards} forwards")
    for name in ("qknorm_attn_fwd", "gated_mlp_fwd"):
        check(launches[name] == per_forward * forwards,
              f"{name} launched {launches[name]} times, expected {per_forward} per forward × {forwards}")
    for name in ("qknorm_attn_bwd", "gated_mlp_bwd"):
        check(launches[name] == 0, f"serving launched the backward kernel {name}")

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
    print(f"kernel vs plain path, batch 4: max|Δlogit| {dl:.3e} (logit std {spread:.3e}, "
          f"bound {LOGIT_TOL} × std), max|Δprob| {dp:.3e}, top-1 agreement {top1:.2f}")
    check(dl <= LOGIT_TOL * spread, "served logits disagree with the plain path")
    check(np.all(np.abs(full - plain_probs) <= PROB_RTOL * plain_probs + 1e-6),
          "served probabilities disagree with the plain path")
    return launches


def unfused_gate_bwd(x, w, g):
    """The gated_mlp_kernel="off" chain's work for K4's function: the cuBLAS
    bf16 GEMM recompute of [u | v], then the gate's backward in bf16 as
    autograd runs it (mul and SiLU backward) and the cat of du and dv."""
    u, v = torch.chunk(torch.nn.functional.linear(x, w), 2, dim=-1)
    sig = torch.sigmoid(v)
    return torch.cat([g * torch.nn.functional.silu(v), (g * u) * (sig * (1 + v * (1 - sig)))], dim=-1)


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
    )
    from nvit_tpu_torch.ops.gated_mlp import (
        gated_mlp_bwd_duv,
        gated_mlp_duv_ref,
        gated_mlp_fwd,
        gated_mlp_ref,
        gated_mlp_xla,
    )

    phase("times")
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
        x, w = mlp_inputs(n, d, hidden, seed=2)
        g = mlp_grad(n, hidden, seed=4)
        k3 = cuda_ms(lambda: gated_mlp_fwd(x, w))
        k3_plain = cuda_ms(lambda: gated_mlp_ref(x, w))
        # the gated_mlp_kernel="off" chain: cuBLAS bf16 matmul, then a bf16 gate
        k3_off = cuda_ms(lambda: gated_mlp_xla(x, w))
        k4 = cuda_ms(lambda: gated_mlp_bwd_duv(x, w, g))
        k4_plain = cuda_ms(lambda: gated_mlp_duv_ref(x, w, g))
        k4_off = cuda_ms(lambda: unfused_gate_bwd(x, w, g))
        print(f"K3 {what} [n={n}, K={d}, H={hidden}]: kernel {k3:.4f} ms, plain twin {k3_plain:.4f} ms, "
              f"unfused bf16 chain {k3_off:.4f} ms")
        print(f"K4 {what} [n={n}, K={d}, H={hidden}]: kernel {k4:.4f} ms, plain twin {k4_plain:.4f} ms, "
              f"unfused chain (cuBLAS recompute + bf16 gate backward) {k4_off:.4f} ms")
        if what == "c_fc":
            flops = 4 * n * d * hidden
            times["gated_mlp_fwd"] = dict(ms=k3, plain_ms=k3_plain, library_ms=None, **dict(zip(
                ("bound_ms", "bound_by"), bound(flops, (n * d + 2 * hidden * d + n * hidden) * 2))))
            times["gated_mlp_bwd"] = dict(ms=k4, plain_ms=k4_plain, library_ms=None, **dict(zip(
                ("bound_ms", "bound_by"), bound(flops, (n * d + 2 * hidden * d + 3 * n * hidden) * 2))))
        del x, w, g
    for name, tm in times.items():
        print(f"{name}: bound {tm['bound_ms']:.4f} ms ({tm['bound_by']}), kernel at "
              f"{100 * tm['bound_ms'] / tm['ms']:.1f}% of it")

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


def sync_step(step, state, images, labels):
    out = step(state, images, labels)
    torch.cuda.synchronize()
    return out


def train_phase(smi: str) -> dict:
    import re
    import shutil
    import tempfile

    from nvit_tpu_torch.configs import AugmentationConfig
    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.data.datasets import make_synthetic
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.models.vit import ViT, estimate_flops_per_iter, num_params
    from nvit_tpu_torch.train.optim import init_fused_adamw
    from nvit_tpu_torch.train.state import TrainState, create_train_state
    from nvit_tpu_torch.train.step import make_loss_fn, make_train_step
    from nvit_tpu_torch.train.trainer import Trainer

    phase("train nViT-B/16 (flagship_config: batch 32, bf16, fp32 params and moments, no remat)")
    cfg = flagship_config()
    m = cfg.model
    check(m.flash_attn and m.use_nvit and not cfg.system.remat and cfg.training.batch_size == 32,
          "flagship training config drifted")
    b = cfg.training.batch_size
    data = make_synthetic(num_examples=b, image_size=m.image_size, num_classes=m.num_classes, seed=0)
    images = normalize(torch.from_numpy(data.images).cuda())
    labels = torch.from_numpy(data.labels).cuda().long()
    state = create_train_state(cfg, seed=0, device="cuda")
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(m, flash_attn=False, gated_mlp_kernel="off"))
    plain_model = ViT(plain_cfg.model, device="cuda")
    plain_model.load_state_dict(state.model.state_dict(), strict=True)

    # the kernel path's loss and gradients against the plain path's
    losses, grads = {}, {}
    for name, model, c in (("kernel", state.model, cfg), ("plain", plain_model, plain_cfg)):
        loss, _ = make_loss_fn(c)(model, images, labels)
        loss.backward()
        losses[name] = loss.item()
        grads[name] = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    dl = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    print(f"loss: kernel path {losses['kernel']:.6f}, plain path {losses['plain']:.6f} "
          f"(relative gap {dl:.3e}, bound {TRAIN_LOSS_RTOL})")
    check(dl <= TRAIN_LOSS_RTOL, "the kernel path's loss disagrees with the plain path's")
    grouped = set()
    worst = 0.0
    for group, pattern in GRAD_GROUPS.items():
        names = [n for n in grads["plain"] if re.fullmatch(pattern, n)]
        grouped.update(names)
        gk = torch.cat([grads["kernel"][n].flatten() for n in names])
        gp = torch.cat([grads["plain"][n].flatten() for n in names])
        rel = rel_l2(gk, gp)
        worst = max(worst, rel)
        print(f"grad {group} ({len(names)} tensors, {gp.numel()} values): relative L2 {rel:.3e}")
    check(grouped == set(grads["plain"]) == set(grads["kernel"]), "a gradient is in no group")
    check(worst <= GRAD_REL_L2, f"gradients disagree with the plain path: worst group {worst:.3e}")
    del grads
    for model in (state.model, plain_model):
        model.zero_grad(set_to_none=True)

    # one make_train_step step launches every kernel once per block and once
    # for the shared cross-attention
    step = make_train_step(cfg)
    reset_counts()
    sync_step(step, state, images, labels)
    launches = read_counts()
    per_step = 1 + m.n_layer
    print(f"launches in one training step: {launches}")
    for name, count in launches.items():
        check(count == per_step, f"{name} launched {count} times in one step, expected {per_step}")

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
        got[name].append(host_ms(lambda: sync_step(fn, st, images, labels), 3))
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
    for name in ("qknorm_attn_bwd", "gated_mlp_bwd"):
        check(trainer_launches[name] == iters * per_step, f"Trainer: {name} launched {trainer_launches[name]}")
    for name in ("qknorm_attn_fwd", "gated_mlp_fwd"):
        check(trainer_launches[name] >= iters * per_step, f"Trainer: {name} launched {trainer_launches[name]}")
    shutil.rmtree(out_dir)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs only on the card", file=sys.stderr)
        return 1
    import gc

    from nvit_tpu_torch.configs import Config, ViTConfig
    from nvit_tpu_torch.infer import Predictor
    from nvit_tpu_torch.models.presets import preset
    from nvit_tpu_torch.models.vit import ViT

    smi = device_phase()
    build_phase()
    errs = kernel_phase()

    cfg = Config(model=ViTConfig(**preset("nvit-b16"), num_classes=1000))
    check(cfg.model.flash_attn and cfg.model.bounded_softmax == "rowmax", "flagship config drifted")
    pred = Predictor.from_config(cfg, seed=0, device="cuda")
    plain_cfg = dataclasses.replace(cfg.model, flash_attn=False, gated_mlp_kernel="off")
    plain_model = ViT(plain_cfg, device="cuda")
    plain_model.load_state_dict(pred.model.state_dict(), strict=True)
    plain = Predictor(plain_model, plain_cfg, device="cuda")

    serve_launches = serve_phase(cfg, pred, plain)
    times = time_phase(cfg, pred, plain)
    del pred, plain, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(smi)

    # launches: the forwards' from the serving path, the backwards' from one
    # training step (each path driven with every count set to 0 just before)
    launches = {**train_launches, "qknorm_attn_fwd": serve_launches["qknorm_attn_fwd"],
                "gated_mlp_fwd": serve_launches["gated_mlp_fwd"]}
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name], **times[name]}
        for name, (src, tpu) in KERNELS.items()
    ]}
    print(smi)  # the card and its power limit, as nvidia-smi gives them
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
