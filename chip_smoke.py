#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (nvit_tpu_torch) on one NVIDIA H100.

Run from the root of a checkout, with one CUDA card and nvcc::

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero with no result):

1. device   — card name and power limit, torch/CUDA versions; requires
               compute capability 9.0; TF32 off for matmuls and cuDNN;
2. build    — compiles the kernels from nvit_tpu_torch/csrc/;
3. kernels  — K1 (QK-norm flash attention fwd) and K3 (gated MLP fwd) against
               their plain PyTorch twins at the main path's shapes and at
               ragged ones;
4. serve    — nViT-B/16 (random weights from a seed) behind InferenceService
               + make_handler on a local ThreadingHTTPServer: /predict at
               batches 1, 4 and 32, /healthz, /stats; each kernel must launch
               13 times per forward; served probabilities against the same
               weights on the plain path (flash_attn=False, gated MLP off);
5. times    — each kernel against its twin (CUDA events), forward latency at
               batch 1 and 32 and img/s on the kernel and plain paths.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import statistics
import subprocess
import sys
import threading
import time

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
    return smi


def build_phase() -> None:
    from nvit_tpu_torch.ops._build import load_library

    phase("build")
    for name in ("qknorm_attn_fwd", "gated_mlp_fwd"):
        t0 = time.perf_counter()
        load_library(name)
        print(f"built {name} in {time.perf_counter() - t0:.3f} s")


def attn_inputs(b, h, t, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    sqk = 1.0 + 0.1 * torch.randn(h, d, generator=g, device="cuda")
    return q, k, v, sqk


def mlp_inputs(n, k, h, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.randn(2 * h, k, generator=g, device="cuda") / k ** 0.5).to(torch.bfloat16)
    return x, w


def kernel_phase() -> dict:
    from nvit_tpu_torch.ops.flash_attention import flash_attention_qknorm_ref, qknorm_attention_fwd
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_fwd, gated_mlp_ref

    phase("kernels vs plain twins")
    print(f"tolerance: outputs {KERNEL_TOL}, lse {LSE_TOL}")
    errs = {"K1": 0.0, "K3": 0.0}
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
        errs["K1"] = max(errs["K1"], eo)
    for n, k, h, what in ((4 * 784, 768, 3072, "c_fc"), (4 * 784, 768, 768, "proj"),
                          (784 + 17, 768, 768, "ragged")):
        x, w = mlp_inputs(n, k, h, seed=n + h)
        out = gated_mlp_fwd(x, w)
        ref = gated_mlp_ref(x, w)
        torch.cuda.synchronize()
        e = max_err(out, ref)
        print(f"K3 {what} [n={n}, K={k}, H={h}]: max|out-ref| {e:.3e}")
        torch.testing.assert_close(out.float(), ref.float(), **KERNEL_TOL)
        errs["K3"] = max(errs["K3"], e)
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
    from nvit_tpu_torch.ops.flash_attention import qknorm_attention_fwd
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_fwd
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
        qknorm_attention_fwd.launches = 0
        gated_mlp_fwd.launches = 0
        t0 = time.perf_counter()
        r1 = post(addr, "/predict", images[1][0].tobytes(), "application/octet-stream")
        r4 = post(addr, "/predict", json.dumps({"images": images[4].tolist(), "top_k": n_cls}).encode(),
                  "application/json")
        r32 = post(addr, "/predict", json.dumps({"images": images[32].tolist(), "top_k": 5}).encode(),
                   "application/json")
        served_s = time.perf_counter() - t0
        launches = {"K1": qknorm_attention_fwd.launches, "K3": gated_mlp_fwd.launches}
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
    for name, count in launches.items():
        check(count == per_forward * forwards,
              f"{name} launched {count} times, expected {per_forward} per forward × {forwards}")

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


def time_phase(cfg, pred, plain) -> dict:
    from nvit_tpu_torch.ops.attention import attention_qknorm
    from nvit_tpu_torch.ops.flash_attention import flash_attention_qknorm_ref, qknorm_attention_fwd
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_fwd, gated_mlp_ref, gated_mlp_xla

    phase("times")
    b = 32
    d, h = cfg.model.n_embd, cfg.model.n_head
    t = cfg.model.n_patches
    q, k, v, sqk = attn_inputs(b, h, t, d // h, seed=1)
    scale = float(d // h) ** 0.5
    k1 = cuda_ms(lambda: qknorm_attention_fwd(q, k, v, sqk, scale))
    k1_plain = cuda_ms(lambda: flash_attention_qknorm_ref(q, k, v, sqk, scale))
    # the flash_attn=False chain (projection + sdpa, fp32 logits) for reference
    k1_off = cuda_ms(lambda: attention_qknorm(q, k, v, sqk, scale, use_flash=False))
    print(f"K1 [B={b}, H={h}, T={t}, D={d // h}]: kernel {k1:.4f} ms, plain twin {k1_plain:.4f} ms, "
          f"flash_attn=False chain {k1_off:.4f} ms")
    times = {"K1": (k1, k1_plain)}
    for hidden, what in ((4 * d, "c_fc"), (d, "proj")):
        x, w = mlp_inputs(b * t, d, hidden, seed=2)
        k3 = cuda_ms(lambda: gated_mlp_fwd(x, w))
        k3_plain = cuda_ms(lambda: gated_mlp_ref(x, w))
        # the gated_mlp_kernel="off" chain: cuBLAS bf16 matmul, then a bf16 gate
        k3_off = cuda_ms(lambda: gated_mlp_xla(x, w))
        print(f"K3 {what} [n={b * t}, K={d}, H={hidden}]: kernel {k3:.4f} ms, plain twin {k3_plain:.4f} ms, "
              f"unfused bf16 chain {k3_off:.4f} ms")
        if what == "c_fc":
            times["K3"] = (k3, k3_plain)

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this smoke test runs only on the card", file=sys.stderr)
        return 1
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

    launches = serve_phase(cfg, pred, plain)
    times = time_phase(cfg, pred, plain)

    sources = {
        "K1": ("qknorm_attn_fwd", "nvit_tpu_torch/csrc/qknorm_attn_fwd.cu",
               "nvit_tpu/ops/flash_attention.py:389"),
        "K3": ("gated_mlp_fwd", "nvit_tpu_torch/csrc/gated_mlp_fwd.cu",
               "nvit_tpu/ops/gated_mlp.py:96"),
    }
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[key], "max_abs_err": errs[key],
         "ms": times[key][0], "plain_ms": times[key][1]}
        for key, (name, src, tpu) in sources.items()
    ]}
    print(smi)  # the card and its power limit, as nvidia-smi gives them
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
