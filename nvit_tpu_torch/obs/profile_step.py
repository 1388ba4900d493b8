"""Where the time goes: ``torch.profiler`` over the flagship's training step
(and serving forward) on one CUDA card, in nViT and in baseline mode.

    python -m nvit_tpu_torch.obs.profile_step

Builds ``flagship_config()`` nViT-B/16, ``flagship_config(use_nvit=
False)``, the baseline ViT-B/16, ``flagship_config(bias=True)``,
nViT-B/16 as settings.yaml runs it, then ``flagship_config(use_kohonen=True,
kohonen_nodes=512)``, nViT-B/16 with its 512-node Kohonen SOM, with random
weights from a seed; for each
it warms up, then profiles ``STEPS`` training steps (kernel path) and as
many serving forwards, both at ``flagship_config()``'s batch: the shape
chip_smoke.py measures.  For each it prints the host-clock time
per step, the device's busy time (the sum of kernel times; the profiler's
"Command Buffer Full" rows are waits, not work, and are left out) and its
idle share, the time by group — K1–K9, cuBLAS GEMMs, everything else —
and the top kernels by device time.  Times come from the card; the script
refuses to run without one.  The profiler slows the host side, so the
step time here is above the untraced one chip_smoke.py reports.
"""

from __future__ import annotations

import subprocess
import time

import torch

STEPS = 3  # profiled steps (after two warm-up steps)
TOP = 15  # kernels listed by device time

# kernel-name substrings of the port's kernels (csrc/*.cu)
GROUPS = {
    "K1/K5 qknorm_attn_fwd": ("qknorm_attn_fwd_kernel",),
    "K2/K5 qknorm_attn_bwd": ("qknorm_attn_bwd_",),
    "QK-norm projection prologue": ("qknorm_project_kernel",),
    "K3/K6 gated_mlp_fwd": ("gated_mlp_fwd_kernel",),
    "K4/K6 gated_mlp_bwd": ("gated_mlp_bwd_kernel",),
    "K7 flash_attn_fwd": ("flash_attn_fwd_kernel",),
    "K8/K9 flash_attn_bwd": ("flash_attn_bwd_",),
    "K8/K9 backward prologue": ("flash_project_kernel",),
    "cuBLAS GEMMs": ("gemm", "cutlass", "xmma", "cublas", "nvjet"),
}


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS.items():
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise, reductions, copies"


def profile(fn, steps: int) -> tuple[float, dict[str, float], list[tuple[str, float, int]]]:
    """→ (host ms per step, device ms per step by group, top kernels)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    groups: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        # device events only: a host op (an aten op, an autograd Function)
        # also reports the time of the kernels it launched
        dev_us = ev.self_device_time_total
        if ev.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0 or "Command Buffer Full" in ev.key:
            continue
        groups[group_of(ev.key)] = groups.get(group_of(ev.key), 0.0) + dev_us / 1e3 / steps
        kernels.append((ev.key, dev_us / 1e3 / steps, ev.count // steps))
    kernels.sort(key=lambda k: -k[1])
    return host_ms, groups, kernels


def report(what: str, host_ms: float, groups: dict[str, float], kernels) -> None:
    busy = sum(groups.values())
    print(f"== {what}: {host_ms:.3f} ms per step on the host clock; device busy {busy:.3f} ms "
          f"({100 * busy / host_ms:.1f}%), idle share {100 * (1 - busy / host_ms):.1f}%; "
          f"{sum(k[2] for k in kernels)} kernel launches per step")
    for group, ms in sorted(groups.items(), key=lambda g: -g[1]):
        print(f"  {group:32s} {ms:9.3f} ms  {100 * ms / busy:5.1f}% of device time")
    print(f"  top {TOP} kernels (ms per step, launches per step):")
    for name, ms, count in kernels[:TOP]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device — device times come only from the card")
    from nvit_tpu_torch.data.augment import normalize
    from nvit_tpu_torch.data.datasets import make_synthetic
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.train.state import compute_dtype_of, create_train_state
    from nvit_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}")
    for mode, cfg in (("nViT-B/16", flagship_config()), ("baseline ViT-B/16", flagship_config(use_nvit=False)),
                      ("nViT-B/16, bias=True", flagship_config(bias=True)),
                      ("nViT-B/16 + 512-node Kohonen SOM", flagship_config(use_kohonen=True, kohonen_nodes=512))):
        m, b = cfg.model, cfg.training.batch_size
        data = make_synthetic(num_examples=b, image_size=m.image_size,
                              num_classes=m.num_classes, seed=0)
        images = normalize(torch.from_numpy(data.images).cuda())
        labels = torch.from_numpy(data.labels).cuda().long()
        state = create_train_state(cfg, seed=0, device="cuda")
        step = make_train_step(cfg, log_norms=False)
        for _ in range(2):
            step(state, images, labels)
        report(f"{mode} training step, batch {b} (kernel path)",
               *profile(lambda: step(state, images, labels), STEPS))

        dt = compute_dtype_of(cfg)
        model = state.model.eval()

        def forward():
            with torch.inference_mode():
                model(images, compute_dtype=dt)

        forward()
        report(f"{mode} serving forward, batch {b} (kernel path)", *profile(forward, STEPS))
        del state, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
