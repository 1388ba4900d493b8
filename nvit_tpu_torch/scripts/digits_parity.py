"""Digits parity: the project's three profiles — the baseline ViT, nViT,
and nViT with the Kohonen SOM — trained by ``python -m nvit_tpu_torch`` on
scikit-learn's bundled digits,
with the settings of ``scripts/digits_matrix.sh`` (16 px, 4 layers, 4
heads, d = 128, patches 4/8, batch 64, 2000 iterations, lr 1e-3 with 100
warmup iterations, an eval every 250, fp32, augmentation on), over several
seeds, to hold against the JAX package's record of that script.

    python -m nvit_tpu_torch.scripts.digits_parity --device cpu [--profiles nvit1_k1]
        [--seeds 0 1 2 3 4] [--jobs 2] [--out DIR]

Each (profile, seed) runs in its own process on ``--device`` (the card by
default, where ``dataset: digits`` raises for want of scikit-learn; pass
``--device cpu``) with
``NVIT_TRAINING__SEED`` set (the weights, the epoch order and the
augmentation key follow it) and the profile's variables from
``profiles/<name>.env``; the rest is the packaged ``settings.yaml``
(biases, remat, AutoAugment).  Prints one line per run — the best
held-out top-1 over its evals — and per profile the mean, the standard
deviation and the range, then one JSON line with all of them, which names
the device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from nvit_tpu_torch.configs import read_dotenv

REPO = Path(__file__).resolve().parents[2]
PROFILES = ("nvit0_k0", "nvit1_k0", "nvit1_k1")
# scripts/digits_matrix.sh's settings (AUG defaults to true there)
SETTINGS = {
    "NVIT_DATA__DATASET": "digits", "NVIT_MODEL__IMAGE_SIZE": "16", "NVIT_MODEL__N_LAYER": "4",
    "NVIT_MODEL__N_HEAD": "4", "NVIT_MODEL__N_EMBD": "128", "NVIT_MODEL__NUM_CLASSES": "10",
    "NVIT_MODEL__LOCAL_PATCH_SIZE": "4", "NVIT_MODEL__GLOBAL_PATCH_SIZE": "8",
    "NVIT_MODEL__KOHONEN_NODES": "32", "NVIT_TRAINING__BATCH_SIZE": "64",
    "NVIT_TRAINING__EVAL_INTERVAL": "250", "NVIT_TRAINING__LOG_INTERVAL": "250",
    "NVIT_TRAINING__EVAL_ITERS": "5", "NVIT_TRAINING__EARLY_STOPPING_PATIENCE": "100",
    "NVIT_OPTIMIZER__LEARNING_RATE": "0.001", "NVIT_OPTIMIZER__WARMUP_ITERS": "100",
    "NVIT_SYSTEM__USE_DDP": "false", "NVIT_SYSTEM__USE_TQDM": "false", "NVIT_SYSTEM__DTYPE": "float32",
    "NVIT_SYSTEM__USE_AMP": "false", "NVIT_DATA__AUGMENTATION__ENABLED": "true",
}


def run(name: str, seed: int, iters: int, out: Path, threads: int, device: str) -> float:
    """One training run → its best held-out top-1 (%)."""
    run_dir = out / f"{name}_s{seed}"
    run_dir.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("NVIT_")}
    env.update(read_dotenv(REPO / "profiles" / f"{name}.env"))
    env.update(SETTINGS)
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS=str(threads), NVIT_SYSTEM__DEVICE=device,
               NVIT_TRAINING__SEED=str(seed), NVIT_TRAINING__MAX_ITERS=str(iters),
               NVIT_OPTIMIZER__LR_DECAY_ITERS=str(iters), NVIT_DATA__OUT_DIR=str(run_dir / "out"),
               NVIT_DATA__CHECKPOINT_DIR=str(run_dir / "out"), NVIT_DATA__DATA_DIR=str(run_dir / "data"))
    with open(run_dir / "run.log", "w") as log:
        rc = subprocess.run([sys.executable, "-m", "nvit_tpu_torch"], cwd=run_dir, env=env, stdout=log,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"{name} seed {seed} exited {rc}; see {run_dir / 'run.log'}")
    lines = [json.loads(x) for x in (run_dir / "out" / "metrics.jsonl").read_text().splitlines()]
    return max(x["val/top1_accuracy"] for x in lines if "val/top1_accuracy" in x)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="the device of every run: cuda (the card) or cpu")
    p.add_argument("--profiles", nargs="+", choices=PROFILES, default=list(PROFILES))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--jobs", type=int, default=2, help="runs at once")
    p.add_argument("--threads", type=int, default=2, help="torch threads per run")
    p.add_argument("--out", type=Path, default=None, help="run directories (default: a temporary one)")
    args = p.parse_args(argv)
    out = args.out or Path(tempfile.mkdtemp(prefix="digits_parity_"))
    runs = [(name, seed) for name in args.profiles for seed in args.seeds]
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        best = list(pool.map(lambda r: run(*r, args.iters, out, args.threads, args.device), runs))
    result = {}
    for (name, seed), top1 in zip(runs, best):
        print(f"{name} seed {seed}: best held-out top-1 {top1:.4f} %")
    for name in args.profiles:
        got = [b for (n, _), b in zip(runs, best) if n == name]
        result[name] = {"best_top1": got, "mean": statistics.mean(got),
                        "stdev": statistics.stdev(got) if len(got) > 1 else 0.0, "min": min(got), "max": max(got)}
        print(f"{name}: mean {result[name]['mean']:.4f} %, stdev {result[name]['stdev']:.4f}, "
              f"range {min(got):.4f}–{max(got):.4f} over {len(got)} seeds ({args.device})")
    print(json.dumps({"device": args.device, "iters": args.iters, "profiles": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
