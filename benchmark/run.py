"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload nvit-b16.train --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell's files are found by name (see
``spec.py``); the program measured is ``nvit_tpu_torch`` on the card.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit,
which also end standard error.  Without a card, or with fewer cards than
the cell asks for, it prints no result and exits 2.  A cell on several
cards runs one process per card, launched here with the environment
``torchrun`` sets; rank 0's line is printed.  Every process looks for
``jax``, ``jaxlib``, ``flax`` and ``nvit_tpu`` among its modules once the
window has closed; one that finds any exits 3, and no result is printed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.spec import ROOT, Cell, load_cell, reader, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nvit_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
CHILD_TIMEOUT_S = 345


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # set for a launched rank
    return p.parse_args(argv)


def result(cell: Cell, run, correct: bool, checks: dict, trace: bool, device) -> dict:
    import torch

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = device.type == "cuda"  # a CPU run is the harness's own tests
    device = {"platform": "gpu" if on_card else "cpu", "kind": torch.cuda.get_device_name(device) if on_card
              else "cpu", "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": bool(correct), "attempted": int(run.counters["attempted"]),
           "failed": int(run.counters["failed"]), "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.counters["busy_s"]
        device["window_s"] = run.counters["trace_window_s"]
        gaps = (run.host_trace or run.trace).idle_gaps(10)
        out["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": gaps}
    out["checks"] = checks
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, group=None):
    """Drive the cell on ``device`` with its traffic module and judge it →
    (the result, the run), or None on ranks but 0."""
    from benchmark.reference import check

    run, numbers = traffic(cell).drive(cell, seed, seconds, trace, device, t_start, group)
    if numbers is None:
        return None
    ok, checks = check.judge(numbers, cell.workload["limits"])
    return result(cell, run, ok, checks, trace, device), run


def report(out: dict, run) -> None:
    """Stderr: what a reader of the run wants beside the line, the checks last."""
    from benchmark.device import card

    c = card()
    print(f"card: {c['name']}, power limit {c['power_limit']}", file=sys.stderr)
    print(run.summary, file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)


def launch(argv, cell: Cell, child: tuple[str, ...] = (sys.executable, "-m", "benchmark.run")) -> int:
    """One process per card, each ``child`` with ``argv`` and its rank;
    rank 0's line relayed where every rank exited 0."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(cell.chips):
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(cell.chips),
                   RANK=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(cell.chips),
                   BENCHMARK_T_START=repr(T_START))
        procs.append(subprocess.Popen([*child, *argv, "--rank", str(r)], env=env, cwd=ROOT,
                                      stdout=subprocess.PIPE if r == 0 else 2))  # 2: standard error
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    out = b""
    try:
        out = procs[0].communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        for p in procs[1:]:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        print("a rank did not end in time", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"ranks exited with {codes}", file=sys.stderr)
        return 1
    lines = out.decode().strip().splitlines()
    found = forbidden_modules()
    if found or not lines:
        print(f"loaded {found}" if found else "rank 0 printed no result", file=sys.stderr)
        return 1
    for name, v in json.loads(lines[-1])["checks"].items():  # the checks end standard error here too
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)
    print(lines[-1], flush=True)
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return launch(argv, cell)
    return rank_main(cell, args, "cuda")


def rank_main(cell: Cell, args, device_type: str) -> int:
    """This process's part of the run: the whole run on one card, or one
    rank of several (``device_type`` "cpu" only in the harness's tests) →
    its exit code.  The line is printed by the rank that judged the run."""
    import torch

    group = None
    t_start = T_START
    if cell.chips > 1:
        from nvit_tpu_torch.parallel.mesh import destroy, init_data_parallel

        t_start = float(os.environ["BENCHMARK_T_START"])
        group = init_data_parallel(device_type)
        device = group.device
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    try:
        done = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start, group)
    finally:
        if group is not None:
            destroy(group)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr, flush=True)
        return 3
    if done is None:
        return 0
    out, run = done
    report(out, run)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
