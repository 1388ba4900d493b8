"""The readings that the limits of ``correct`` are set from, on the card at
a cell's own size: for each seed the program's numbers (its first steps,
or a short open loop at the cell's rate), and on the first seeds the
lower-precision control's and the planted faults'.

    python3 -m benchmark.control --workload nvit-b16.train --seeds 1-12 --control-seeds 3
    python3 -m torch.distributed.run --nproc-per-node 4 -m benchmark.control \\
        --workload nvit-b16.train-dp4 --seeds 1-12 --control-seeds 0

The cell's traffic module (``traffic/<kind>.py``, its ``readings``) says
what is read.  Training: the control is the reference in fp8
(``reference.model.fp8_quant`` on every operand of every product, the
forward's and the backward's) in the program's place; the faults are half
of each batch left out (the mean over the rest) and, over several ranks,
the exchange left out (rank 0's rows alone).  Serving: the control is the
program's own int8 path (``Predictor(quantize="int8")``); the fault is each
answer given to the next request of the sample.  One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def seeds(text: str) -> list[int]:
    out: list[int] = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="1-12")
    p.add_argument("--control-seeds", type=int, default=3, help="how many of the seeds also read the control")
    p.add_argument("--seconds", type=float, default=3.0, help="open-loop length of a serving reading")
    p.add_argument("--no-program", action="store_true", help="read the control and faults only")
    args = p.parse_args(argv)

    import torch

    from benchmark.spec import load_cell, traffic

    if not torch.cuda.is_available():
        print("the readings come from the card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    group = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from nvit_tpu_torch.parallel.mesh import init_data_parallel

        group = init_data_parallel("cuda")
        device = group.device
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    module = traffic(cell)
    for i, seed in enumerate(seeds(args.seeds)):
        t = time.perf_counter()
        for what, numbers in module.readings(cell, seed, device, group, program=not args.no_program,
                                             control=i < args.control_seeds, seconds=args.seconds):
            emit(seed=seed, what=what, **numbers)
        if group is None or group.rank == 0:
            print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    if group is not None:
        from nvit_tpu_torch.parallel.mesh import destroy

        destroy(group)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
