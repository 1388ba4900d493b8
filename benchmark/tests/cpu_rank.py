"""One rank of a cell on several cards, run on the CPU at nViT-tiny size
over gloo: ``benchmark.run``'s per-rank path, for the launcher's tests.

    python3 -m benchmark.tests.cpu_rank --workload nvit-b16.train-dp4 --seed 1 --seconds 0.5 --rank 1

The world comes from the launcher's environment.  With
``BENCHMARK_TEST_LOADS`` set to ``<rank>:<module>``, that rank puts a
module of that name among its modules before it runs, as a port that
loaded it would.
"""

from __future__ import annotations

import os
import sys
import types

import torch

from benchmark import run as bench
from benchmark.tests.tiny import tiny_cell


def main() -> int:
    args = bench.parse(sys.argv[1:])
    torch.set_num_threads(1)
    cell = tiny_cell(args.workload, fp32=True)
    cell.workload["chips"] = int(os.environ["WORLD_SIZE"])
    rank, _, name = os.environ.get("BENCHMARK_TEST_LOADS", "").partition(":")
    if name and int(rank) == args.rank:
        sys.modules[name] = types.ModuleType(name)
    return bench.rank_main(cell, args, "cpu")


if __name__ == "__main__":
    raise SystemExit(main())
