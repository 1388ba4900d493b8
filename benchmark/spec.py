"""What a run is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout, the cell's ``workloads/<cell>.json``, its configuration's
``configs/<config>.json``, the traffic module ``traffic/<kind>.py`` that
the workload names, and a reader ``metrics/<metric>.py`` for each metric
the cell reports.

Every traffic module has the same two entries:

* ``drive(cell, seed, seconds, trace, device, t_start, group=None)`` →
  (``record.Run``, the numbers that decide ``correct``, by the names of
  the workload's ``limits``; None on ranks but 0): one run of the cell;
* ``readings(cell, seed, device, group=None, program=True, control=True,
  seconds=...)`` → (what, numbers) pairs on rank 0: the program's
  numbers, and with ``control`` the lower-precision control's and the
  planted faults', that the limits are set from (``benchmark.control``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: list[dict] = field(default_factory=list)  # BENCHMARK.json entries this cell reports
    per_layer: list[dict] = field(default_factory=list)

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def model(self) -> dict:
        return self.config["model"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    config = json.loads((HERE / "configs" / f"{workload['config']}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return Cell(name, workload, config,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def traffic(cell: Cell):
    """The module ``traffic/<kind>.py`` that drives the cell."""
    return importlib.import_module(f"benchmark.traffic.{cell.workload['kind']}")


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def port_config(config: dict):
    """The program's ``Config`` for a configuration file: each section's
    fields over the program's defaults."""
    import dataclasses

    from nvit_tpu_torch.configs import Config, OptimizerConfig, SystemConfig, TrainingConfig, ViTConfig

    model = ViTConfig(**config["model"])
    model.validate()
    return Config(model=model,
                  training=dataclasses.replace(TrainingConfig(), **config["training"]),
                  optimizer=dataclasses.replace(OptimizerConfig(), **config["optimizer"]),
                  system=dataclasses.replace(SystemConfig(), **config["system"]))
