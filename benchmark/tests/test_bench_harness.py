"""The benchmark's files and arithmetic, on the CPU."""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import flops
from benchmark.traffic.serve import schedule
from benchmark.record import percentile
from benchmark.spec import HERE, ROOT, load_cell, port_config, reader, traffic
from benchmark.weights import make_weights

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_metrics(cell):
    c = load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == entry["config"] and c.workload["chips"] == entry["chips"]
    assert c.workload["why"] == entry["why"] and len(entry["why"]) <= 200
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"
    for m in c.end_to_end + c.per_layer:
        assert callable(reader(m["name"]))
    assert set(c.workload["limits"])
    module = traffic(c)
    assert callable(module.drive) and callable(module.readings)


def test_every_metric_has_its_reader_and_layer():
    readers = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert readers == {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("name,nvit", [("nvit-b16", True), ("vit-b16", False)])
def test_config_is_the_flagship(name, nvit):
    from nvit_tpu_torch.models.presets import flagship_config

    config = json.loads((HERE / "configs" / f"{name}.json").read_text())
    want = flagship_config(use_nvit=nvit)
    got = port_config(config)
    assert got.model == want.model
    assert dataclasses.replace(got.optimizer, scheduler=want.optimizer.scheduler) == want.optimizer
    assert got.training.batch_size == want.training.batch_size and got.system.remat == want.system.remat
    assert config["reduced"] == []


def test_flop_and_byte_counts_by_hand():
    # one attention call, B=1, H=2, T=4, D=8: q·kᵀ and p·v, 2·T·T·D multiply-adds each
    assert flops.attention_fwd(1, 2, 4, 8, False) == (2 * 2 * (2 * 4 * 4 * 8), 4 * 2 * 4 * 8 * 2)
    assert flops.attention_bwd(1, 2, 4, 8, False)[0] == 2.5 * flops.attention_fwd(1, 2, 4, 8, False)[0]
    # x [3, 5] · Wᵀ with W [2·7, 5]: 2·3·5·14 operations; x, W, out bf16
    assert flops.gated_fwd(3, 5, 7) == (2 * 3 * 5 * 14, (3 * 5 + 14 * 5 + 3 * 7) * 2)
    assert flops.bound_s(989e12, 0) == 1.0 and flops.bound_s(0, 3.35e12) == 1.0
    m = {"n_embd": 8, "n_head": 2, "n_layer": 1, "image_size": 8, "local_patch_size": 4, "global_patch_size": 8,
         "channels": 1, "num_classes": 3, "use_nvit": True}
    f = flops.forward_products(m)  # T = 4 tokens
    assert f["embed_local"] == 2 * 4 * 16 * 8 and f["embed_global"] == 2 * 4 * 64 * 8
    assert f["blocks"] == 2 * 4 * 8 * 24 + 4 * 16 * 8 + 2 * 4 * 8 * 8 + 2 * 4 * 8 * 64 + 2 * 4 * 32 * 8
    assert f["classifier_head"] == 2 * 8 * 3


def test_train_flops_against_the_programs_estimate():
    """The count from shapes lies within 2% of the program's 6N + 12·L·H·Q·T
    per token (which counts the position embeddings and the heads per token
    and leaves out the cross-attention's attention)."""
    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.models.vit import ViT, estimate_flops_per_iter

    for nvit in (True, False):
        cfg = flagship_config(use_nvit=nvit)
        n = sum(p.numel() for p in ViT(cfg.model, device="meta").parameters())
        ours = flops.train_flops_per_image(dataclasses.asdict(cfg.model))
        theirs = estimate_flops_per_iter(cfg.model, n)
        assert abs(ours / theirs - 1) < 0.02, (ours, theirs)


def test_schedule_same_gaps_for_every_seed():
    a, b = schedule(100.0, 3.0, 1), schedule(100.0, 3.0, 2**31 + 7)
    assert len(a) == len(b) == 300 and not np.array_equal(a, b)
    assert a[0] == b[0] == 0.0
    # each seed's gaps are the same quantiles, in another order, one left after the window
    quantiles = -np.log1p(-(np.arange(300) + 0.5) / 300) / 100.0
    for x in (a, b):
        left = list(quantiles)
        for g in np.diff(x):
            left.pop(int(np.argmin(np.abs(np.array(left) - g))))
        assert len(left) == 1
    assert abs(a[-1] - 3.0) < 0.2


def test_percentile_counts_failures_as_missing():
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0
    assert percentile(list(range(1, 101)), 95) == 95
    assert percentile([1.0] * 99 + [float("inf")], 99) == 1.0
    assert percentile([1.0] * 94 + [float("inf")] * 6, 95) == float("inf")


@pytest.mark.parametrize("nvit", [True, False])
def test_weights_load_into_the_program_strictly(nvit):
    from benchmark.tests.tiny import TINY_MODEL
    from nvit_tpu_torch.configs import ViTConfig
    from nvit_tpu_torch.models.vit import ViT

    m = dict(json.loads((HERE / "configs" / "nvit-b16.json").read_text())["model"], **TINY_MODEL, use_nvit=nvit)
    sd = make_weights(m, 2**40 + 3, "cpu")
    ViT(ViTConfig(**m), device="cpu").load_state_dict(sd, strict=True)
    again = make_weights(m, 2**40 + 3, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = make_weights(m, 2**40 + 4, "cpu")
    assert not torch.equal(sd["mlp_head.1.weight"], other["mlp_head.1.weight"])


FORBIDDEN = {"jax", "jaxlib", "flax", "nvit_tpu"}


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, benchmark.run, benchmark.control, benchmark.sweep, benchmark.traffic.train, "
            "benchmark.traffic.serve, benchmark.readers\n"
            "from benchmark.spec import reader\n"
            "import json; [reader(m['name']) for k in ('end_to_end', 'per_layer') "
            "for m in json.load(open('BENCHMARK.json'))[k]]\n"
            "import nvit_tpu_torch.infer, nvit_tpu_torch.serve, nvit_tpu_torch.train.step\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert not FORBIDDEN & set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.model, benchmark.reference.check\n"
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not (FORBIDDEN | {"nvit_tpu_torch"}) & loaded
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(n.split(".")[0] in FORBIDDEN | {"nvit_tpu_torch", "benchmark"} and
                               not n.startswith("benchmark.reference") for n in names), (path, names)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result; the
    same in a directory that holds only the benchmark's files."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    args = ["-m", "benchmark.run", "--workload", "nvit-b16.train", "--seed", str(2**33), "--seconds", "1"]
    out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    subprocess.run(["cp", "-r", str(HERE), str(tmp_path / "benchmark")], check=True)
    out = subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(tmp_path):
    """On a card: one short run of the first cell prints a correct line."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = ["-m", "benchmark.run", "--workload", CELLS[0], "--seed", str(2**33 + 1), "--seconds", "2"]
    out = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
