"""A whole run of a cell, but for the look for a card, on the CPU at
nViT-tiny size: sound, it comes out correct; with the timed path broken
underneath, as each of the faults the cell can have breaks it, ``correct``
comes out false.  The training cells run the program in float32 here: the
limits were set for bf16 at the published widths, which a tiny bf16 model
does not match, and every fault reads far above them either way."""

from __future__ import annotations

import json
import socket
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from benchmark import run as bench
from benchmark.tests.tiny import tiny_cell

SEED = 2**34 + 5
CPU = torch.device("cpu")


def run(name: str, seconds: float = 0.5, trace: bool = False) -> dict:
    cell = tiny_cell(name, fp32=name.endswith(".train"))
    out, _ = bench.run_cell(cell, SEED, seconds, trace, CPU, time.time())
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_sound_training_run_is_correct(trace):
    out = run("nvit-b16.train", trace=trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    assert set(out["metrics"]) <= {m["name"] for m in tiny_cell("nvit-b16.train").per_layer} if trace else \
        set(out["metrics"]) == {"setup_s", "train_img_s"}  # no device memory on the CPU


def test_sound_serving_run_is_correct():
    out, rec = bench.run_cell(tiny_cell("nvit-b16.serve"), SEED, 1.0, False, CPU, time.time())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 50
    assert set(out["metrics"]) == {"setup_s"}  # no device memory on the CPU
    assert 0 < bench.reader("latency_p95_ms.serve")(rec) < float("inf")  # the tail, read per layer


def _wrap_step(monkeypatch, broken):
    import nvit_tpu_torch.train.step as step_mod

    make = step_mod.make_train_step

    def make_broken(*a, **kw):
        return broken(make(*a, **kw))

    monkeypatch.setattr(step_mod, "make_train_step", make_broken)


def test_step_that_returns_its_state_unchanged(monkeypatch):
    def broken(step):
        def unchanged(state, images, labels):
            params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            mu = {n: m.clone() for n, m in state.opt_state.mu.items()}
            nu = {n: v.clone() for n, v in state.opt_state.nu.items()}
            state, metrics = step(state, images, labels)
            with torch.no_grad():
                for n, p in state.model.named_parameters():
                    p.copy_(params[n])
            state.opt_state.mu, state.opt_state.nu = mu, nu
            return state, metrics
        return unchanged

    _wrap_step(monkeypatch, broken)
    out = run("nvit-b16.train")
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.99


def test_half_of_the_batch_left_out(monkeypatch):
    def broken(step):
        return lambda state, images, labels: step(state, images[: len(images) // 2], labels[: len(labels) // 2])

    _wrap_step(monkeypatch, broken)
    out = run("nvit-b16.train")
    assert not out["correct"], out["checks"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from nvit_tpu_torch.infer import Predictor

    probs = Predictor.predict_probs
    monkeypatch.setattr(Predictor, "predict_probs", lambda self, x: np.ascontiguousarray(probs(self, x)[:, ::-1]))
    out = run("nvit-b16.serve", seconds=1.0)
    assert not out["correct"] and out["checks"]["mean_logp_gap"]["value"] > out["checks"]["mean_logp_gap"]["limit"]


def _rank(rank: int, world: int, port: int, no_exchange: bool, results) -> None:
    import os

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import nvit_tpu_torch.train.step as step_mod
    from nvit_tpu_torch.parallel.mesh import destroy, init_data_parallel

    if no_exchange:
        step_mod.reduce_gradients_ = lambda *a, **kw: None
    group = init_data_parallel("cpu")
    cell = tiny_cell("nvit-b16.train-dp4", fp32=True)
    cell.workload["chips"] = world
    try:
        done = bench.run_cell(cell, SEED, 0.5, False, CPU, time.time(), group)
    finally:
        destroy(group)
    if done is not None:
        results.put(done[0])


@pytest.mark.parametrize("no_exchange", [False, True])
def test_data_parallel_exchange(no_exchange):
    """Two gloo ranks: sound, correct against the reference on the global
    batch; with the exchange between ranks left out, not correct."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, no_exchange, results)) for r in range(2)]
    for p in procs:
        p.start()
    out = results.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert out["correct"] is (not no_exchange), out["checks"]


@pytest.mark.parametrize("loads", [None, "jax", "nvit_tpu"])
def test_every_launched_rank_looks_for_the_jax_package(loads, monkeypatch, capfd):
    """Two ranks launched as a card's cell launches them, over gloo: sound,
    rank 0's line is relayed; where rank 1 has loaded ``jax`` or the JAX
    package, the launch fails and prints no result."""
    cell = tiny_cell("nvit-b16.train-dp4", fp32=True)
    cell.workload["chips"] = 2
    if loads:
        monkeypatch.setenv("BENCHMARK_TEST_LOADS", f"1:{loads}")
    argv = ["--workload", "nvit-b16.train-dp4", "--seed", str(SEED), "--seconds", "0.5", "--trace", "0"]
    code = bench.launch(argv, cell, child=(sys.executable, "-m", "benchmark.tests.cpu_rank"))
    captured = capfd.readouterr()
    lines = captured.out.strip().splitlines()
    if loads:
        assert code != 0 and not lines and f"the run loaded ['{loads}']" in captured.err
    else:
        assert code == 0 and json.loads(lines[-1])["correct"], captured.err[-3000:]


def test_a_new_traffic_kind_is_found_by_name(monkeypatch):
    """A workload names its traffic module by ``kind``: a module added as
    ``benchmark.traffic.<kind>`` drives the cell, and the readers read its
    record, with no file of the harness edited."""
    from benchmark.record import Run

    def drive(cell, seed, seconds, trace, device, t_start, group=None):
        run = Run(model=cell.model, workload=cell.workload, chips=cell.chips, setup_s=1.5, window_s=2.0,
                  counters={"attempted": 8, "failed": 0, "steps": 4, "images": 32, "rows": 32, "rows_s": 2.0})
        return run, {"loss_gap": 0.0, "recon_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}

    monkeypatch.setitem(sys.modules, "benchmark.traffic.fake",
                        types.SimpleNamespace(drive=drive, readings=lambda *a, **kw: iter(())))
    cell = tiny_cell("nvit-b16.train")
    cell.workload["kind"] = "fake"
    out, _ = bench.run_cell(cell, SEED, 2.0, False, CPU, time.time())
    assert out["correct"] and out["attempted"] == 8
    assert out["metrics"]["train_img_s"]["value"] == 16.0 and out["metrics"]["setup_s"]["value"] == 1.5
