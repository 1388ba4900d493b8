"""The port's train step on four gloo ranks (CPU) laid out as data 2 ×
model 2 — tensor parallelism, and tensor parallelism with FSDP — against
the JAX package's step on the global batch, at the tiny config of
tests/test_parallel.py:18 (biases, the Kohonen SOM) and its baseline twin,
gradient accumulation 2, fp32 (≙ tests/test_parallel.py:69 dp4_tp2 and
tests/test_fsdp.py:64 dp4_tp2_fsdp, :96):

* each rank's metrics and the whole parameters after 1 and 3 steps against
  ``nvit_tpu.train.step.make_train_step`` on the concatenated batch, and
  against the port's one-process step element by element;
* the replicated parameters and moments bit-equal on all four ranks;
* each rank's pieces (its model shard cut again over the data axis under
  FSDP) placed as the u|v layout says and joined to the gathered whole.

The four ranks run in one spawn for the module (``tests/torch_dp_worker.py``).
"""

import pytest
import torch

from tests.torch_dp import run_ranks
from tests.torch_tp_cases import (
    MODELS,
    STEPS,
    assert_matches_jax,
    assert_matches_one_process,
    jax_steps,
    job,
    join,
    one_process,
    piece,
    trunk_dim,
)

torch.set_num_threads(1)

WORLD = 4
RUNS = {f"{model}-{layout}": (model, layout) for model in MODELS for layout in ("tp2x2", "fsdp2x2")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results of every run, from one spawn."""
    tmp = tmp_path_factory.mktemp("tp_grid")
    jobs = [job(name, model, layout, tmp / name) for name, (model, layout) in RUNS.items()]
    return {j["name"]: j for j in jobs}, run_ranks(jobs, tmp / "out", world=WORLD)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_steps(tmp_path_factory.mktemp("unused"))


@pytest.mark.parametrize("run", list(RUNS))
def test_grid_matches_the_jax_step_on_the_global_batch(ranks, jax_runs, run):
    """After 1 and 3 steps, on each of the four ranks: the metrics within
    rtol 1e-5 / atol 1e-6, the update within 1e-5 relative L2 (baseline
    1e-4), each map's nodes within 1e-5 (tests/test_torch_dp_step.py's)."""
    _, results = ranks
    model, _ = RUNS[run]
    for rank, got in enumerate(results):
        for steps in (1, STEPS):
            assert_matches_jax(got[run], jax_runs[model], model, steps, f"{run} rank {rank} step {steps}")


@pytest.mark.parametrize("run", list(RUNS))
def test_grid_matches_one_process_element_by_element(ranks, tmp_path, run):
    """The metrics within rtol 1e-5 / atol 1e-6 of the port's one-process
    step after three steps, the whole parameters too but for at most
    ``OFF_TOL_ELEMENTS`` elements, each within 1e-5 (ROADMAP.md §3)."""
    _, results = ranks
    model, _ = RUNS[run]
    metrics, params = one_process(model, tmp_path)
    for got in results:
        assert_matches_one_process(got[run], metrics, params)


@pytest.mark.parametrize("run", ["kohonen-tp2x2", "kohonen-fsdp2x2"])
def test_grid_replicas_and_pieces(ranks, run):
    """Rank r is (data r // 2, model r % 2); the four ranks' replicated
    parameters and moments are bit-equal, and so are the metrics; each
    rank's pieces of the trunk are its (data, model) piece of the gathered
    whole (c_fc: the model shard's u and v rows, then under FSDP the data
    piece of that), its moments shaped alike, and the pieces join to the
    whole."""
    _, results = ranks
    layout = RUNS[run][1]
    ps = [got[run]["pieces"] for got in results]
    assert [p["coords"] for p in ps] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    whole = results[0][run]["params"][-1]
    for p in ps:
        for key in ("params", "mu", "nu"):
            for name, t in p[key].items():
                if trunk_dim(name) is None:
                    assert torch.equal(t, ps[0][key][name]), (key, name)
        for name, t in p["params"].items():
            assert torch.equal(t, piece(name, whole[name], p["coords"], layout)), name
            assert p["mu"][name].shape == t.shape, name
    for name in whole:
        assert torch.equal(join(name, ps, "params", layout), whole[name]), name
        assert torch.equal(join(name, ps, "nu", layout), results[0][run]["nu"][name]), name
    d = 32
    shard = (8 * d // 2 // (2 if layout == "fsdp2x2" else 1), d)
    assert all(p["params"]["transformer.h.1.c_fc.weight"].shape == shard for p in ps)
    assert all(got[run]["metrics"] == results[0][run]["metrics"] for got in results)
