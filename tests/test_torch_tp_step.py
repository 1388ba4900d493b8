"""The port's tensor-parallel and FSDP train steps on two gloo ranks (CPU)
against the JAX package's step on the global batch, at the tiny config of
tests/test_parallel.py:18 (biases, the Kohonen SOM) and its baseline twin,
gradient accumulation 2, fp32:

* data 1 × model 2 (``system.model_parallel=2``) and data 2 × model 1 with
  ``system.fsdp``: after 1 and 3 steps each rank's loss terms and
  per-group gradient norms, and the whole parameters gathered from its
  pieces, against ``nvit_tpu.train.step.make_train_step`` on the
  concatenated batch (the tolerances of tests/test_torch_dp_step.py), and
  element by element against the port's one-process step;
* the replicated parameters and moments stay bit-equal across the ranks
  over three steps, with fp32 moments and with bf16 "hash" moments;
* the FSDP pieces: shapes and placements (tests/test_fsdp.py:44's, under
  the port's u|v layout), the moments sharded as their parameters, and the
  renorm's unit norms after three steps (tests/test_fsdp.py:127).

Both ranks run in one spawn for the module (``tests/torch_dp_worker.py``).
"""

import pytest
import torch

from nvit_tpu_torch.parallel.mesh import param_specs
from tests.torch_dp import run_ranks
from tests.torch_tp_cases import (
    LAYOUTS,
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

WORLD = 2
RUNS = {f"{model}-{layout}": (model, layout) for model in MODELS for layout in ("tp1x2", "fsdp2x1")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results of every run, from one spawn."""
    tmp = tmp_path_factory.mktemp("tp_step")
    jobs = [job(name, model, layout, tmp / name) for name, (model, layout) in RUNS.items()]
    jobs.append(job("kohonen-tp1x2-bf16", "kohonen", "tp1x2", tmp / "bf16", moments_dtype="bfloat16",
                    sr_dither="hash"))
    return {j["name"]: j for j in jobs}, run_ranks(jobs, tmp / "out", world=WORLD)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return jax_steps(tmp_path_factory.mktemp("unused"))


@pytest.mark.parametrize("run", list(RUNS))
def test_layouts_match_the_jax_step_on_the_global_batch(ranks, jax_runs, run):
    """After 1 and 3 steps, on each rank: the metrics within rtol 1e-5 /
    atol 1e-6 of JAX's step on the global batch, the whole parameters'
    update within 1e-5 relative L2 (baseline 1e-4), each map's nodes within
    1e-5 (the Hebbian delta summed over the data ranks only)."""
    _, results = ranks
    model, layout = RUNS[run]
    for rank, got in enumerate(results):
        for steps in (1, STEPS):
            assert_matches_jax(got[run], jax_runs[model], model, steps, f"{run} rank {rank} step {steps}")


@pytest.mark.parametrize("run", list(RUNS))
def test_layouts_match_one_process_element_by_element(ranks, tmp_path, run):
    """The port's one-process step on the global batch gives what the two
    ranks give after three steps: the metrics within rtol 1e-5 / atol 1e-6,
    and the whole parameters element by element within the same tolerance
    but for at most ``OFF_TOL_ELEMENTS`` elements (ROADMAP.md §3), each
    within 1e-5 absolute (1% of the learning rate).  Measured: the baseline
    none; the Kohonen model 3 of 52,039 (data 1 × model 2, up to 6.5e-6;
    data 2 × model 1 FSDP, up to 3.2e-6)."""
    _, results = ranks
    model, _ = RUNS[run]
    metrics, params = one_process(model, tmp_path)
    for got in results:
        assert_matches_one_process(got[run], metrics, params)


@pytest.mark.parametrize("run", ["kohonen-tp1x2", "kohonen-tp1x2-bf16"])
def test_replicated_parameters_stay_bit_equal_across_ranks(ranks, run):
    """After every step both ranks' replicated parameters — everything
    outside the trunk's matrices, sqk and suv included — are bit-equal, and
    after the third their moments too (fp32, and bf16 with the "hash"
    dither), though rank 1 started from other weights (the Trainer
    broadcast rank 0's); the metrics are equal."""
    _, (r0, r1) = ranks
    a, b = r0[run], r1[run]
    assert a["pieces"]["coords"] == (0, 0) and b["pieces"]["coords"] == (0, 1)
    for pa, pb in zip(a["params"], b["params"]):
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name  # whole, gathered
    for key in ("params", "mu", "nu"):
        for name, t in a["pieces"][key].items():
            if trunk_dim(name) is None:
                assert torch.equal(t, b["pieces"][key][name]), (key, name)
                want = torch.bfloat16 if key != "params" and run.endswith("bf16") else torch.float32
                assert t.dtype == want, (key, name)
    assert a["metrics"] == b["metrics"]


def test_fsdp_pieces_shapes_placements_and_renorm(ranks):
    """data 2 × model 1, FSDP: each rank holds half of each trunk matrix
    along its renorm-free axis (c_fc rank 0 the u rows, rank 1 the v rows:
    tests/test_fsdp.py:44's shapes, the port's u|v placement), its moments
    shaped alike; the pieces join to the gathered whole; everything outside
    the trunk's matrices whole; the renorm's norms 1 within 1e-6 after three
    steps, read on the pieces."""
    jobs, results = ranks
    run = "kohonen-fsdp2x1"
    cfg = jobs[run]["cfg"]
    assert LAYOUTS["fsdp2x1"] == (1, True)
    ps = [got[run]["pieces"] for got in results]
    assert [p["coords"] for p in ps] == [(0, 0), (1, 0)]
    d = cfg.model.n_embd
    whole = results[0][run]["params"][-1]
    specs = param_specs(whole.items())
    assert specs["transformer.h.0.c_fc.weight"] == 0 and specs["transformer.h.0.mlp_c_proj.weight"] == 1
    assert specs["transformer.h.0.mlp_c_proj.bias"] is None and specs["mlp_head.1.weight"] is None
    for p in ps:
        assert p["params"]["transformer.h.0.c_fc.weight"].shape == (8 * d // 2, d)
        assert p["params"]["transformer.h.0.mlp_c_proj.weight"].shape == (d, 4 * d // 2)
        assert p["params"]["transformer.h.0.query.bias"].shape == (d // 2,)
        for name, t in p["params"].items():
            assert p["mu"][name].shape == p["nu"][name].shape == t.shape, name
            dim = trunk_dim(name)
            assert specs[name] == dim, name
            assert t.shape == (whole[name].shape if dim is None else piece(name, whole[name], p["coords"],
                                                                             "fsdp2x1").shape)
            assert torch.equal(t, piece(name, whole[name], p["coords"], "fsdp2x1")), name
    c_fc = whole["transformer.h.0.c_fc.weight"]
    assert torch.equal(ps[0]["params"]["transformer.h.0.c_fc.weight"], c_fc[:4 * d])  # u
    assert torch.equal(ps[1]["params"]["transformer.h.0.c_fc.weight"], c_fc[4 * d:])  # v
    last = results[0][run]
    for name in whole:
        assert torch.equal(join(name, ps, "params", "fsdp2x1"), last["params"][-1][name]), name
        assert torch.equal(join(name, ps, "mu", "fsdp2x1"), last["mu"][name]), name
    for p in ps:
        for name, t in p["params"].items():
            if name.endswith(".weight") and trunk_dim(name) is not None:
                # the renorm's axis is the one the pieces keep whole
                norms = torch.linalg.vector_norm(t, dim=1 - trunk_dim(name))
                torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-6, msg=name)
