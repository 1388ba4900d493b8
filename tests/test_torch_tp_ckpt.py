"""Checkpoints of tensor-parallel and FSDP runs on two gloo ranks (CPU), at
the tiny Kohonen config of tests/torch_tp_cases.py:

* a data 1 × model 2 run and a data 2 × model 1 FSDP run take two steps
  from the seed and save: rank 0 alone writes (each rank has its own
  ``out_dir``), and ``nvit_tpu.ckpt`` restores the file bit-equal to the
  one-card file of the same state (the pieces joined here, saved by
  ``save_checkpoint``);
* the checkpoint resumes on the same layout, on the other one and on one
  process: the resumed pieces are the checkpoint's, bit for bit, and one
  more step on each layout agrees with the one-process step.

Both ranks run in one spawn for the module (``tests/torch_dp_worker.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt.tree import run_key
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models.vit import ViT
from nvit_tpu_torch.train.optim import FusedAdamWState
from nvit_tpu_torch.train.state import TrainState
from nvit_tpu_torch.train.trainer import Trainer
from tests.torch_dp import run_ranks
from tests.torch_tp_cases import LAYOUTS, OFF_TOL_ELEMENTS, TOL, batches, configs, join, piece

torch.set_num_threads(1)

WORLD = 2
SYSTEMS = {name: dict(model_parallel=mp, fsdp=fsdp) for name, (mp, fsdp) in LAYOUTS.items()
           if name in ("tp1x2", "fsdp2x1")}
RUNS = {"tp1x2": ["tp1x2", "fsdp2x1"], "fsdp2x1": ["fsdp2x1", "tp1x2"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Per layout: (its config, its directory), and the ranks' results, from one spawn."""
    tmp = tmp_path_factory.mktemp("tp_ckpt")
    jobs, runs = [], {}
    for layout, resume in RUNS.items():
        _, cfg = configs("kohonen", tmp / layout / "rank0", layout=layout)
        runs[layout] = (cfg, tmp / layout)
        jobs.append(dict(name=layout, cfg=cfg, batches=batches(cfg, steps=2), out_dir=str(tmp / layout),
                         resume=[(name, SYSTEMS[name]) for name in resume]))
    return runs, run_ranks(jobs, tmp / "out", world=WORLD)


def one_card_state(cfg, ranks_pieces: list, layout: str) -> TrainState:
    """The state the ranks' pieces make, whole, as one card holds it."""
    model = ViT(cfg.model, device="cpu")
    params = {n: join(n, ranks_pieces, "params", layout) for n in ranks_pieces[0]["params"]}
    model.load_state_dict({**model.state_dict(), **params}, strict=True)
    moments = [{n: join(n, ranks_pieces, key, layout) for n in ranks_pieces[0][key]} for key in ("mu", "nu")]
    step = ranks_pieces[0]["step"]
    return TrainState(model=model, opt_state=FusedAdamWState(step, *moments), step=step,
                      generator=torch.Generator(), rng=run_key(cfg.training.seed))


@pytest.mark.parametrize("layout", list(RUNS))
def test_checkpoint_restores_in_jax_bit_equal_to_the_one_card_file(ranks, tmp_path, layout):
    runs, results = ranks
    cfg, root = runs[layout]
    assert port_ckpt.checkpoint_exists(root / "rank0", "checkpoint_latest")
    assert not list((root / "rank1").glob("checkpoint_*"))  # rank 1 wrote nothing
    state = one_card_state(cfg, [got[layout]["saved"] for got in results], layout)
    port_ckpt.save_checkpoint(tmp_path, "one_card", state, cfg)
    got, _, meta = jax_ckpt.restore_for_resume(root / "rank0", "checkpoint_latest")
    want, _, _ = jax_ckpt.restore_for_resume(tmp_path, "one_card")
    assert meta["iter_num"] == 2 and int(got.step) == 2
    leaves_got, leaves_want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(leaves_got) == len(leaves_want)
    for a, b in zip(leaves_got, leaves_want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", list(RUNS))
def test_checkpoint_resumes_on_the_same_and_the_other_layout(ranks, tmp_path, layout):
    """Each resumed rank holds its (data, model) piece of the checkpoint's
    whole parameters and moments, bit for bit, at the saved step; one more
    step on each layout gives the one-process resumed step's parameters
    (rtol 1e-5 / atol 1e-6 but for at most ``OFF_TOL_ELEMENTS`` elements,
    each within 1e-5)."""
    runs, results = ranks
    cfg, root = runs[layout]
    whole, _, _ = port_ckpt.restore_for_resume(root / "rank0", "checkpoint_latest", device="cpu")
    params = dict(whole.model.named_parameters())
    one = resumed_one_process(cfg, root)
    for resumed_on in RUNS[layout]:
        for got in results:
            r = got[layout]["resumed"][resumed_on]
            assert r["step"] == 2
            for name, t in r["params"].items():
                assert torch.equal(t, piece(name, params[name].detach(), r["coords"], resumed_on)), name
                for key, moments in (("mu", whole.opt_state.mu), ("nu", whole.opt_state.nu)):
                    assert torch.equal(r[key][name], piece(name, moments[name], r["coords"], resumed_on))
            off = 0
            for name, p in one.items():
                err = (r["after"][name] - p).abs()
                off += int((err > TOL["atol"] + TOL["rtol"] * p.abs()).sum())
                assert float(err.max()) <= 1e-5, (resumed_on, name)
            assert off <= OFF_TOL_ELEMENTS, (resumed_on, off)


def resumed_one_process(cfg, root) -> dict:
    """One process resumes the checkpoint and takes one step on the last
    batch → its parameters."""
    system = dataclasses.replace(cfg.system, model_parallel=1, fsdp=False, use_ddp=False)
    one_cfg = dataclasses.replace(cfg, system=system, data=dataclasses.replace(
        cfg.data, checkpoint_dir=str(root / "rank0"), out_dir=str(root / "one")),
        training=dataclasses.replace(cfg.training, init_from="resume"))
    trainer = Trainer(one_cfg, device="cpu")
    imgs, labels = batches(cfg, steps=2)[-1]
    trainer._train_step(trainer.state, normalize(torch.from_numpy(imgs)), torch.from_numpy(labels))
    return {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()}


@pytest.mark.parametrize("layout", list(RUNS))
def test_checkpoint_resumes_on_one_process(ranks, layout):
    """One process resumes the two-rank checkpoint whole: its parameters
    and moments are the ranks' pieces joined, bit for bit."""
    runs, results = ranks
    cfg, root = runs[layout]
    system = dataclasses.replace(cfg.system, model_parallel=1, fsdp=False, use_ddp=False)
    trainer = Trainer(dataclasses.replace(cfg, system=system, training=dataclasses.replace(
        cfg.training, init_from="resume"), data=dataclasses.replace(
        cfg.data, checkpoint_dir=str(root / "rank0"), out_dir=str(root / "one-check"))), device="cpu")
    saved = [got[layout]["saved"] for got in results]
    assert trainer.iter_num == 2 and trainer.state.opt_state.count == 2
    for name, p in trainer.state.model.named_parameters():
        assert torch.equal(p.detach(), join(name, saved, "params", layout)), name
        assert torch.equal(trainer.state.opt_state.nu[name], join(name, saved, "nu", layout)), name
