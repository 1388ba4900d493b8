"""Checkpoints and exports across the two packages, on the CPU (a companion of
tests/test_torch_ckpt.py): a JAX checkpoint restored in the port bit-exact
and the reverse, bf16 and fp32 exports both ways, Predictor from a
checkpoint and an export."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import checkpoint as jax_ckpt
from nvit_tpu.ckpt import export as jax_export
from nvit_tpu.models.vit import vit_apply
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from tests.torch_ckpt_cases import (
    FWD_TOL,
    MODES,
    TRAINER_META,
    assert_tensors_equal,
    configs,
    jax_checkpoints,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", MODES)
def test_jax_checkpoint_restores_bit_exact(jax_checkpoints, mode):
    d, js = jax_checkpoints[mode]
    jcfg, cfg = configs(mode)
    state, saved_cfg, meta = port_ckpt.restore_for_resume(d, "checkpoint_latest", device="cpu")
    assert saved_cfg == cfg
    assert_tensors_equal(state.model.state_dict(), state_dict_from_jax(js.params, cfg.model))
    assert_tensors_equal(state.opt_state.mu, state_dict_from_jax(js.opt_state.mu, cfg.model))
    assert_tensors_equal(state.opt_state.nu, state_dict_from_jax(js.opt_state.nu, cfg.model))
    assert (state.step, state.opt_state.count) == (7, 7)
    np.testing.assert_array_equal(state.rng, js.rng)
    assert state.rng.dtype == np.uint32
    assert meta["trainer"] == TRAINER_META and meta["iter_num"] == 7
    # the forward on the restored weights is the JAX package's
    img = np.random.default_rng(5).uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    with torch.no_grad():
        logits = state.model.eval()(torch.from_numpy(img))
    want = jax.jit(lambda p, x: vit_apply(p, jcfg.model, x, step=0, train=False).logits)(
        js.params, jnp.asarray(img))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_port_checkpoint_restores_in_jax_bit_exact(jax_checkpoints, tmp_path, mode):
    d, _ = jax_checkpoints[mode]
    state, cfg, meta = port_ckpt.restore_for_resume(d, "checkpoint_latest", device="cpu")
    with torch.no_grad():  # a state of the port's own: move every leaf
        for t in (*state.model.parameters(), *state.opt_state.mu.values(), *state.opt_state.nu.values()):
            t.add_(0.5)
    state.step, state.rng = 9, np.array([1, 2], np.uint32)
    state.opt_state = dataclasses.replace(state.opt_state, count=9)
    port_ckpt.save_checkpoint(tmp_path, "checkpoint_best", state, cfg, {"val/loss": 1.5}, TRAINER_META)
    js, jcfg, jmeta = jax_ckpt.restore_for_resume(tmp_path, "checkpoint_best")
    assert jcfg == configs(mode)[0] and jmeta["trainer"] == TRAINER_META and jmeta["iter_num"] == 9
    got = jax.tree_util.tree_leaves(js)
    want = port_ckpt.state_leaves(state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert_tensors_equal(state_dict_from_jax(jax.device_get(js.params), cfg.model),
                         state.model.state_dict())


# ----------------------------------------------------------------- export
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_export_crosses_both_ways(jax_checkpoints, tmp_path, dtype):
    d, js = jax_checkpoints["nvit-bias"]
    _, cfg = configs("nvit-bias")
    jax_path = jax_export.export_for_inference(d, "checkpoint_latest", tmp_path / "jax", dtype=dtype)
    port_path = port_export.export_for_inference(d, "checkpoint_latest", tmp_path / "port", dtype=dtype)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert a.files == b.files
        for k in a.files:  # the same bytes, |V2 records for bf16
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
            assert (a[k].dtype.kind, a[k].dtype.itemsize) == (("V", 2) if dtype == "bfloat16" else ("f", 4))
    jmeta = json.loads(jax_path.with_suffix(".json").read_text())
    pmeta = json.loads(port_path.with_suffix(".json").read_text())
    assert pmeta == jmeta
    # JAX's export in the port, the port's in JAX
    sd, model_cfg = port_export.load_export(tmp_path / "jax", "checkpoint_latest")
    assert model_cfg == cfg.model
    torch_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = {k: v.to(torch_dtype) for k, v in state_dict_from_jax(js.params, cfg.model).items()}
    assert_tensors_equal(sd, want)
    jp, _ = jax_export.load_export(tmp_path / "port", "checkpoint_latest")
    jq, _ = jax_export.load_export(tmp_path / "jax", "checkpoint_latest")
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jq)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_predictor_from_checkpoint_and_export(jax_checkpoints, tmp_path):
    from nvit_tpu_torch.infer import Predictor

    d, js = jax_checkpoints["nvit"]
    _, cfg = configs("nvit")
    port_export.export_for_inference(d, "checkpoint_latest", tmp_path, dtype="float32")
    images = np.random.default_rng(0).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    a = Predictor.from_checkpoint(d, "checkpoint_latest", device="cpu", compute_dtype=None)
    b = Predictor.from_export(tmp_path, "checkpoint_latest", device="cpu", compute_dtype=None)
    assert_tensors_equal(a.model.state_dict(), state_dict_from_jax(js.params, cfg.model))
    np.testing.assert_array_equal(a.predict_probs(images), b.predict_probs(images))
