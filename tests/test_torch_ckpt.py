"""The port's checkpoint files against the JAX package's, on the CPU.

* ``ckpt/tree.py``'s skeleton and flatten order against
  ``jax.tree_util.tree_flatten_with_path(create_train_state(cfg))`` (paths,
  shapes, dtypes) and its run key against ``jax.random.split``, for nViT and
  baseline, each with and without biases;
* a checkpoint written by ``nvit_tpu.ckpt.checkpoint.save_checkpoint``
  restores in the port bit-exact (every param and moment after the layout
  transform, ``step``, ``count``, ``rng``, ``meta["trainer"]``), and the
  port's forward on it matches ``vit_apply``'s; a port checkpoint restores
  in ``nvit_tpu.ckpt.checkpoint.restore_for_resume`` bit-exact;
* bf16 (and fp32) exports cross both ways, bf16 as ``|V2`` records on
  disk, and int8 exports (``ops/quant.py``) bit-equal in every leaf;
* the Trainer's lifecycle: N straight steps bit-equal to N/2, a save, a
  resume and N/2; the ``finished`` sentinel rule; ``eval_only``; numbered
  checkpoints; the async write's error box; a signal inside a step deferred
  to its end, and a second one forcing the exit without a save.

Companion files: tests/test_torch_ckpt_restore.py,
tests/test_torch_ckpt_lifecycle.py; shared inputs:
tests/torch_ckpt_cases.py.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import export as jax_export
from nvit_tpu.train.state import create_train_state as jax_create_train_state
from nvit_tpu_torch.ckpt import checkpoint as port_ckpt
from nvit_tpu_torch.ckpt import export as port_export
from nvit_tpu_torch.ckpt.convert import jax_params_from_state_dict, state_dict_from_jax
from nvit_tpu_torch.ckpt.tree import flatten, run_key, train_state_specs
from nvit_tpu_torch.train.state import create_train_state
from tests.torch_parity import random_jax_params
from tests.torch_ckpt_cases import MODES, assert_tensors_equal, configs, jax_checkpoints, jax_key

torch.set_num_threads(1)


# ------------------------------------------------------------ leaf order
@pytest.mark.parametrize("mode", MODES)
def test_skeleton_and_flatten_order_are_jax_train_state(mode):
    jcfg, cfg = configs(mode)
    abstract = jax.eval_shape(lambda: jax_create_train_state(jcfg))
    leaves, _ = jax.tree_util.tree_flatten_with_path(abstract)
    want = [(tuple(jax_key(k) for k in path), tuple(x.shape), str(x.dtype)) for path, x in leaves]
    got = [(path, spec.shape, spec.dtype) for path, spec in train_state_specs(cfg)]
    assert got == want


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_run_key_is_jax_split(seed):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))[1])
    np.testing.assert_array_equal(run_key(seed), want)
    assert run_key(seed).dtype == np.uint32


def test_fresh_state_carries_the_jax_run_key():
    _, cfg = configs("nvit")
    state = create_train_state(cfg, seed=3, device="cpu")
    np.testing.assert_array_equal(state.rng, np.asarray(jax.random.split(jax.random.PRNGKey(3))[1]))


def test_inverse_layout_transform_round_trips():
    _, cfg = configs("nvit-bias")
    params = random_jax_params(configs("nvit-bias")[0].model, seed=3)
    back = jax_params_from_state_dict(state_dict_from_jax(params, cfg.model), cfg.model)
    for (pa, a), (pb, b) in zip(flatten(params), flatten(back)):
        assert pa == pb and np.array_equal(a, b)


def test_orbax_checkpoint_is_refused(jax_checkpoints, tmp_path):
    d, _ = jax_checkpoints["nvit"]
    meta = json.loads((d / "checkpoint_latest.json").read_text())
    meta["format"] = "nvit_tpu.ckpt.orbax.v1"
    (tmp_path / "c.json").write_text(json.dumps(meta))
    with pytest.raises(NotImplementedError, match="do-not-port"):
        port_ckpt.restore_for_resume(tmp_path, "c", device="cpu")


def test_int8_export_crosses_both_ways(jax_checkpoints, tmp_path):
    """``dtype="int8"``: the port's export of a JAX checkpoint holds JAX's
    int8 export's leaves (int8 ``wq``, fp32 ``scale``/``b`` and the rest) bit
    for bit with the same meta; each loads in the other package unchanged, and
    the port serves JAX's export as ``Predictor(quantize="int8")`` serves the
    checkpoint."""
    from nvit_tpu_torch.infer import Predictor

    d, _ = jax_checkpoints["nvit-bias"]
    jax_path = jax_export.export_for_inference(d, "checkpoint_latest", tmp_path / "jax", dtype="int8")
    port_path = port_export.export_for_inference(d, "checkpoint_latest", tmp_path / "port", dtype="int8")
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert a.files == b.files
        assert {a[k].dtype.str for k in a.files} == {"|i1", "<f4"}
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
    assert json.loads(port_path.with_suffix(".json").read_text()) == json.loads(
        jax_path.with_suffix(".json").read_text())
    jp, _ = jax_export.load_export(tmp_path / "port", "checkpoint_latest")
    jj, _ = jax_export.load_export(tmp_path / "jax", "checkpoint_latest")
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(jj)
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(jj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    images = np.random.default_rng(0).integers(0, 256, (3, 3, 16, 16), dtype=np.uint8)
    served = Predictor.from_export(tmp_path / "jax", "checkpoint_latest", device="cpu", quantize="int8")
    direct = Predictor.from_checkpoint(d, "checkpoint_latest", device="cpu", quantize="int8")
    assert_tensors_equal(served.model.state_dict(), direct.model.state_dict())
    np.testing.assert_array_equal(served.predict_probs(images), direct.predict_probs(images))
