"""Reference ``.pt`` checkpoints in and out: the port's
``nvit_tpu_torch.ckpt.torch_interop`` against ``nvit_tpu.ckpt.torch_interop``
on the CPU, in nViT, baseline (with biases) and Kohonen modes.

A JAX checkpoint with random weights and random moments is exported to a
``.pt`` by the JAX package; the port imports that ``.pt`` to the same npz
leaves as the JAX import, bit for bit (``rng`` and ``step`` included), and
exports the JAX checkpoint to the same ``model`` and ``optimizer`` tensors,
key set, groups and step as the JAX export.  No reference tree is needed.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt import torch_interop as jax_interop
from nvit_tpu.ckpt.checkpoint import save_checkpoint as jax_save
from nvit_tpu.configs import schema as jax_schema
from nvit_tpu.train.optim import init_fused_adamw as jax_init_adamw
from nvit_tpu.train.state import TrainState as JaxState
from nvit_tpu_torch.ckpt import torch_interop as interop
from nvit_tpu_torch.configs import ViTConfig
from tests.torch_parity import kohonen_fields, random_jax_params

torch.set_num_threads(1)

TINY = dict(image_size=16, n_layer=1, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
            global_patch_size=8)
MODES = {
    "nvit": dict(TINY, use_nvit=True, use_kohonen=False),
    "baseline": dict(TINY, use_nvit=False, use_kohonen=False, bias=True),
    "kohonen": kohonen_fields(),
}
ITER, COUNT, SEED = 7, 5, 4


def npz_leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per mode: a JAX checkpoint (random weights and moments), its JAX
    export to a .pt and the JAX import of that .pt."""
    out = {}
    for mode, model in MODES.items():
        root = tmp_path_factory.mktemp(mode)
        cfg = jax_schema.Config(model=jax_schema.ViTConfig(**model))
        params = random_jax_params(cfg.model, seed=1)
        rng = np.random.default_rng(2)
        mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        nu = jax.tree_util.tree_map(lambda a: rng.random(a.shape).astype(np.float32), params)
        opt = jax_init_adamw(params)._replace(mu=mu, nu=nu, count=jnp.asarray(COUNT, jnp.int32))
        state = JaxState(params=params, opt_state=opt, step=jnp.asarray(ITER, jnp.int32),
                         rng=jax.random.PRNGKey(3))
        jax_save(root / "ckpt", "checkpoint_best", state, cfg, {"val/loss": 1.5, "val/top1_accuracy": 0.25})
        jax_interop.export_torch_checkpoint(root / "ckpt", "checkpoint_best", root / "jax.pt")
        jax_interop.import_torch_checkpoint(root / "jax.pt", root / "jax_import", "checkpoint_latest", seed=SEED)
        out[mode] = root
    return out


@pytest.mark.parametrize("mode", MODES)
def test_import_of_a_jax_exported_pt_matches_jax_import(jax_runs, mode, tmp_path):
    root = jax_runs[mode]
    interop.import_torch_checkpoint(root / "jax.pt", tmp_path, "checkpoint_latest", seed=SEED)
    got, want = (npz_leaves(d / "checkpoint_latest.npz") for d in (tmp_path, root / "jax_import"))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f"leaf {i}"
    np.testing.assert_array_equal(got[-1], [0, SEED])  # rng = PRNGKey(seed)
    assert int(got[-2]) == ITER
    meta, jmeta = (json.loads((d / "checkpoint_latest.json").read_text()) for d in (tmp_path, root / "jax_import"))
    for key in ("iter_num", "trainer", "metrics", "config", "num_leaves", "format"):
        assert meta[key] == jmeta[key], key
    assert meta["trainer"] == {"best_val_loss": 1.5}


@pytest.mark.parametrize("mode", MODES)
def test_export_matches_jax_export(jax_runs, mode, tmp_path):
    root = jax_runs[mode]
    interop.export_torch_checkpoint(root / "ckpt", "checkpoint_best", tmp_path / "port.pt")
    got = torch.load(tmp_path / "port.pt", weights_only=False)
    want = torch.load(root / "jax.pt", weights_only=False)
    assert set(got) == set(want)
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k
    go, wo = got["optimizer"], want["optimizer"]
    assert go["param_groups"] == wo["param_groups"]
    assert set(go["state"]) == set(wo["state"])
    for i, ent in wo["state"].items():
        for k, v in ent.items():
            assert got_equal(go["state"][i][k], v), (i, k)
    assert float(go["state"][0]["step"]) == COUNT
    for key in ("model_args", "iter_num", "metrics", "config", "format"):
        assert got[key] == want[key], key
    # the model loads strictly into the port's ViT once nViT's unused norms go
    from nvit_tpu_torch.models.vit import ViT

    cfg = interop.vit_config_from_model_args(got["model_args"])
    ViT(cfg, device="cpu").load_state_dict(interop.port_state_dict(got["model"], cfg), strict=True)


def got_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_export_then_import_round_trips_params_and_moments(jax_runs, tmp_path):
    """Kohonen mode: every leaf but the key comes back bit-exact."""
    root = jax_runs["kohonen"]
    interop.export_torch_checkpoint(root / "ckpt", "checkpoint_best", tmp_path / "a.pt")
    interop.import_torch_checkpoint(tmp_path / "a.pt", tmp_path, "back", seed=SEED)
    got, want = npz_leaves(tmp_path / "back.npz"), npz_leaves(root / "ckpt" / "checkpoint_best.npz")
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got[:-1], want[:-1])):
        assert a.dtype == b.dtype and np.array_equal(a, b), f"leaf {i}"


def test_foreign_optimizer_dict_gives_fresh_moments_with_a_warning(jax_runs, tmp_path, caplog):
    ckpt = torch.load(jax_runs["nvit"] / "jax.pt", weights_only=False)
    ckpt["optimizer"] = {"state": {}, "param_groups": [{"params": [0, 1, 2]}]}
    torch.save(ckpt, tmp_path / "foreign.pt")
    with caplog.at_level(logging.WARNING):
        interop.import_torch_checkpoint(tmp_path / "foreign.pt", tmp_path, "x")
    assert any("not a reference AdamW state" in r.getMessage() for r in caplog.records)
    assert any("moments start fresh" in r.getMessage() for r in caplog.records)
    leaves = npz_leaves(tmp_path / "x.npz")
    n = (len(leaves) - 3) // 3
    assert int(leaves[n]) == 0  # count
    assert all(not a.any() for a in leaves[n + 1:3 * n + 1])  # mu, nu


def test_bare_state_dict_raises(jax_runs, tmp_path):
    ckpt = torch.load(jax_runs["nvit"] / "jax.pt", weights_only=False)
    torch.save(ckpt["model"], tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="model_args"):
        interop.import_torch_checkpoint(tmp_path / "bare.pt", tmp_path, "x")


def test_cli_exports_and_imports(jax_runs, tmp_path):
    root = jax_runs["baseline"]
    interop.main(["export", "--checkpoint", str(root / "ckpt"), "--name", "checkpoint_best",
                  "--dest", str(tmp_path / "out.pt")])
    interop.main(["import", "--pt", str(tmp_path / "out.pt"), "--dest", str(tmp_path / "in"),
                  "--name", "checkpoint_latest", "--seed", str(SEED)])
    got = npz_leaves(tmp_path / "in" / "checkpoint_latest.npz")
    want = npz_leaves(root / "jax_import" / "checkpoint_latest.npz")
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got) == len(want)


def test_reference_layout_and_config_mapping_match_jax():
    for model in MODES.values():
        jcfg, pcfg = jax_schema.ViTConfig(**model), ViTConfig(**model)
        assert interop.reference_state_dict_order(pcfg) == jax_interop.reference_state_dict_order(jcfg)
        assert interop.model_args_from_config(pcfg) == jax_interop.model_args_from_config(jcfg)
        args = {**jax_interop.model_args_from_config(jcfg), "torch_only": 1}
        assert interop.vit_config_from_model_args(args) == pcfg
        ckpt = {"model_args": args, "config": {"training": {"max_iters": 9, "torch_only": 2},
                                               "ddp": {"backend": "nccl"}}}
        assert (interop.config_from_reference_checkpoint(ckpt).to_dict()
                == jax_interop.config_from_reference_checkpoint(ckpt).to_dict())
