"""The port's debug CLI (``nvit_tpu_torch/debug``) against the JAX package's
(``nvit_tpu/debug/cli.py``), on the CPU:

* ``fixture_image`` bit-equal (scikit-learn's photo, and the procedural
  image that a host without scikit-learn or a 1-channel request gets);
* the figures' data from the same parameters and image: the patch tiles
  equal to ``space_to_depth``'s tokens, the BMU counts and node cosine
  matrices equal to what ``visualize_kohonen`` draws (its ``imshow``
  arrays, recorded);
* ``num_params`` equal, the aux losses within 1e-4 relative, in fp32 and
  in the CLI's bf16 compute;
* ``debug_model`` from ``load_config()`` with ``system.device=cpu``: the
  summary and the two PNGs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu.debug import cli as jcli
from nvit_tpu.models.vit import num_params as jax_num_params
from nvit_tpu.models.vit import vit_apply
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.debug import cli
from nvit_tpu_torch.models.vit import ViT, kohonen_spec, num_params
from tests.torch_parity import kohonen_fields, kohonen_params, port_config

torch.set_num_threads(1)

BATCH = 8


@pytest.mark.parametrize("size,channels", [(32, 3), (24, 1)])
def test_fixture_image_is_the_jax_fixture(size, channels):
    got = cli.fixture_image(size, channels)
    assert got.dtype == np.uint8 and got.shape == (channels, size, size)
    np.testing.assert_array_equal(got, jcli.fixture_image(size, channels))


@pytest.fixture(scope="module")
def case():
    """One Kohonen model's params (JAX tree, and the port's ViT) and the JAX
    package's forward on the fixture batch, in fp32 and bf16 compute."""
    jcfg = ViTConfig(**kohonen_fields(kohonen_nodes=64, bias=True))
    params = kohonen_params(jcfg, seed=4)
    model = ViT(port_config(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_jax(params, port_config(jcfg)), strict=True)
    img = cli.fixture_image(jcfg.image_size, jcfg.channels)
    batch = jcli.normalize(jnp.asarray(np.repeat(img[None], BATCH, axis=0)))
    outs = {dt: jax.jit(lambda p, x, dt=dt: vit_apply(p, jcfg, x, step=0, train=False, compute_dtype=dt))(
        params, batch) for dt in (None, jnp.bfloat16)}
    return jcfg, params, model.eval(), img, outs


def test_patch_tiles_are_space_to_depth(case):
    jcfg, _, _, img, _ = case
    tiles = cli.patch_tiles(img, jcfg.local_patch_size)
    g, p = jcfg.image_size // jcfg.local_patch_size, jcfg.local_patch_size
    assert tiles.shape == (g * g, p, p, 3) and tiles.dtype == np.uint8
    tokens = np.asarray(jcli.space_to_depth(jnp.asarray(img[None], jnp.float32), p))[0]
    for k in range(g * g):  # ≙ visualize_patches' tile k
        np.testing.assert_array_equal(tiles[k], tokens[k].reshape(3, p, p).transpose(1, 2, 0).astype(np.uint8))
    assert np.array_equal(tiles[1], img[:, :p, p:2 * p].transpose(1, 2, 0))  # row-major over the grid


def test_kohonen_figure_data_is_the_jax_figures(case, tmp_path, monkeypatch):
    """BMU counts (5 × 6 grids of 32-node maps, the last cells empty) and
    cosine matrices equal to the arrays ``visualize_kohonen`` hands imshow."""
    import matplotlib.axes

    jcfg, params, model, img, outs = case
    drawn = []
    monkeypatch.setattr(matplotlib.axes.Axes, "imshow", lambda self, a, **kw: drawn.append(np.asarray(a)))
    jcli.visualize_kohonen(params, jcfg, outs[jnp.bfloat16].som_info, tmp_path / "k.png")
    with torch.no_grad():
        x = torch.from_numpy(np.array(jcli.normalize(jnp.asarray(np.repeat(img[None], BATCH, axis=0)))))
        _, _, som = model.forward_train(x, hebbian=False, compute_dtype=torch.bfloat16)
    spec = kohonen_spec(model.cfg)
    want = {"local": drawn[0:2], "global": drawn[2:4]}  # counts then cosines, per column
    for name, (counts, cos) in want.items():
        got_counts = cli.bmu_counts(som[f"{name}_indices"].numpy(), spec)
        assert got_counts.shape == (spec.m, spec.n) and got_counts.sum() == BATCH * jcfg.n_patches
        np.testing.assert_array_equal(got_counts, counts)
        np.testing.assert_array_equal(cli.node_cosines(getattr(model, f"{name}_kohonen").nodes.detach().numpy()), cos)


def test_num_params_and_aux_losses_match_jax(case):
    jcfg, params, model, img, outs = case
    assert num_params(model) == jax_num_params(params)
    x = torch.from_numpy(np.array(jcli.normalize(jnp.asarray(np.repeat(img[None], BATCH, axis=0)))))
    for tdt, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        with torch.no_grad():
            logits, aux, _ = model.forward_train(x, hebbian=False, compute_dtype=tdt)
        want = outs[jdt].aux_losses
        assert set(aux) == set(want) and tuple(logits.shape) == tuple(outs[jdt].logits.shape)
        for k, v in want.items():
            assert abs(float(aux[k]) - float(v)) <= 1e-4 * abs(float(v)), (k, tdt)  # measured ≤ 5e-5


def test_debug_model_runs_the_configured_model(tmp_path, monkeypatch):
    """``python -m nvit_tpu_torch.debug``'s function on the packaged settings
    (the Kohonen model, 32 px) with ``system.device=cpu``: logits of the
    batch, the five aux terms, both figures as PNGs."""
    monkeypatch.chdir(tmp_path)
    for key in [k for k in os.environ if k.startswith("NVIT_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("NVIT_SYSTEM__DEVICE", "cpu")
    monkeypatch.setenv("NVIT_DATA__OUT_DIR", str(tmp_path / "out"))
    out = cli.debug_model(batch_size=4)
    assert out["logits_shape"][0] == 4 and np.isfinite(list(out["aux_losses"].values())).all()
    assert set(out["aux_losses"]) == {"reconstruction", "kohonen_consistency", "kohonen_smoothness",
                                      "local_quantization", "global_quantization"}
    assert [Image.open(f).format for f in out["figures"]] == ["PNG", "PNG"]
    assert json.dumps(out)  # the summary is plain data
