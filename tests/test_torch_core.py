"""The port's core primitives, patch embedding and checkpoint conversion
against the JAX package (same numpy inputs through both frameworks).

fp32 results agree to summation order (rtol 1e-5, atol 1e-6); bf16 results
may differ by one bf16 rounding (2^-7 relative), and XLA on the CPU may keep
excess fp32 precision between bf16 ops, so bf16 uses rtol/atol 2e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt.torch_interop import global_embed_permutation as jax_perm
from nvit_tpu.ckpt.torch_interop import state_dict_from_params
from nvit_tpu.configs.schema import Config as JaxConfig
from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu.core import layers as jl
from nvit_tpu.core import norms as jn
from nvit_tpu.core import residual as jr
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu.models import patch as jp
from nvit_tpu.models.presets import PRESETS as JAX_PRESETS
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.configs import Config as PortConfig
from nvit_tpu_torch.configs import ViTConfig as PortViTConfig
from nvit_tpu_torch.core import layers as tl
from nvit_tpu_torch.core import norms as tn
from nvit_tpu_torch.core import residual as tr
from nvit_tpu_torch.data.augment import normalize
from nvit_tpu_torch.models import patch as tp
from nvit_tpu_torch.models.presets import PRESETS
from nvit_tpu_torch.models.vit import ViT
from tests.torch_parity import port_config, random_jax_params

torch.set_num_threads(1)

DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(rtol=1e-5, atol=1e-6)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def rnd(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def both(a, name):
    jdt, tdt, _ = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


def close(t, j, name):
    assert t.dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[j.dtype.type], (t.dtype, j.dtype)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **DTYPES[name][2])


def test_presets_table_is_the_jax_table():
    assert PRESETS == JAX_PRESETS


def test_config_schema_is_the_jax_schema():
    """The port's ViTConfig is a copy (the port loads nothing of the JAX
    package): the same fields in the same order with the same defaults."""
    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]
    assert fields(PortViTConfig) == fields(ViTConfig)
    assert PortConfig().model == port_config(JaxConfig().model)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_properties_match_jax(name):
    jax_cfg = ViTConfig(**PRESETS[name])
    cfg = port_config(jax_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    for prop in ("head_dim", "n_patches", "grid_size"):
        assert getattr(cfg, prop) == getattr(jax_cfg, prop), prop
    cfg.validate()


@pytest.mark.parametrize("bad", [
    dict(bounded_softmax="max"), dict(gated_mlp_kernel="yes"), dict(kohonen_hebbian="x"),
    dict(n_head=5), dict(image_size=30), dict(global_patch_size=11),
    dict(use_kohonen=True, kohonen_nodes=1),
])
def test_config_validate_matches_jax(bad):
    with pytest.raises(ValueError) as want:
        ViTConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        PortViTConfig(**bad).validate()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norms(dtype):
    xj, xt = both(rnd(0, 4, 6, 32), dtype)
    w = rnd(1, 32)
    b = rnd(2, 32)
    close(tn.justnorm(xt), jn.justnorm(xj), dtype)
    close(tn.rms_norm(xt, torch.from_numpy(w)), jn.rms_norm(xj, jnp.asarray(w)), dtype)
    close(tn.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b)),
          jn.layer_norm(xj, jnp.asarray(w), jnp.asarray(b)), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residuals(dtype):
    hj, ht = both(rnd(3, 2, 5, 16), dtype)
    uj, ut = both(rnd(4, 2, 5, 16), dtype)
    alpha = np.abs(rnd(5, 16)) * 0.03
    close(tr.slerp_residual(ht, ut, torch.from_numpy(alpha), 0.05, 1 / 32),
          jr.slerp_residual(hj, uj, jnp.asarray(alpha), 0.05, 1 / 32), dtype)
    skip = np.array([0.7], np.float32)
    close(tr.norm_skip(ut, ht, torch.from_numpy(skip)), jr.norm_skip(uj, hj, jnp.asarray(skip)), dtype)


@pytest.mark.parametrize("compute", [None, "bf16"])
def test_linear_casting_contract(compute):
    x, w, b = rnd(6, 3, 7, 24), rnd(7, 24, 40), rnd(8, 40)  # JAX layout w [in, out]
    jdt = jnp.bfloat16 if compute else None
    tdt = torch.bfloat16 if compute else None
    ref = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), compute_dtype=jdt)
    out = tl.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                    compute_dtype=tdt)
    close(out, ref, "bf16" if compute else "fp32")


def test_concat_linears_is_the_out_axis_concat():
    parts = [(rnd(9 + i, 8, 5), rnd(20 + i, 8)) for i in range(3)]  # torch [out, in]
    w, b = tl.concat_linears([(torch.from_numpy(a), torch.from_numpy(c)) for a, c in parts])
    ref = jl.concat_linears([{"w": jnp.asarray(a.T), "b": jnp.asarray(c)} for a, c in parts])
    np.testing.assert_array_equal(w.numpy().T, np.asarray(ref["w"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(ref["b"]))


def test_normalize():
    img = np.random.default_rng(10).integers(0, 256, (2, 3, 4, 4), dtype=np.uint8)
    np.testing.assert_array_equal(normalize(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(img))))


@pytest.mark.parametrize("kernel,stride,size", [(8, 4, 16), (16, 8, 32), (6, 4, 16)])
def test_patch_extraction_is_exact(kernel, stride, size):
    """Pure data movement: bit-equal, including the (6, 4) im2col case."""
    img = rnd(11, 2, 3, size, size)
    np.testing.assert_array_equal(tp.space_to_depth(torch.from_numpy(img), stride).numpy(),
                                  np.asarray(jp.space_to_depth(jnp.asarray(img), stride)))
    pad = (kernel - stride) // 2
    padded_t = tp.reflect_pad(torch.from_numpy(img), pad)
    padded_j = jp.reflect_pad(jnp.asarray(img), pad)
    np.testing.assert_array_equal(padded_t.numpy(), np.asarray(padded_j))
    np.testing.assert_array_equal(
        tp.extract_overlapping_patches(padded_t, kernel, stride).numpy(),
        np.asarray(jp.extract_overlapping_patches(padded_j, kernel, stride)),
    )


@pytest.mark.parametrize("channels,kernel,stride", [(3, 16, 8), (3, 8, 4), (2, 6, 4)])
def test_global_embed_permutation_matches_interop(channels, kernel, stride):
    np.testing.assert_array_equal(tp.global_embed_permutation(channels, kernel, stride),
                                  jax_perm(channels, kernel, stride))


def small_vit_cfg(**kw):
    base = dict(image_size=16, n_layer=2, n_head=2, n_embd=32, num_classes=7,
                local_patch_size=4, global_patch_size=8, use_nvit=True)
    base.update(kw)
    return ViTConfig(**base)


@pytest.mark.parametrize("bias", [False, True])
def test_state_dict_from_jax_matches_torch_interop(bias):
    """Key for key and value for value on the shared keys (the interop map
    also emits the unused nViT rmsnorm weights), then a strict load."""
    cfg = small_vit_cfg(bias=bias)
    params = random_jax_params(cfg, seed=int(bias))
    ours = state_dict_from_jax(params, port_config(cfg))
    ref = state_dict_from_params(params, cfg)
    unused = {k for k in ref if ".rmsnorm_" in k}
    assert set(ours) == set(ref) - unused
    for key, val in ours.items():
        assert val.dtype == torch.float32, key
        np.testing.assert_array_equal(val.numpy(), ref[key], err_msg=key)
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)


def test_unported_modes_raise():
    for kw, what in ((dict(use_kohonen=True), "Kohonen"), (dict(use_nvit=False), "baseline")):
        with pytest.raises(NotImplementedError, match=what):
            ViT(port_config(small_vit_cfg(**kw)), device="cpu")
