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
    """Kohonen (tests/test_torch_kohonen.py holds it against JAX) and
    baseline mode (use_nvit=False; tests/test_torch_baseline.py) are ported:
    a Kohonen ViT builds with the reference state_dict keys — the interop's,
    minus the unused nViT rmsnorm weights — in the reference order outside
    the blocks (map_balance before sz, the maps between the patch embeds and
    the cross-attention), and the baseline one with its own parameters."""
    from nvit_tpu.ckpt.torch_interop import reference_state_dict_order

    cfg = small_vit_cfg(use_kohonen=True, kohonen_nodes=18)
    names = list(ViT(port_config(cfg), device="cpu").state_dict())
    ref = [k for k in reference_state_dict_order(cfg) if ".rmsnorm_" not in k]
    assert sorted(names) == sorted(ref)
    assert [k for k in names if not k.startswith("transformer.")] == [
        k for k in ref if not k.startswith("transformer.")]
    assert "local_kohonen.locations" in names and "map_balance" in names
    names = set(ViT(port_config(small_vit_cfg(use_nvit=False)), device="cpu").state_dict())
    assert "transformer.h.0.rmsnorm_att.weight" in names and "sz" not in names


# ------------------------------------------------------------ training slice
SECTIONS = ("TrainingConfig", "SchedulerConfig", "OptimizerConfig", "SystemConfig",
            "WandbConfig", "AugmentationConfig", "DataConfig", "Config")


@pytest.mark.parametrize("section", SECTIONS)
def test_config_sections_are_the_jax_sections(section):
    import nvit_tpu.configs.schema as jax_schema
    import nvit_tpu_torch.configs.schema as port_schema

    fields = lambda cls: [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(getattr(port_schema, section)) == fields(getattr(jax_schema, section))
    assert dataclasses.asdict(getattr(port_schema, section)()) == dataclasses.asdict(
        getattr(jax_schema, section)())


@pytest.mark.parametrize("bad", [dict(moments_dtype="fp8"), dict(sr_dither="philox")])
def test_optimizer_config_validate_matches_jax(bad):
    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu_torch.configs import OptimizerConfig

    with pytest.raises(ValueError) as want:
        JaxOpt(**bad).validate()
    with pytest.raises(ValueError) as got:
        OptimizerConfig(**bad).validate()
    assert str(got.value) == str(want.value)


def test_flagship_config_is_the_graft_entry_copy():
    from __graft_entry__ import flagship_config as jax_flagship
    from nvit_tpu_torch.models.presets import flagship_config

    assert flagship_config().to_dict() == jax_flagship().to_dict()
    assert flagship_config(n_layer=2).to_dict() == jax_flagship(n_layer=2).to_dict()


def _jax_vjp(fn, primals, cotangent):
    import jax

    _, vjp = jax.vjp(fn, *primals)
    return vjp(cotangent)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residual_backwards_match_jax_custom_vjps(dtype):
    """The analytic backwards against the JAX custom VJPs on the same inputs
    and cotangent; d_alpha sums over every row ([2, 5, 16] → [16])."""
    jdt, tdt, tol = DTYPES[dtype]
    h, u, g = rnd(3, 2, 5, 16), rnd(4, 2, 5, 16), rnd(12, 2, 5, 16)
    alpha = (rnd(5, 16) * 0.03).astype(np.float32)  # both signs: sign(α·c) matters
    skip = np.array([0.7], np.float32)
    ref = _jax_vjp(lambda a, b, c: jr.slerp_residual(a, b, c, 0.05, 1 / 32),
                   (both(h, dtype)[0], both(u, dtype)[0], jnp.asarray(alpha)), both(g, dtype)[0])
    ht, ut = (both(x, dtype)[1].requires_grad_() for x in (h, u))
    at = torch.from_numpy(alpha).requires_grad_()
    tr.slerp_residual(ht, ut, at, 0.05, 1 / 32).backward(both(g, dtype)[1])
    for got, want in zip((ht.grad, ut.grad, at.grad), ref):
        close(got, want, dtype)

    ref = _jax_vjp(jr.norm_skip, (both(u, dtype)[0], both(h, dtype)[0], jnp.asarray(skip)),
                   both(g, dtype)[0])
    ht, ut = (both(x, dtype)[1].requires_grad_() for x in (h, u))
    st = torch.from_numpy(skip).requires_grad_()
    tr.norm_skip(ut, ht, st).backward(both(g, dtype)[1])
    for got, want in zip((ut.grad, ht.grad), ref[:2]):
        close(got, want, dtype)
    # d_skip is one sum over all 160 elements: summation order, relative to its size
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ref[2]), rtol=tol["rtol"], atol=1e-5)


def test_residual_backwards_pass_gradcheck():
    g = torch.Generator().manual_seed(0)
    h, u = (torch.randn(3, 4, 6, generator=g, dtype=torch.float64, requires_grad=True) for _ in range(2))
    alpha = (0.5 * torch.randn(6, generator=g, dtype=torch.float64)).requires_grad_()
    skip = torch.tensor([0.8], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b, c: tr.slerp_residual(a, b, c, 0.05, 1 / 8), (h, u, alpha))
    assert torch.autograd.gradcheck(tr.norm_skip, (u, h, skip))


def test_losses_match_jax():
    from nvit_tpu.models import losses as jlosses
    from nvit_tpu_torch.models import losses as tlosses

    logits = rnd(13, 6, 9)
    labels = np.random.default_rng(14).integers(0, 9, 6).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(tlosses.cross_entropy(lt, yt).item(),
                               float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    np.testing.assert_allclose(tlosses.mse_loss(lt, lt * 0.5).item(),
                               float(jlosses.mse_loss(jnp.asarray(logits), jnp.asarray(logits) * 0.5)),
                               rtol=1e-6)
    for got, want in zip(tlosses.topk_accuracy(lt, yt), jlosses.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels))):
        assert got.item() == pytest.approx(float(want))


@pytest.mark.parametrize("decay_lr", [True, False])
def test_cosine_lr_matches_jax(decay_lr):
    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu.models.schedules import cosine_lr as jax_cosine_lr
    from nvit_tpu_torch.configs import OptimizerConfig
    from nvit_tpu_torch.models.schedules import cosine_lr

    kw = dict(learning_rate=3e-3, min_lr=1e-4, warmup_iters=5, lr_decay_iters=20, decay_lr=decay_lr)
    steps = np.arange(0, 20 + 6)
    got = np.array([cosine_lr(OptimizerConfig(**kw), int(s)).item() for s in steps], np.float32)
    want = np.asarray(jax_cosine_lr(JaxOpt(**kw), jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _port_names_to_tensors(tree, cfg):
    """A JAX-shaped tree → ``{ViT parameter name: tensor}`` (the one function
    that carries weights across, applied to any tree of the params' shapes)."""
    return state_dict_from_jax(tree, port_config(cfg))


def test_decay_mask_follows_the_jax_leaves():
    """Leaf by leaf against decay_mask(jax_params): the patch-embed convs are
    4-D here and 2-D there, skip_param is [1] in both."""
    import jax

    from nvit_tpu.train.optim import decay_mask as jax_decay_mask
    from nvit_tpu_torch.train.optim import decay_mask

    cfg = small_vit_cfg()
    params = random_jax_params(cfg)
    mask = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), m, np.float32),
                                  jax_decay_mask(params), params)
    want = {n: bool(t.flatten()[0]) for n, t in _port_names_to_tensors(mask, cfg).items()}
    model = ViT(port_config(cfg), device="cpu")
    assert decay_mask(model.named_parameters()) == want
    assert want["local_patch_embed.weight"] and not want["transformer.h.0.skip_param"]


@pytest.mark.parametrize("clip", [0.05, 1e3])  # active, inactive
def test_fused_adamw_renorm_update_matches_jax(clip):
    """Three steps of the fused clip + AdamW + renorm update on converted
    trees: parameters and both moments.  fp32 throughout: the same fp32
    operations in the same order, so only summation order (the global norm,
    the renorm sums) separates the two — rtol 1e-5, atol 1e-6."""
    import jax

    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu.train import optim as jopt
    from nvit_tpu_torch.configs import OptimizerConfig
    from nvit_tpu_torch.train import optim as topt

    cfg = small_vit_cfg()
    params = random_jax_params(cfg, seed=5)
    kw = dict(learning_rate=1e-2, min_lr=1e-3, warmup_iters=1, lr_decay_iters=4, grad_clip=clip)
    rng = np.random.default_rng(6)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
             for _ in range(3)]

    jstate = jopt.init_fused_adamw(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    update = jax.jit(lambda p, g, s: jopt.fused_adamw_renorm_update(JaxOpt(**kw), p, g, s, renorm=True))
    for g in grads:
        jparams, jstate = update(jparams, g, jstate)

    tparams = _port_names_to_tensors(params, cfg)
    tstate = topt.init_fused_adamw(tparams.items())
    for g in grads:
        tstate = topt.fused_adamw_renorm_update(OptimizerConfig(**kw), tparams,
                                                _port_names_to_tensors(g, cfg), tstate, renorm=True)
    assert tstate.count == 3 == int(jstate.count)
    for got, want in ((tparams, jparams), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        want = _port_names_to_tensors(jax.tree_util.tree_map(np.asarray, want), cfg)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    # the Block matrices stay on the hypersphere along the flipped axes
    w = tparams["transformer.h.0.query.weight"]
    torch.testing.assert_close(w.norm(dim=1), torch.ones(w.shape[0]))
    w = tparams["transformer.h.0.att_c_proj.weight"]
    torch.testing.assert_close(w.norm(dim=0), torch.ones(w.shape[1]))


def test_num_params_and_flops_model_match_jax():
    from nvit_tpu.models.vit import estimate_flops_per_iter as jax_flops
    from nvit_tpu.models.vit import num_params as jax_num_params
    from nvit_tpu_torch.models.vit import estimate_flops_per_iter, num_params

    cfg = small_vit_cfg()
    n = num_params(ViT(port_config(cfg), device="cpu"))
    assert n == jax_num_params(random_jax_params(cfg))
    assert estimate_flops_per_iter(port_config(cfg), n, 2) == jax_flops(cfg, n, 2)


@pytest.mark.parametrize("use_amp,dtype", [(True, "bfloat16"), (True, "float16"), (True, "float32"),
                                           (False, "bfloat16")])
def test_compute_dtype_policy_matches_jax(use_amp, dtype):
    from nvit_tpu.configs.schema import Config as JaxCfg
    from nvit_tpu.configs.schema import SystemConfig as JaxSys
    from nvit_tpu.train.state import compute_dtype_of as jax_compute_dtype_of
    from nvit_tpu_torch.configs import SystemConfig
    from nvit_tpu_torch.train.state import compute_dtype_of

    got = compute_dtype_of(PortConfig(system=SystemConfig(use_amp=use_amp, dtype=dtype)))
    want = jax_compute_dtype_of(JaxCfg(system=JaxSys(use_amp=use_amp, dtype=dtype)))
    assert got == {None: None, jnp.bfloat16: torch.bfloat16}[want]
