"""The port's bias and bounded-softmax paths at the model's level, against the
JAX package (a companion of tests/test_torch_bias_bounded.py):

* the long-sequence branch of ``flash_attention_qknorm`` (the fp32
  projection, then the plain flash kernels), with the switch lowered on both
  sides, in every mode;
* a ``bias=True`` ViT and a ``bounded`` one on their kernel paths (the twins
  on the CPU) against ``vit_apply`` with the Pallas kernels forced;
* the flagship block's bf16 gradients on the kernel path.

Inputs are made from a seed with numpy and handed to both frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.configs.schema import ViTConfig
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.ops import flash_attention as fa
from tests.torch_parity import port_config, random_jax_params
from tests.torch_bias_cases import (
    REGIMES,
    TOL,
    as_np,
    assert_grads_close,
    jax_vjp,
    port_vjp,
    qkv_inputs,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["rowmax", "bounded", "auto"])
def test_long_sequences_take_the_plain_flash_kernels(monkeypatch, mode):
    """Past FUSED_BWD_MAX_T (lowered to 32 on both sides; T = 40) the JAX
    package projects q̂/k̂ in fp32 and calls ``flash_attention`` — K7, then
    K9 — whatever the mode; the port does the same.  In the clamp regime a
    "bounded" kernel there would floor whole rows that the JAX package never
    clamps.  fp32, forward and ``jax.vjp``, tolerance TOL["fp32"]."""
    monkeypatch.setenv("NVIT_TUNE_FUSED_BWD_MAX_T", "32")
    monkeypatch.setattr(fa, "FUSED_BWD_MAX_T", 32)
    q, k, v, sqk, do = qkv_inputs(76, t=40, d=32, s=REGIMES["clamp"])
    scale = float(np.sqrt(32))
    with pltpu.force_tpu_interpret_mode():
        out_ref, grads_ref = jax_vjp(q, k, v, sqk, do, scale, mode, "fp32")
    out, grads = port_vjp(q, k, v, sqk, do, scale, mode, "fp32")
    np.testing.assert_allclose(as_np(out), as_np(out_ref), **TOL["fp32"])
    assert_grads_close(grads, grads_ref, TOL["fp32"])


# ------------------------------------------------------------------ ViT
@pytest.mark.parametrize("kw", [dict(bias=True), dict(bounded_softmax="bounded"),
                                dict(bias=True, use_nvit=False)], ids=["bias", "bounded", "baseline-bias"])
def test_vit_kernel_path_matches_jax(kw):
    """nvit-tiny4 at one layer (32 px, d = 128, 4 heads), flash_attn=True, in
    fp32: the port's forward (K6 / K5 twins on the CPU) against ``vit_apply``
    with the JAX package's Pallas kernels forced through the generic
    interpreter (tests/kernel_force.py).  Logits to rtol 1e-4 / atol 1e-5 ×
    their spread: summation order only."""
    from nvit_tpu.models.vit import vit_apply
    from nvit_tpu_torch.models.presets import preset
    from nvit_tpu_torch.models.vit import ViT
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    base = preset("nvit-tiny4")
    base.update(n_layer=1, num_classes=10, flash_attn=True)
    cfg = dataclasses.replace(ViTConfig(**base), **kw)
    params = random_jax_params(cfg, seed=5)
    img = np.random.default_rng(6).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    with force_on_tpu(), generic_interpret_mode():
        want = np.asarray(jax.jit(lambda p, x: vit_apply(p, cfg, x).logits)(params, jnp.asarray(img)))
    port_cfg = port_config(cfg)
    model = ViT(port_cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, port_cfg), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.ptp(want))


def test_flagship_block_bf16_gradients_match_jax_kernel_path():
    """One nViT-B/16 block with bias=True (d = 768, 12 heads, T = 784,
    batch 2) in bf16 on the kernel path: the port's parameter gradients (K1,
    K2, K6 twins) against ``block_apply``'s with the Pallas kernels forced,
    each within 5e-2 relative L2 (bf16 roundings of one block, measured ≤
    1.3e-2) — except the key bias's.  That one, Σ_t dk_t, cancels: the TPU
    kernels' bf16 dS leave it far from the fp32 gradient in the JAX
    package's own kernel path (measured 0.20), and the port must sit closer
    to that bf16 value than half that distance (measured 0.057)."""
    from nvit_tpu.models.blocks import block_apply
    from nvit_tpu_torch.models.blocks import Block
    from tests.kernel_force import force_on_tpu, generic_interpret_mode

    cfg = ViTConfig(image_size=224, n_layer=1, n_head=12, n_embd=768, num_classes=10, use_nvit=True,
                    flash_attn=True, bias=True)
    params = random_jax_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, cfg.n_patches, 768)).astype(np.float32)
    h /= np.linalg.norm(h, axis=-1, keepdims=True)
    dy = rng.standard_normal(h.shape).astype(np.float32)

    def grad_fn(dt):
        def loss(p, x, g):
            return jnp.sum(block_apply(p, cfg, x.astype(dt), compute_dtype=dt).astype(jnp.float32) * g)
        return jax.jit(jax.grad(loss))(params["blocks"][0], jnp.asarray(h), jnp.asarray(dy))

    with force_on_tpu(), generic_interpret_mode():
        grads, grads32 = grad_fn(jnp.bfloat16), grad_fn(jnp.float32)
    port_cfg = port_config(cfg)
    prefix = "transformer.h.0."

    def block_dict(tree):
        sd = state_dict_from_jax({**params, "blocks": [tree]}, port_cfg)
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    want, want32 = block_dict(grads), block_dict(grads32)
    block = Block(port_cfg, device="cpu")
    block.load_state_dict(block_dict(params["blocks"][0]))
    block(torch.from_numpy(h).bfloat16().requires_grad_(), compute_dtype=torch.bfloat16).backward(
        torch.from_numpy(dy).bfloat16())

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for name, p in block.named_parameters():
        if name == "skip_param":  # the ViT's outer norm_skip uses it, not the block
            continue
        bound = 0.5 * rel(want[name], want32[name]) if name == "key.bias" else 5e-2
        assert rel(p.grad, want[name]) <= bound, f"{name}: relative L2 {rel(p.grad, want[name]):.3e}"
