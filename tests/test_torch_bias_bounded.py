"""The port's bias and bounded-softmax kernels against the JAX package.

* K6 — the gated MLP with a bias (``_gated_core_b``): the twins and
  ``GatedMLPFn`` against the Pallas kernels in interpret mode, with dx, dW and
  db through ``jax.vjp``; the plain chain's rounding order (``_xla_gated``);
* K5 — the bounded arm of the QK-norm attention kernels (``_fwd_qknorm`` /
  ``_bwd_qknorm`` with ``mode="bounded"``) where the clamp is inert and where
  it floors whole rows; ``mode="auto"`` on both sides of its gate;
* the long-sequence branch of ``flash_attention_qknorm`` (the fp32
  projection, then the plain flash kernels), with the switch lowered on both
  sides, in every mode;
* a ``bias=True`` ViT and a ``bounded`` one on their kernel paths (the twins
  on the CPU) against ``vit_apply`` with the Pallas kernels forced;
* dispatch: CPU tensors run the twins, the launch wrappers refuse them.

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
from nvit_tpu.ops.flash_attention import _fwd_qknorm
from nvit_tpu.ops.flash_attention import flash_attention_qknorm as jax_flash_qknorm
from nvit_tpu.ops.gated_mlp import _gated_core_b
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.ops import flash_attention as fa
from nvit_tpu_torch.ops.gated_mlp import (
    gated_mlp,
    gated_mlp_bwd_duv,
    gated_mlp_bwd_ref,
    gated_mlp_fwd,
    gated_mlp_ref,
    gated_mlp_xla,
)
from tests.torch_parity import port_config, random_jax_params

torch.set_num_threads(1)

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# fp32: summation order only (the tolerances of tests/test_gated_mlp.py and
# tests/test_flash_attention.py); bf16: one bf16 rounding of u/v, q̂/k̂, P,
# dS or O may land on either side, 2^-7 ≈ 8e-3 relative
TOL = {"fp32": dict(rtol=2e-4, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def to_jax(a, dt):
    return jnp.asarray(a).astype(JDT[dt])


def to_torch(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------------ K6
def mlp_inputs(seed, n=256, k=128, h=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k), dtype=np.float32)
    w = (0.1 * rng.standard_normal((2 * h, k))).astype(np.float32)  # torch [2H, K]
    b = (0.5 * rng.standard_normal(2 * h)).astype(np.float32)
    g = rng.standard_normal((n, h), dtype=np.float32)
    return x, w, b, g


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k6_twins_and_autograd_match_pallas_vjp(dtype):
    """gated_mlp(x, w, b) on CPU tensors (K6's twin forward; its backward
    twin, the dense dW/dx and db's column sum) against ``_gated_core_b`` and
    its ``jax.vjp`` in interpret mode: out, dx, dW and db."""
    x, w, b, g = mlp_inputs(60)
    h = w.shape[0] // 2
    wj, bj = to_jax(w.T, dtype), to_jax(b, dtype)
    with pltpu.force_tpu_interpret_mode():
        out_ref, vjp = jax.vjp(_gated_core_b, to_jax(x, dtype), wj[:, :h], wj[:, h:],
                               bj[:h].reshape(1, h), bj[h:].reshape(1, h))
        dx_ref, dwu, dwv, dbu, dbv = vjp(to_jax(g, dtype))
    dw_ref = np.concatenate([as_np(dwu).T, as_np(dwv).T])
    db_ref = np.concatenate([as_np(dbu)[0], as_np(dbv)[0]])

    xt, wt, bt = (to_torch(a, dtype).requires_grad_() for a in (x, w, b))
    out = gated_mlp(xt.reshape(4, 64, -1), wt, bt, use_kernel=True)
    assert out.grad_fn is not None and out.dtype == TDT[dtype]
    out.backward(to_torch(g, dtype).reshape(4, 64, h))
    np.testing.assert_allclose(as_np(out).reshape(-1, h), as_np(out_ref), **TOL[dtype])
    for name, got, want in (("dx", xt.grad, dx_ref), ("dW", wt.grad, dw_ref), ("db", bt.grad, db_ref)):
        assert got.dtype == TDT[dtype], name
        np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype], err_msg=name)

    # the Function's forward and backward are the twins
    with torch.no_grad():
        args = [to_torch(a, dtype) for a in (x, w)]
        assert torch.equal(gated_mlp_ref(*args, to_torch(b, dtype)), out.reshape(-1, h))
        dx, dw, db = gated_mlp_bwd_ref(*args, to_torch(g, dtype), to_torch(b, dtype))
    assert torch.equal(dx, xt.grad) and torch.equal(dw, wt.grad) and torch.equal(db, bt.grad)


def test_plain_gated_chain_rounds_before_the_bias():
    """gated_mlp_kernel="off" with a bias (bf16): the port's chain rounds
    x·Wᵀ to bf16 and then adds the bf16 bias, as ``_xla_gated`` does, so its
    output is the port's gate applied to the JAX chain's own [u | v], up to
    the GEMMs' own summation-order flips (≤ 1e-3 of the elements).  Adding
    the bias inside the GEMM, before the rounding, moves far more of them
    (≥ 10%), which this test would see."""
    x, w, b, _ = mlp_inputs(61, n=256, k=128, h=512)
    xj, wj, bj = to_jax(x, "bf16"), to_jax(w.T, "bf16"), to_jax(b, "bf16")
    uv_jax = torch.from_numpy(np.array((xj @ wj + bj).astype(jnp.float32))).bfloat16()

    def gate(uv):
        u, v = torch.chunk(uv, 2, dim=-1)
        return u * torch.nn.functional.silu(v)

    xt, wt, bt = (to_torch(a, "bf16") for a in (x, w, b))
    got = gated_mlp_xla(xt, wt, bt)
    assert got.dtype == torch.bfloat16
    assert (got != gate(uv_jax)).float().mean().item() <= 1e-3
    assert (gate(torch.nn.functional.linear(xt, wt, bt)) != gate(uv_jax)).float().mean().item() >= 0.1


# ------------------------------------------------------------------ K5
def qkv_inputs(seed, b=2, h=2, t=64, d=64, s=1.0):
    """q, k, v and sqk_eff ≈ s (per-channel noise of 10%)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(3))
    sqk = (s * (1.0 + 0.1 * rng.standard_normal((h, d)))).astype(np.float32)
    do = rng.standard_normal((b, h, t, d), dtype=np.float32)
    return q, k, v, sqk, do


# sqk_eff ≈ 1: bound = 8·max(s²) ≈ 12, every exp argument above −25, the
# clamp inert.  sqk_eff ≈ 3: bound ≈ 110 while every |score| stays near 30,
# so max(S − bound, −60) floors whole rows: uniform attention, and the
# deliberately approximate cotangent of flash_attention.py:461-477
REGIMES = {"inert": 1.0, "clamp": 3.0}


def jax_vjp(q, k, v, sqk, do, scale, mode, dt):
    def f(q_, k_, v_, s_):
        return jax_flash_qknorm(q_, k_, v_, s_, scale, mode=mode)

    out, vjp = jax.vjp(f, *(to_jax(x, dt) for x in (q, k, v)), jnp.asarray(sqk))
    return out, vjp(to_jax(do, dt))


def port_vjp(q, k, v, sqk, do, scale, mode, dt):
    leaves = [to_torch(x, dt).requires_grad_() for x in (q, k, v)] + [torch.from_numpy(sqk).requires_grad_()]
    out = fa.flash_attention_qknorm(*leaves, scale, mode=mode)
    assert out.grad_fn is not None and out.dtype == TDT[dt]
    out.backward(to_torch(do, dt))
    return out, [x.grad for x in leaves]


def assert_grads_close(got, want, tol):
    for name, a, r in zip(("dq", "dk", "dv", "dsqk"), got, want):
        assert np.isfinite(as_np(a)).all(), name
        np.testing.assert_allclose(as_np(a), as_np(r), **tol, err_msg=name)


@pytest.mark.parametrize("regime", ["inert", "clamp"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k5_twins_match_pallas_bounded(regime, dtype):
    """mode="bounded": the K5 forward twin's o and lse against
    ``_fwd_qknorm``, and FlashQKNormFn's gradients (K5's backward twin)
    against ``jax.vjp`` of the Pallas kernels, in interpret mode.  In the
    clamp regime the reference is the JAX kernel, not row-max: both floor
    whole rows and must stay finite.  Tolerances: TOL (dsqk, a sum over
    T·D products, to the same relative bound)."""
    b, h, t, d = 2, 2, 64, 64
    q, k, v, sqk, do = qkv_inputs(70 + int(regime == "clamp"), b, h, t, d, s=REGIMES[regime])
    scale = float(np.sqrt(d))
    s3 = jnp.broadcast_to(jnp.asarray(sqk).reshape(1, h, 1, d), (b, h, 1, d)).reshape(b * h, 1, d)
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = _fwd_qknorm(*(to_jax(x, dtype).reshape(b * h, t, d) for x in (q, k, v)),
                                     s3, scale, t, mode="bounded")
        out_ref, grads_ref = jax_vjp(q, k, v, sqk, do, scale, "bounded", dtype)
    o, lse = fa.flash_attention_qknorm_ref(*(to_torch(x, dtype) for x in (q, k, v)),
                                           torch.from_numpy(sqk), scale, "bounded")
    bound = fa.head_bounds(torch.from_numpy(sqk), scale)
    assert (bound > 60).all() if regime == "clamp" else (bound < 20).all()
    assert np.isfinite(as_np(o)).all() and np.isfinite(as_np(lse)).all()
    np.testing.assert_allclose(as_np(o).reshape(b * h, t, d), as_np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(lse_ref)[..., 0], rtol=2e-4, atol=2e-5)

    out, grads = port_vjp(q, k, v, sqk, do, scale, "bounded", dtype)
    np.testing.assert_allclose(as_np(out), as_np(out_ref), **TOL[dtype])
    assert_grads_close(grads, grads_ref, TOL[dtype])


def test_k5_clamp_regime_floors_whole_rows():
    """Where the floor fires in whole rows the bounded arm degrades to
    uniform attention (o = mean of v), finite, with lse = bound + log Σ e^−60
    — the JAX kernel's documented behaviour, not row-max's answer."""
    q, k, v, sqk, _ = qkv_inputs(72, s=REGIMES["clamp"])
    args = [torch.from_numpy(x) for x in (q, k, v, sqk)]
    o, lse = fa.flash_attention_qknorm_ref(*args, 8.0, "bounded")
    o_rowmax, _ = fa.flash_attention_qknorm_ref(*args, 8.0, "rowmax")
    uniform = args[2].mean(dim=-2, keepdim=True).expand_as(o)
    torch.testing.assert_close(o, uniform, rtol=1e-5, atol=1e-5)
    bound = fa.head_bounds(args[3], 8.0).reshape(1, -1, 1)
    torch.testing.assert_close(lse, (bound + (-60.0 + np.log(64.0))).expand_as(lse), rtol=1e-6, atol=1e-4)
    assert (o - o_rowmax).abs().max() > 0.1


@pytest.mark.parametrize("side", ["bounded", "rowmax"])
def test_auto_matches_jax_on_both_sides_of_the_gate(side):
    """mode="auto" against JAX's ``flash_attention_qknorm(mode="auto")`` in
    fp32, forward and ``jax.vjp``: below the gate (scale·max(sqk²) < 20) the
    bounded arm for every head, sqk × 2 above it the row-max arm; the
    backward is the plain exp(s − lse) either way.  Tolerance TOL["fp32"]."""
    q, k, v, sqk, do = qkv_inputs(74)
    if side == "rowmax":
        sqk = 2 * sqk
    scale = 8.0
    assert fa.bounded_arm(torch.from_numpy(sqk), scale, "auto") == (side == "bounded")
    with pltpu.force_tpu_interpret_mode():
        out_ref, grads_ref = jax_vjp(q, k, v, sqk, do, scale, "auto", "fp32")
    out, grads = port_vjp(q, k, v, sqk, do, scale, "auto", "fp32")
    np.testing.assert_allclose(as_np(out), as_np(out_ref), **TOL["fp32"])
    assert_grads_close(grads, grads_ref, TOL["fp32"])
    # the arm taken is the gate's: the twin's output is that static mode's
    want, _ = fa.flash_attention_qknorm_ref(*(torch.from_numpy(x) for x in (q, k, v, sqk)), scale, side)
    assert torch.equal(out.detach(), want)


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


# ------------------------------------------------------------------ dispatch
def test_cpu_tensors_run_the_twins_and_wrappers_refuse_them():
    """No fallback: on CPU tensors the entry points run the twins, chosen by
    device alone; the K5/K6 launch wrappers raise and count no launch; an
    unknown mode is refused."""
    q, k, v, sqk, do = (torch.from_numpy(x) for x in qkv_inputs(78, t=16, d=32))
    for mode in ("bounded", "auto"):
        want, lse = fa.flash_attention_qknorm_ref(q, k, v, sqk, 5.0, mode)
        assert torch.equal(fa.flash_attention_qknorm(q, k, v, sqk, 5.0, mode=mode), want)
        before = (fa.qknorm_attention_fwd.launches_bounded, fa.qknorm_attention_fwd.launches_auto,
                  fa.qknorm_attention_bwd.launches_bounded)
        with pytest.raises(ValueError, match="CUDA"):
            fa.qknorm_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), sqk, 5.0, mode=mode)
        with pytest.raises(ValueError, match="CUDA"):
            fa.qknorm_attention_bwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), sqk, 5.0, want.bfloat16(),
                                    lse, do.bfloat16(), mode)
        assert before == (fa.qknorm_attention_fwd.launches_bounded, fa.qknorm_attention_fwd.launches_auto,
                          fa.qknorm_attention_bwd.launches_bounded)
    with pytest.raises(ValueError, match="mode"):
        fa.flash_attention_qknorm(q, k, v, sqk, 5.0, mode="max")

    x, w, b, _ = (torch.from_numpy(a).bfloat16() for a in mlp_inputs(79, n=20, k=64, h=64))
    assert torch.equal(gated_mlp(x, w, b), gated_mlp_ref(x, w, b))
    assert torch.equal(gated_mlp(x, w, b, use_kernel=False), gated_mlp_xla(x, w, b))
    before = (gated_mlp_fwd.launches_bias, gated_mlp_bwd_duv.launches_bias)
    with pytest.raises(ValueError, match="CUDA"):
        gated_mlp_fwd(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        gated_mlp_bwd_duv(x, w, torch.zeros(20, 64, dtype=torch.bfloat16), b)
    assert before == (gated_mlp_fwd.launches_bias, gated_mlp_bwd_duv.launches_bias)


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
