"""The port's QK-norm attention backward and projection prologue against the
JAX package (a companion of tests/test_torch_kernels.py): K2's twin and
``FlashQKNormFn`` against the Pallas kernels through ``jax.vjp``, the
forward without autograd, the wrappers' refusals, the fused QKV gradient,
and the prologue's twin against ``_normed_scaled``. Inputs from
tests/torch_kernel_cases.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu_torch.ops.flash_attention import (
    flash_attention_qknorm,
    flash_attention_qknorm_ref,
    qknorm_attention_bwd,
    qknorm_attention_bwd_ref,
)
from nvit_tpu_torch.ops.gated_mlp import gated_mlp
from tests.torch_kernel_cases import (
    DTYPES,
    as_np,
    jax_qknorm_vjp,
    mlp_inputs,
    qkv_inputs,
    to_jax,
    to_torch,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("shape", [(2, 2, 100, 32), (1, 2, 64, 64)])  # ragged T; head dim 64
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k2_twin_and_autograd_match_pallas_vjp(shape, dtype):
    """FlashQKNormFn on CPU tensors (K1's twin forward, K2's twin backward)
    against jax.vjp of the Pallas kernels: dq, dk, dv and d sqk_eff.  fp32 to
    rtol 1e-4 / atol 1e-5 (summation order); bf16 to 2e-2 (one bf16 rounding
    of q̂/k̂/P/dS/O may land on either side)."""
    jdt, tdt, _ = DTYPES[dtype]
    b, h, t, d = shape
    q, k, v, sqk = qkv_inputs(40 + t + d, b=b, h=h, t=t, d=d)
    do = np.random.default_rng(41).standard_normal(q.shape, dtype=np.float32)
    scale = float(np.sqrt(d))
    ref = jax_qknorm_vjp(q, k, v, sqk, do, scale, jdt)

    qt, kt, vt = (to_torch(x, tdt).requires_grad_() for x in (q, k, v))
    st = torch.from_numpy(sqk).requires_grad_()
    out = flash_attention_qknorm(qt, kt, vt, st, scale)
    out.backward(to_torch(do, tdt))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "fp32" else dict(rtol=2e-2, atol=2e-2)
    for name, got, want in zip(("dq", "dk", "dv", "dsqk"), (qt.grad, kt.grad, vt.grad, st.grad), ref):
        assert got.dtype == (torch.float32 if name == "dsqk" else tdt), name
        np.testing.assert_allclose(as_np(got), as_np(want), **tol, err_msg=name)

    # the autograd Function's backward is the twin, called on the saved tensors
    with torch.no_grad():
        o, lse = flash_attention_qknorm_ref(qt, kt, vt, st, scale)
        dq, dk, dv, dsqk = qknorm_attention_bwd_ref(qt, kt, vt, st, scale, o, lse, to_torch(do, tdt))
    assert dsqk.shape == (b, h, d)
    for got, want in ((qt.grad, dq), (kt.grad, dk), (vt.grad, dv), (st.grad, dsqk.sum(0))):
        assert torch.equal(got, want)


def test_forward_without_autograd_saves_nothing():
    """Inference (no grad, or no input that requires grad) takes the plain
    forward: no autograd node, so no lse and no saved tensors."""
    q, k, v, sqk = (torch.from_numpy(x) for x in qkv_inputs(6, t=16))
    with torch.inference_mode():
        assert flash_attention_qknorm(q, k, v, sqk, 5.0).grad_fn is None
    assert flash_attention_qknorm(q, k, v, sqk, 5.0).grad_fn is None
    assert flash_attention_qknorm(q, k, v, sqk.requires_grad_(), 5.0).grad_fn is not None
    x, w = (torch.from_numpy(a) for a in mlp_inputs(7, n=8, k=64, h=64))
    with torch.no_grad():
        assert gated_mlp(x, w.requires_grad_()).grad_fn is None
    assert gated_mlp(x, w).grad_fn is not None


def test_k2_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, sqk = (to_torch(x, torch.bfloat16) for x in qkv_inputs(8, t=16))
    o, lse = flash_attention_qknorm_ref(q, k, v, sqk.float(), 5.0)
    before = qknorm_attention_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        qknorm_attention_bwd(q, k, v, sqk.float(), 5.0, o, lse, o)
    assert qknorm_attention_bwd.launches == before


def test_fused_qkv_gradient_is_k2s_buffer_without_a_copy():
    """K2 writes dq, dk, dv as adjacent views of one [B, T, 3, H, D] buffer;
    SplitFusedHeads hands that buffer back as the fused QKV gradient without
    copying it, and concatenates any other gradients."""
    from types import SimpleNamespace

    from nvit_tpu_torch.models.blocks import SplitFusedHeads, merge_heads, split_heads

    b, t, h, d = 2, 5, 3, 4
    x = torch.randn(b, t, 3 * h * d)
    q, k, v = SplitFusedHeads.apply(x, 3, h)
    for got, want in zip((q, k, v), torch.chunk(x, 3, dim=-1)):
        assert torch.equal(got, split_heads(want, h))
    ctx = SimpleNamespace(dims=(b, t, 3, h, d))
    buf = torch.randn(b, t, 3, h, d)
    grads = [buf[:, :, i].permute(0, 2, 1, 3) for i in range(3)]
    want = torch.cat([merge_heads(g) for g in grads], dim=-1)
    fused, *_ = SplitFusedHeads.backward(ctx, *grads)
    assert fused.data_ptr() == buf.data_ptr() and torch.equal(fused, want)
    separate = [g.contiguous() for g in grads]  # the CPU twin's gradients
    fused, *_ = SplitFusedHeads.backward(ctx, *separate)
    assert fused.data_ptr() != buf.data_ptr() and torch.equal(fused, want)


# ------------------------------------------------------- projection prologue
@pytest.mark.parametrize("t", [64, 100])
def test_projection_prologue_twin_matches_jax_normed_scaled(t):
    """The prologue's twin rounds the JAX kernels' fp32 projection
    (flash_attention.py:_normed_scaled, x̂ = s ⊙ x/max(‖x‖, eps)) to bf16
    once; the backward's call adds k̂_s, Δ = rowsum(dO ∘ O) and lse, padded
    with zeros to whole 64-row tiles.  On CPU tensors the wrapper is the twin."""
    from nvit_tpu.ops.flash_attention import _normed_scaled as jax_normed_scaled
    from nvit_tpu_torch.ops.flash_attention import qknorm_project_bf16, qknorm_project_bf16_ref

    q, k, v, sqk = qkv_inputs(40 + t, t=t)
    o, do = (np.random.default_rng(t).standard_normal(q.shape).astype(np.float32) for _ in range(2))
    lse = np.random.default_rng(t + 1).standard_normal(q.shape[:3]).astype(np.float32)
    scale = float(np.sqrt(32))
    s = jnp.asarray(sqk)[None, :, None, :]
    qb, kb = (to_jax(x, jnp.bfloat16) for x in (q, k))
    want = [np.asarray(jax_normed_scaled(x, sx)[0].astype(jnp.bfloat16).astype(jnp.float32)).reshape(-1, t, 32)
            for x, sx in ((qb, s * scale), (kb, s), (kb, s * scale))]
    args = [to_torch(x, torch.bfloat16) for x in (q, k)] + [torch.from_numpy(sqk), scale]
    stats = dict(o=to_torch(o, torch.bfloat16), do=to_torch(do, torch.bfloat16), lse=torch.from_numpy(lse))
    got = qknorm_project_bf16(*args, **stats)
    assert [x.dtype for x in got[:3]] == [torch.bfloat16] * 3
    for g, w in zip(got[:3], want):
        np.testing.assert_array_equal(as_np(g), w)
    t_pad = -(-t // 64) * 64
    lse_pad, delta = (as_np(x).reshape(2, 2, t_pad) for x in got[3:])
    np.testing.assert_array_equal(lse_pad[..., :t], lse)
    ob, dob = (as_np(stats[n]) for n in ("o", "do"))
    np.testing.assert_allclose(delta[..., :t], np.sum(ob * dob, axis=-1), rtol=1e-5, atol=1e-5)
    assert not lse_pad[..., t:].any() and not delta[..., t:].any()
    fwd = qknorm_project_bf16_ref(*args)  # the forward's call: q̂_s and k̂ only
    assert fwd[2:] == (None, None, None)
    assert all(torch.equal(a, b) for a, b in zip(fwd[:2], got[:2]))
