"""The port's kernel twins against the JAX package's Pallas kernels.

K1/K2 (QK-norm flash attention forward and backward, row-max arm) and K3/K4
(fused gated MLP forward and backward) are CUDA kernels in the port; on the
CPU their wrappers and ``autograd.Function``s run the plain PyTorch twins.
Here each twin is held against the Pallas kernel it replaces, run as the JAX
tests run it (``force_tpu_interpret_mode``; the backwards through
``jax.vjp``), and the plain ``flash_attn=False`` path against the JAX
package's XLA functions.  Inputs are made from a seed with numpy and handed
to both frameworks.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.ops.attention import qknorm_project_xla, sdpa_xla
from nvit_tpu.ops.flash_attention import _fwd_qknorm, _pad_len
from nvit_tpu.ops.flash_attention import flash_attention_qknorm as jax_flash_qknorm
from nvit_tpu.ops.gated_mlp import _gated_core, _xla_gated
from nvit_tpu_torch.ops.attention import attention_qknorm
from nvit_tpu_torch.ops.flash_attention import (
    flash_attention_qknorm,
    flash_attention_qknorm_ref,
    qknorm_attention_bwd,
    qknorm_attention_bwd_ref,
    qknorm_attention_fwd,
)
from nvit_tpu_torch.ops.gated_mlp import (
    gated_mlp,
    gated_mlp_bwd_duv,
    gated_mlp_bwd_ref,
    gated_mlp_duv_ref,
    gated_mlp_fwd,
    gated_mlp_ref,
    gated_mlp_xla,
)

torch.set_num_threads(1)

# (jax dtype, torch dtype, tolerance).  fp32: the two agree up to summation
# order (the tolerances of tests/test_flash_attention.py); bf16: one bf16
# rounding of q̂/k̂/P/O may land on either side, 2^-7 ≈ 8e-3 relative.
DTYPES = {
    "fp32": (jnp.float32, torch.float32, dict(rtol=2e-4, atol=2e-5)),
    "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2)),
}


def qkv_inputs(seed, b=2, h=2, t=64, d=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(3))
    sqk = (1.0 + 0.1 * rng.standard_normal((h, d))).astype(np.float32)
    return q, k, v, sqk


def to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k1_twin_matches_pallas_rowmax(t, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, sqk = qkv_inputs(10 + t, t=t)
    scale = float(np.sqrt(32))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash_qknorm(*(to_jax(x, jdt) for x in (q, k, v)), jnp.asarray(sqk), scale,
                               mode="rowmax")
    out, _ = flash_attention_qknorm_ref(*(to_torch(x, tdt) for x in (q, k, v)),
                                        torch.from_numpy(sqk), scale)
    assert out.dtype == tdt and out.shape == q.shape
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)


def test_k1_twin_lse_matches_pallas():
    """lse = m + log l of the padded T=100 call (t_pad 104 in fp32): the
    statistic the backward (K2) will recompute P from."""
    b, h, t, d = 2, 2, 100, 32
    q, k, v, sqk = qkv_inputs(7, b=b, h=h, t=t, d=d)
    scale = float(np.sqrt(d))
    t_pad = _pad_len(t, jnp.float32)
    assert t_pad > t

    def prep(x):
        return jnp.pad(jnp.asarray(x).reshape(b * h, t, d), ((0, 0), (0, t_pad - t), (0, 0)))

    s3 = jnp.broadcast_to(jnp.asarray(sqk).reshape(1, h, 1, d), (b, h, 1, d)).reshape(b * h, 1, d)
    with pltpu.force_tpu_interpret_mode():
        o_ref, lse_ref = _fwd_qknorm(prep(q), prep(k), prep(v), s3, scale, t, mode="rowmax")
    o, lse = flash_attention_qknorm_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                        torch.from_numpy(sqk), scale)
    # fp32 tolerances of tests/test_flash_attention.py (summation order only)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(lse_ref)[:, :t, 0],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(o.numpy().reshape(b * h, t, d), np.asarray(o_ref)[:, :t],
                               rtol=2e-4, atol=2e-5)


def test_k1_dispatch_on_cpu_is_the_twin():
    q, k, v, sqk = qkv_inputs(3, t=48)
    args = [to_torch(x, torch.bfloat16) for x in (q, k, v)] + [torch.from_numpy(sqk)]
    want, _ = flash_attention_qknorm_ref(*args, 5.0)
    assert torch.equal(flash_attention_qknorm(*args, 5.0), want)
    assert torch.equal(attention_qknorm(*args, 5.0, use_flash=True), want)


def test_k1_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the launch wrapper raises instead of running the twin."""
    q, k, v, sqk = qkv_inputs(4, t=16)
    args = [to_torch(x, torch.bfloat16) for x in (q, k, v)] + [torch.from_numpy(sqk)]
    before = qknorm_attention_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        qknorm_attention_fwd(*args, 5.0)
    assert qknorm_attention_fwd.launches == before


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_attention_matches_xla(dtype):
    """flash_attn=False: qknorm_project + sdpa against their XLA originals."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, sqk = qkv_inputs(20, t=50)
    scale = float(np.sqrt(32))
    qh, kh = qknorm_project_xla(to_jax(q, jdt), to_jax(k, jdt), jnp.asarray(sqk), jdt)
    ref = sdpa_xla(qh, kh, to_jax(v, jdt), scale)
    out = attention_qknorm(*(to_torch(x, tdt) for x in (q, k, v)), torch.from_numpy(sqk), scale,
                           use_flash=False)
    assert out.dtype == tdt
    np.testing.assert_allclose(as_np(out), as_np(ref), **tol)


# ------------------------------------------------------------------ K3
def mlp_inputs(seed, n=256, k=128, h=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k), dtype=np.float32)
    w = (0.1 * rng.standard_normal((2 * h, k))).astype(np.float32)  # torch [2H, K] layout
    return x, w


# fp32: the tolerances of tests/test_gated_mlp.py; bf16 as above
MLP_TOL = {"fp32": dict(rtol=2e-5, atol=2e-6), "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k3_twin_matches_pallas(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x, w = mlp_inputs(30)
    h = w.shape[0] // 2
    wj = to_jax(w.T, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = _gated_core(to_jax(x, jdt), wj[:, :h], wj[:, h:])
    out = gated_mlp_ref(to_torch(x, tdt), to_torch(w, tdt))
    assert out.dtype == tdt and out.shape == (x.shape[0], h)
    np.testing.assert_allclose(as_np(out), as_np(ref), **MLP_TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_plain_gated_mlp_matches_xla(dtype):
    """gated_mlp_kernel='off': the unfused chain against _xla_gated."""
    jdt, tdt, _ = DTYPES[dtype]
    x, w = mlp_inputs(31, n=40, k=64, h=96)
    ref = _xla_gated(to_jax(x, jdt), to_jax(w.T, jdt), None)
    out = gated_mlp_xla(to_torch(x, tdt), to_torch(w, tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(as_np(out), as_np(ref), **MLP_TOL[dtype])


def test_k3_dispatch_on_cpu_is_the_twin():
    x, w = mlp_inputs(32, n=20, k=64, h=64)
    xt, wt = to_torch(x, torch.bfloat16), to_torch(w, torch.bfloat16)
    assert torch.equal(gated_mlp(xt, wt, use_kernel=True), gated_mlp_ref(xt, wt))
    assert torch.equal(gated_mlp(xt, wt, use_kernel=False), gated_mlp_xla(xt, wt))
    before = gated_mlp_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        gated_mlp_fwd(xt, wt)
    assert gated_mlp_fwd.launches == before


# ------------------------------------------------------------------ K2
def jax_qknorm_vjp(q, k, v, sqk, do, scale, jdt):
    """dq, dk, dv, d(sqk_eff) of the Pallas rowmax kernels (K1 forward, K2
    backward), run in interpret mode."""
    import jax

    def f(q_, k_, v_, s_):
        return jax_flash_qknorm(q_, k_, v_, s_, scale, mode="rowmax")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(to_jax(x, jdt) for x in (q, k, v)), jnp.asarray(sqk))
        return vjp(to_jax(do, jdt))


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


# ------------------------------------------------------------------ K4
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k4_twin_and_autograd_match_pallas_vjp(dtype):
    """GatedMLPFn on CPU tensors (K3's twin forward; K4's twin + the dense
    dW/dx backward) against jax.vjp of the fused core at n = 256, K = 128,
    H = 512; fp32 to the tolerances of tests/test_gated_mlp.py, bf16 2e-2."""
    import jax

    jdt, tdt, _ = DTYPES[dtype]
    x, w = mlp_inputs(33, n=256, k=128, h=512)
    h = w.shape[0] // 2
    g = np.random.default_rng(34).standard_normal((256, h), dtype=np.float32)
    wj = to_jax(w.T, jdt)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(_gated_core, to_jax(x, jdt), wj[:, :h], wj[:, h:])
        dx_ref, dwu_ref, dwv_ref = vjp(to_jax(g, jdt))
    dw_ref = np.concatenate([as_np(dwu_ref).T, as_np(dwv_ref).T])

    xt, wt = to_torch(x, tdt).requires_grad_(), to_torch(w, tdt).requires_grad_()
    gated_mlp(xt.reshape(4, 64, 128), wt, use_kernel=True).backward(to_torch(g, tdt).reshape(4, 64, h))
    tol = MLP_TOL[dtype] if dtype == "bf16" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(as_np(xt.grad), as_np(dx_ref), **tol)
    np.testing.assert_allclose(as_np(wt.grad), dw_ref, **tol)

    with torch.no_grad():
        dx, dw, db = gated_mlp_bwd_ref(to_torch(x, tdt), to_torch(w, tdt), to_torch(g, tdt))
    assert torch.equal(dx, xt.grad) and torch.equal(dw, wt.grad) and db is None
    duv = gated_mlp_duv_ref(to_torch(x, tdt), to_torch(w, tdt), to_torch(g, tdt))
    assert duv.shape == (256, 2 * h) and duv.dtype == tdt


def test_k4_kernel_wrapper_refuses_cpu_tensors():
    x, w = (to_torch(a, torch.bfloat16) for a in mlp_inputs(35, n=16, k=64, h=64))
    before = gated_mlp_bwd_duv.launches
    with pytest.raises(ValueError, match="CUDA"):
        gated_mlp_bwd_duv(x, w, torch.zeros(16, 64, dtype=torch.bfloat16))
    assert gated_mlp_bwd_duv.launches == before


def test_gated_bench_unfused_backward_is_the_gate_vjp():
    """The bench's unfused backward chain computes K4's function: in fp32 it
    is gated_mlp_duv_ref; the bench refuses to run without a card."""
    from nvit_tpu_torch.scripts import gated_mlp_bench

    x, w = (torch.from_numpy(a) for a in mlp_inputs(36, n=16, k=64, h=64))
    g = torch.from_numpy(np.random.default_rng(37).standard_normal((16, 64)).astype(np.float32))
    torch.testing.assert_close(gated_mlp_bench.unfused_bwd(x, w, g), gated_mlp_duv_ref(x, w, g),
                               rtol=1e-5, atol=1e-5)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        assert gated_mlp_bench.main([]) == 1


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
