"""The port's kernel twins against the JAX package's Pallas kernels.

K1 (QK-norm flash attention forward, row-max arm) and K3 (fused gated MLP
forward) are CUDA kernels in the port; on the CPU their wrappers run the
plain PyTorch twins.  Here each twin is held against the Pallas kernel it
replaces, run as the JAX tests run it (``force_tpu_interpret_mode``), and the
plain ``flash_attn=False`` path against the JAX package's XLA functions.
Inputs are made from a seed with numpy and handed to both frameworks.
"""

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
    qknorm_attention_fwd,
)
from nvit_tpu_torch.ops.gated_mlp import gated_mlp, gated_mlp_fwd, gated_mlp_ref, gated_mlp_xla

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


def test_bounded_softmax_not_ported_raises():
    q, k, v, sqk = qkv_inputs(5, t=16)
    args = [torch.from_numpy(x) for x in (q, k, v, sqk)]
    with pytest.raises(NotImplementedError, match="K5"):
        attention_qknorm(*args, 5.0, use_flash=True, bounded_softmax="bounded")


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
