"""Shared inputs and helpers of the port's bias / bounded-softmax parity
tests (tests/test_torch_bias_bounded.py, tests/test_torch_bias_bounded_model.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nvit_tpu.ops.flash_attention import flash_attention_qknorm as jax_flash_qknorm
from nvit_tpu_torch.ops import flash_attention as fa

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


def mlp_inputs(seed, n=256, k=128, h=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k), dtype=np.float32)
    w = (0.1 * rng.standard_normal((2 * h, k))).astype(np.float32)  # torch [2H, K]
    b = (0.5 * rng.standard_normal(2 * h)).astype(np.float32)
    g = rng.standard_normal((n, h), dtype=np.float32)
    return x, w, b, g


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
