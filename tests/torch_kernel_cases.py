"""Shared inputs and helpers of the port's kernel-twin parity tests
(tests/test_torch_kernels.py, tests/test_torch_kernels_gated.py,
tests/test_torch_kernels_bwd.py)."""

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.ops.flash_attention import flash_attention_qknorm as jax_flash_qknorm

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


def mlp_inputs(seed, n=256, k=128, h=256):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k), dtype=np.float32)
    w = (0.1 * rng.standard_normal((2 * h, k))).astype(np.float32)  # torch [2H, K] layout
    return x, w


# fp32: the tolerances of tests/test_gated_mlp.py; bf16 as above
MLP_TOL = {"fp32": dict(rtol=2e-5, atol=2e-6), "bf16": dict(rtol=2e-2, atol=2e-2)}


def jax_qknorm_vjp(q, k, v, sqk, do, scale, jdt):
    """dq, dk, dv, d(sqk_eff) of the Pallas rowmax kernels (K1 forward, K2
    backward), run in interpret mode."""
    import jax

    def f(q_, k_, v_, s_):
        return jax_flash_qknorm(q_, k_, v_, s_, scale, mode="rowmax")

    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(f, *(to_jax(x, jdt) for x in (q, k, v)), jnp.asarray(sqk))
        return vjp(to_jax(do, jdt))
