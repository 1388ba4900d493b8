"""Shared cases of the port's baseline-kernel parity tests
(tests/test_torch_baseline.py, tests/test_torch_baseline_bwd.py): inputs
from a seed, the JAX package's padded residuals in interpret mode, and its
backward on them."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu


# the module, not the function the package re-exports under its name
jax_fa = importlib.import_module("nvit_tpu.ops.flash_attention")

# fp32: the same math, summation order only (tests/test_flash_attention.py's
# tolerances); bf16: one bf16 rounding of q·scale, P, dS or O may land on
# either side, 2^-7 ≈ 8e-3 relative
TOL = {"fp32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# (b, h, t, d): ragged T at head dim 32, where the scale 1/sqrt(32) is not
# bf16-exact; an exact tile at head dim 64
SHAPES = [(2, 2, 100, 32), (1, 2, 64, 64)]


def qkv(seed, b, h, t, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, t, d), dtype=np.float32) for _ in range(4)]  # q, k, v, dO


def as_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)


def unpad(x, shape):
    """[B·H, T_pad, D] → [B, H, T, D]; an lse [B·H, T_pad, 1] → [B, H, T]."""
    b, h, t, d = shape
    x = np.asarray(x, np.float32)[:, :t]
    return x.reshape(b, h, t) if x.shape[-1] == 1 else x.reshape(b, h, t, d)


@pytest.fixture(scope="module")
def residuals():
    """Per (dtype, shape), computed once: the numpy q, k, v, dO and the JAX
    package's padded [B·H, T_pad, D] operands with ``_fwd``'s (o, lse), in
    interpret mode.  T is padded to the 128 lane multiple, which both of
    ``_bwd``'s paths accept, so K7, K8 and K9 share one forward."""
    cache = {}

    def get(dtype, shape):
        if (dtype, shape) not in cache:
            b, h, t, d = shape
            jdt = JDT[dtype]
            arrays = qkv(50 + t + d, *shape)
            t_pad = jax_fa._pad_len(t)
            q3, k3, v3, g = (jnp.pad(jnp.asarray(x).astype(jdt).reshape(b * h, t, d),
                                     ((0, 0), (0, t_pad - t), (0, 0))) for x in arrays)
            scale = 1.0 / float(np.sqrt(d))
            with pltpu.force_tpu_interpret_mode():
                o, lse = jax_fa._fwd(q3, k3, v3, scale, t)
            cache[dtype, shape] = dict(arrays=arrays, scale=scale, res=(q3, k3, v3, o, lse), g=g)
        return cache[dtype, shape]

    return get


def jax_bwd(case):
    """dq, dk, dv of the JAX package's ``_bwd`` (interpret mode) on the
    shared residuals; it takes the fused kernel unless
    NVIT_TUNE_FUSED_BWD_MAX_T is below T_pad."""
    t = case["arrays"][0].shape[2]
    with pltpu.force_tpu_interpret_mode():
        return jax_fa._bwd(case["scale"], t, case["res"], case["g"])


def port_operands(case, dtype, shape):
    """q, k, v, dO, o, lse as the port's tensors; o and lse are the JAX
    forward's, so each backward twin is held alone."""
    tdt = TDT[dtype]
    q, k, v, do = (to_torch(x, tdt) for x in case["arrays"])
    *_, o, lse = case["res"]
    return q, k, v, do, to_torch(unpad(o, shape), tdt), torch.from_numpy(unpad(lse, shape).copy())
