"""The port's kernel twins against the JAX package's Pallas kernels.

K1/K2 (QK-norm flash attention forward and backward, row-max arm) and K3/K4
(fused gated MLP forward and backward) are CUDA kernels in the port; on the
CPU their wrappers and ``autograd.Function``s run the plain PyTorch twins.
Here each twin is held against the Pallas kernel it replaces, run as the JAX
tests run it (``force_tpu_interpret_mode``; the backwards through
``jax.vjp``), and the plain ``flash_attn=False`` path against the JAX
package's XLA functions.  Inputs are made from a seed with numpy and handed
to both frameworks (tests/torch_kernel_cases.py).  This file holds K1 and
K3's forward; the gated MLP's plain chain, dispatch and K4 are
tests/test_torch_kernels_gated.py, K2 and the prologue
tests/test_torch_kernels_bwd.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.ops.attention import qknorm_project_xla, sdpa_xla
from nvit_tpu.ops.flash_attention import _fwd_qknorm, _pad_len
from nvit_tpu.ops.flash_attention import flash_attention_qknorm as jax_flash_qknorm
from nvit_tpu.ops.gated_mlp import _gated_core
from nvit_tpu_torch.ops.attention import attention_qknorm
from nvit_tpu_torch.ops.flash_attention import (
    flash_attention_qknorm,
    flash_attention_qknorm_ref,
    qknorm_attention_fwd,
)
from nvit_tpu_torch.ops.gated_mlp import gated_mlp_ref
from tests.torch_kernel_cases import (
    DTYPES,
    MLP_TOL,
    as_np,
    mlp_inputs,
    qkv_inputs,
    to_jax,
    to_torch,
)

torch.set_num_threads(1)


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
