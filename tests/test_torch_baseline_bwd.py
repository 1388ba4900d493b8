"""The baseline backward against the JAX package on the CPU (a companion of
tests/test_torch_baseline.py): K9's plain twins against ``_dq_kernel`` /
``_dkv_kernel`` (reached at a small T by ``NVIT_TUNE_FUSED_BWD_MAX_T=0``,
which ``nvit_tpu/ops/tuning.py`` reads at call time), and ``FlashAttnFn``
against ``jax.vjp`` of the JAX package's ``flash_attention``, through the
fused and the split backward. Every tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu_torch.ops import flash_attention as fa
from tests.torch_baseline_cases import (
    JDT, SHAPES, TDT, TOL, as_np, jax_bwd, jax_fa, port_operands, qkv, residuals, to_torch, unpad,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k9_twins_match_pallas(monkeypatch, residuals, shape, dtype):
    """attention_dq_ref / attention_dkv_ref against _dq_kernel / _dkv_kernel:
    ``_bwd`` takes the split kernels with NVIT_TUNE_FUSED_BWD_MAX_T=0 and Δ
    from outside; the port's Δ = rowsum(dO∘O) of the same o."""
    case = residuals(dtype, shape)
    monkeypatch.setenv("NVIT_TUNE_FUSED_BWD_MAX_T", "0")
    want = jax_bwd(case)
    q, k, v, do, o, lse = port_operands(case, dtype, shape)
    delta = fa.attention_delta(o, do)
    got = (fa.attention_dq_ref(q, k, v, do, lse, delta, case["scale"]),
           *fa.attention_dkv_ref(q, k, v, do, lse, delta, case["scale"]))
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == shape, name
        np.testing.assert_allclose(as_np(a), unpad(r, shape), **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype,split", [("fp32", False), ("bf16", True)])
def test_flash_attn_fn_matches_jax_vjp(monkeypatch, dtype, split):
    """FlashAttnFn on CPU tensors (K7's twin forward; K8's, or past
    FUSED_BWD_MAX_T K9's, twin backward) against jax.vjp of the JAX
    package's flash_attention at T = 100, D = 32; both sides take the split
    backward when the threshold is 0.  Tolerances as the twins'."""
    if split:
        monkeypatch.setenv("NVIT_TUNE_FUSED_BWD_MAX_T", "0")
        monkeypatch.setattr(fa, "FUSED_BWD_MAX_T", 0)
    shape = (2, 2, 100, 32)
    q, k, v, do = qkv(80 + int(split), *shape)
    scale = 1.0 / float(np.sqrt(32))
    jdt, tdt = JDT[dtype], TDT[dtype]
    with pltpu.force_tpu_interpret_mode():
        out_ref, vjp = jax.vjp(lambda a, b_, c: jax_fa.flash_attention(a, b_, c, scale),
                               *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
        grads_ref = vjp(jnp.asarray(do).astype(jdt))
    leaves = [to_torch(x, tdt).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale)
    assert out.grad_fn is not None and out.dtype == tdt
    out.backward(to_torch(do, tdt))
    np.testing.assert_allclose(as_np(out), as_np(out_ref), **TOL[dtype])
    for name, a, r in zip(("dq", "dk", "dv"), leaves, grads_ref):
        assert a.grad.dtype == tdt, name
        np.testing.assert_allclose(as_np(a.grad), as_np(r), **TOL[dtype], err_msg=name)
