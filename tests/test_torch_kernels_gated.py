"""The port's gated-MLP twins against the JAX package (a companion of
tests/test_torch_kernels.py): the unfused chain against ``_xla_gated``, K3's
dispatch on the CPU, K4's twin and ``GatedMLPFn`` against the Pallas
backward through ``jax.vjp``, the wrappers' refusals, and the bench's
unfused backward. Inputs from tests/torch_kernel_cases.py.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.ops.gated_mlp import _gated_core, _xla_gated
from nvit_tpu_torch.ops.gated_mlp import (
    gated_mlp,
    gated_mlp_bwd_duv,
    gated_mlp_bwd_ref,
    gated_mlp_duv_ref,
    gated_mlp_fwd,
    gated_mlp_ref,
    gated_mlp_xla,
)
from tests.torch_kernel_cases import DTYPES, MLP_TOL, as_np, mlp_inputs, to_jax, to_torch

torch.set_num_threads(1)


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
