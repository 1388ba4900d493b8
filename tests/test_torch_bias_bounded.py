"""The port's bias and bounded-softmax kernels against the JAX package.

* K6 — the gated MLP with a bias (``_gated_core_b``): the twins and
  ``GatedMLPFn`` against the Pallas kernels in interpret mode, with dx, dW and
  db through ``jax.vjp``; the plain chain's rounding order (``_xla_gated``);
* K5 — the bounded arm of the QK-norm attention kernels (``_fwd_qknorm`` /
  ``_bwd_qknorm`` with ``mode="bounded"``) where the clamp is inert and where
  it floors whole rows; ``mode="auto"`` on both sides of its gate;
* dispatch: CPU tensors run the twins, the launch wrappers refuse them;
* the long-sequence branch and the ViT forwards are
  tests/test_torch_bias_bounded_model.py; the shared inputs
  tests/torch_bias_cases.py.

Inputs are made from a seed with numpy and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nvit_tpu.ops.flash_attention import _fwd_qknorm
from nvit_tpu.ops.gated_mlp import _gated_core_b
from nvit_tpu_torch.ops import flash_attention as fa
from nvit_tpu_torch.ops.gated_mlp import (
    gated_mlp,
    gated_mlp_bwd_duv,
    gated_mlp_bwd_ref,
    gated_mlp_fwd,
    gated_mlp_ref,
    gated_mlp_xla,
)
from tests.torch_bias_cases import (
    REGIMES,
    TDT,
    TOL,
    as_np,
    assert_grads_close,
    jax_vjp,
    mlp_inputs,
    port_vjp,
    qkv_inputs,
    to_jax,
    to_torch,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ K6
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
