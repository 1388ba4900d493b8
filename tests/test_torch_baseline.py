"""The port's baseline mode (``use_nvit=False``) against the JAX package on the CPU.

* K7/K8's plain twins against the Pallas kernels they replace
  (``_fwd_kernel``, ``_bwd_fused_kernel``), run as
  tests/test_flash_attention.py runs them (``force_tpu_interpret_mode``),
  fed the same residuals (tests/torch_baseline_cases.py); the dispatch on
  the CPU and the backward's prologue;
* K9 and ``FlashAttnFn`` are tests/test_torch_baseline_bwd.py, the model
  and two training steps tests/test_torch_baseline_model.py.

Inputs are made from a seed with numpy and handed to both frameworks.  Every
tolerance is stated where it is used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu_torch.ops import flash_attention as fa
from nvit_tpu_torch.ops.attention import attention, sdpa
from tests.torch_baseline_cases import (
    SHAPES,
    TDT,
    TOL,
    as_np,
    jax_bwd,
    port_operands,
    qkv,
    residuals,
    to_torch,
    unpad,
)

torch.set_num_threads(1)


# ------------------------------------------------------------------ K7
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k7_twin_matches_pallas(residuals, shape, dtype):
    b, h, t, d = shape
    case = residuals(dtype, shape)
    *_, o_ref, lse_ref = case["res"]
    o, lse = fa.flash_attention_ref(*(to_torch(x, TDT[dtype]) for x in case["arrays"][:3]), case["scale"])
    assert o.dtype == TDT[dtype] and o.shape == shape and lse.shape == (b, h, t)
    np.testing.assert_allclose(as_np(o), unpad(o_ref, shape), **TOL[dtype])
    # lse: fp32 scores of the same operands in both policies — summation order only
    np.testing.assert_allclose(lse.numpy(), unpad(lse_ref, shape), rtol=1e-4, atol=1e-4)


def test_scale_is_rounded_to_the_input_dtype_first():
    """The TPU kernels' ``q_ref[0] * scale`` rounds the weak-typed Python
    scale to bf16 before the product; at D = 32 that changes q·scale."""
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    scale = 1.0 / np.sqrt(32.0)
    want = np.asarray((jnp.asarray(x).astype(jnp.bfloat16) * float(scale)).astype(jnp.float32))
    got = fa._scaled(torch.from_numpy(x).bfloat16(), float(scale)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert fa._bf16_scale(scale) != np.float32(scale) and fa._bf16_scale(0.125) == 0.125


# ------------------------------------------------------------------ K8
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k8_twin_matches_pallas(residuals, shape, dtype):
    """attention_bwd_fused_ref against _bwd_fused_kernel (``_bwd`` at
    T_pad ≤ 1024)."""
    case = residuals(dtype, shape)
    want = jax_bwd(case)
    q, k, v, do, o, lse = port_operands(case, dtype, shape)
    got = fa.attention_bwd_fused_ref(q, k, v, o, lse, do, case["scale"])
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == TDT[dtype] and a.shape == shape, name
        np.testing.assert_allclose(as_np(a), unpad(r, shape), **TOL[dtype], err_msg=name)


def test_dispatch_on_cpu_is_the_twin_and_wrappers_refuse_cpu():
    """CPU tensors run the twins, chosen by device alone; the launch wrappers
    raise on them instead of falling back, and count no launch."""
    q, k, v, do = (to_torch(x, torch.bfloat16) for x in qkv(90, 1, 2, 40, 32))
    want, lse = fa.flash_attention_ref(q, k, v, 0.25)
    assert torch.equal(fa.flash_attention(q, k, v, 0.25), want)
    assert torch.equal(attention(q, k, v, 0.25, use_flash=True), want)
    assert torch.equal(attention(q, k, v, 0.25, use_flash=False), sdpa(q, k, v, 0.25))
    with torch.inference_mode():
        assert fa.flash_attention(q, k, v, 0.25).grad_fn is None
    delta = fa.attention_delta(want, do)
    counters = (fa.flash_attention_fwd, fa.attention_bwd_fused, fa.attention_bwd_split)
    before = [f.launches for f in counters]
    for call in (lambda: fa.flash_attention_fwd(q, k, v, 0.25),
                 lambda: fa.attention_bwd_fused(q, k, v, want, lse, do, 0.25),
                 lambda: fa.attention_bwd_split(q, k, v, do, lse, delta, 0.25)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [f.launches for f in counters] == before


def test_backward_prologue_twin_matches_jax_fold_and_delta():
    """The baseline backward's prologue on CPU tensors (its twin,
    ``flash_project_bf16_ref``): qs and ks bit-equal to ``_bwd_fused_kernel``'s
    bf16 fold ``q3 * scale`` at D = 32, where 1/sqrt(32) is not bf16-exact,
    and a ragged T; Δ within 1e-6 of ``_bwd``'s XLA rowsum(g ∘ o) in fp32;
    lse and Δ zero-padded to whole 64-row tiles.  K9's call copies the given
    Δ and makes no ks."""
    b, h, t, d = 2, 2, 100, 32
    q, k, o, do = qkv(91, b, h, t, d)
    lse = np.random.default_rng(92).standard_normal((b, h, t), dtype=np.float32)
    scale = 1.0 / float(np.sqrt(d))
    qt, kt, ot, dot = (to_torch(x, torch.bfloat16) for x in (q, k, o, do))
    lse_t = torch.from_numpy(lse)
    qs, ks, lse_pad, delta_pad = fa.flash_project_bf16(qt, kt, scale, lse=lse_t, o=ot, do=dot)
    for got, x in ((qs, q), (ks, k)):
        want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16) * scale).reshape(b * h, t, d)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b * h, t, d)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    g32, o32 = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) for x in (do, o))
    jdelta = np.asarray(jnp.sum(g32 * o32, axis=-1)).reshape(b * h, t)  # ≙ _bwd's Δ
    assert tuple(lse_pad.shape) == tuple(delta_pad.shape) == (b * h, 128)
    np.testing.assert_allclose(delta_pad[:, :t].numpy(), jdelta, rtol=1e-6, atol=1e-6)
    assert torch.equal(lse_pad[:, :t], lse_t.reshape(b * h, t))
    assert not lse_pad[:, t:].any() and not delta_pad[:, t:].any()
    delta = fa.attention_delta(ot, dot)
    qs9, ks9, lse9, delta9 = fa.flash_project_bf16(qt, kt, scale, lse=lse_t, delta=delta)
    assert ks9 is None and torch.equal(qs9, qs) and torch.equal(lse9, lse_pad)
    assert torch.equal(delta9[:, :t], delta.reshape(b * h, t)) and not delta9[:, t:].any()
    with pytest.raises(ValueError, match="o and do"):
        fa.flash_project_bf16(qt, kt, scale, lse=lse_t)
