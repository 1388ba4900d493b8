"""The port's patch extraction, embedding permutation, state_dict conversion
and residual backwards against the JAX package's (a companion of
tests/test_torch_core.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.ckpt.torch_interop import global_embed_permutation as jax_perm
from nvit_tpu.ckpt.torch_interop import state_dict_from_params
from nvit_tpu.core import residual as jr
from nvit_tpu.models import patch as jp
from nvit_tpu_torch.ckpt.convert import state_dict_from_jax
from nvit_tpu_torch.core import residual as tr
from nvit_tpu_torch.models import patch as tp
from nvit_tpu_torch.models.vit import ViT
from tests.torch_parity import port_config, random_jax_params
from tests.torch_core_cases import DTYPES, _jax_vjp, both, close, rnd, small_vit_cfg

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel,stride,size", [(8, 4, 16), (16, 8, 32), (6, 4, 16)])
def test_patch_extraction_is_exact(kernel, stride, size):
    """Pure data movement: bit-equal, including the (6, 4) im2col case."""
    img = rnd(11, 2, 3, size, size)
    np.testing.assert_array_equal(tp.space_to_depth(torch.from_numpy(img), stride).numpy(),
                                  np.asarray(jp.space_to_depth(jnp.asarray(img), stride)))
    pad = (kernel - stride) // 2
    padded_t = tp.reflect_pad(torch.from_numpy(img), pad)
    padded_j = jp.reflect_pad(jnp.asarray(img), pad)
    np.testing.assert_array_equal(padded_t.numpy(), np.asarray(padded_j))
    np.testing.assert_array_equal(
        tp.extract_overlapping_patches(padded_t, kernel, stride).numpy(),
        np.asarray(jp.extract_overlapping_patches(padded_j, kernel, stride)),
    )


@pytest.mark.parametrize("channels,kernel,stride", [(3, 16, 8), (3, 8, 4), (2, 6, 4)])
def test_global_embed_permutation_matches_interop(channels, kernel, stride):
    np.testing.assert_array_equal(tp.global_embed_permutation(channels, kernel, stride),
                                  jax_perm(channels, kernel, stride))


@pytest.mark.parametrize("bias", [False, True])
def test_state_dict_from_jax_matches_torch_interop(bias):
    """Key for key and value for value on the shared keys (the interop map
    also emits the unused nViT rmsnorm weights), then a strict load."""
    cfg = small_vit_cfg(bias=bias)
    params = random_jax_params(cfg, seed=int(bias))
    ours = state_dict_from_jax(params, port_config(cfg))
    ref = state_dict_from_params(params, cfg)
    unused = {k for k in ref if ".rmsnorm_" in k}
    assert set(ours) == set(ref) - unused
    for key, val in ours.items():
        assert val.dtype == torch.float32, key
        np.testing.assert_array_equal(val.numpy(), ref[key], err_msg=key)
    model = ViT(port_config(cfg), device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ours)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residual_backwards_match_jax_custom_vjps(dtype):
    """The analytic backwards against the JAX custom VJPs on the same inputs
    and cotangent; d_alpha sums over every row ([2, 5, 16] → [16])."""
    jdt, tdt, tol = DTYPES[dtype]
    h, u, g = rnd(3, 2, 5, 16), rnd(4, 2, 5, 16), rnd(12, 2, 5, 16)
    alpha = (rnd(5, 16) * 0.03).astype(np.float32)  # both signs: sign(α·c) matters
    skip = np.array([0.7], np.float32)
    ref = _jax_vjp(lambda a, b, c: jr.slerp_residual(a, b, c, 0.05, 1 / 32),
                   (both(h, dtype)[0], both(u, dtype)[0], jnp.asarray(alpha)), both(g, dtype)[0])
    ht, ut = (both(x, dtype)[1].requires_grad_() for x in (h, u))
    at = torch.from_numpy(alpha).requires_grad_()
    tr.slerp_residual(ht, ut, at, 0.05, 1 / 32).backward(both(g, dtype)[1])
    for got, want in zip((ht.grad, ut.grad, at.grad), ref):
        close(got, want, dtype)

    ref = _jax_vjp(jr.norm_skip, (both(u, dtype)[0], both(h, dtype)[0], jnp.asarray(skip)),
                   both(g, dtype)[0])
    ht, ut = (both(x, dtype)[1].requires_grad_() for x in (h, u))
    st = torch.from_numpy(skip).requires_grad_()
    tr.norm_skip(ut, ht, st).backward(both(g, dtype)[1])
    for got, want in zip((ut.grad, ht.grad), ref[:2]):
        close(got, want, dtype)
    # d_skip is one sum over all 160 elements: summation order, relative to its size
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(ref[2]), rtol=tol["rtol"], atol=1e-5)


def test_residual_backwards_pass_gradcheck():
    g = torch.Generator().manual_seed(0)
    h, u = (torch.randn(3, 4, 6, generator=g, dtype=torch.float64, requires_grad=True) for _ in range(2))
    alpha = (0.5 * torch.randn(6, generator=g, dtype=torch.float64)).requires_grad_()
    skip = torch.tensor([0.8], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b, c: tr.slerp_residual(a, b, c, 0.05, 1 / 8), (h, u, alpha))
    assert torch.autograd.gradcheck(tr.norm_skip, (u, h, skip))
