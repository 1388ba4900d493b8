"""Card-only tests: the port's CUDA kernels against their plain twins.

Marked ``cuda`` and skipped where there is no CUDA device or no ``nvcc``.
This file imports no jax, so it also runs on a machine with the card but
without the JAX package's dependencies; ``tests/conftest.py`` imports jax,
so run it there without the conftest::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances are for bf16 outputs: the kernel and the twin round q̂, k̂, P and
O to bf16 at the same points, but sum in another order, and K1's online
softmax rounds P against the running rather than the final row max.
"""

import pytest
import torch

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    from nvit_tpu_torch.ops._build import find_nvcc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if find_nvcc() is None:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def attn_inputs(b, h, t, d, device, seed=0, qkv_view=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    if qkv_view:  # heads as strided views of one fused [B, T, 3C] projection
        qkv = torch.randn(b, t, 3 * h * d, generator=g).to(device, torch.bfloat16)
        q, k, v = (x.reshape(b, t, h, d).permute(0, 2, 1, 3) for x in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(b, h, t, d, generator=g).to(device, torch.bfloat16) for _ in range(3))
    sqk = (1.0 + 0.1 * torch.randn(h, d, generator=g)).to(device)
    return q, k, v, sqk


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view", [
    (1, 2, 64, 32, False),   # one exact tile
    (2, 3, 100, 32, False),  # ragged T, head dim 32
    (1, 2, 130, 64, True),   # ragged T, strided QKV views
    (2, 12, 784, 64, True),  # the flagship's T and head dim
])
def test_k1_matches_twin(cuda, b, h, t, d, view):
    from nvit_tpu_torch.ops.flash_attention import flash_attention_qknorm_ref, qknorm_attention_fwd

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t, qkv_view=view)
    scale = float(d) ** 0.5
    o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    o_ref, lse_ref = flash_attention_qknorm_ref(q, k, v, sqk, scale)
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o_ref.float(), **BF16_TOL)
    # lse is fp32 from fp32 scores of the same bf16 q̂/k̂: summation order only
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda):
    from nvit_tpu_torch.ops.flash_attention import qknorm_attention_fwd

    q, k, v, sqk = attn_inputs(1, 2, 16, 48, cuda)
    with pytest.raises(ValueError, match="head dim"):
        qknorm_attention_fwd(q, k, v, sqk, 1.0)
    q, k, v, sqk = attn_inputs(1, 2, 16, 32, cuda)
    with pytest.raises(ValueError, match="bf16"):
        qknorm_attention_fwd(q.float(), k.float(), v.float(), sqk, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,h", [
    (64, 128, 64),         # one exact tile
    (100, 128, 512),       # ragged rows
    (70, 48, 64),          # K % 32 == 16: a last K step of 16, zero-filled
    (784 + 17, 768, 768),  # ragged rows at the cross-attention proj width
    (2 * 784, 768, 3072),  # c_fc width
])
def test_k3_matches_twin(cuda, n, k, h):
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_fwd, gated_mlp_ref

    g = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, k, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(2 * h, k, generator=g) / k ** 0.5).to(cuda, torch.bfloat16)
    out = gated_mlp_fwd(x, w)
    ref = gated_mlp_ref(x, w)
    torch.cuda.synchronize()
    assert out.shape == (n, h) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(cuda):
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_fwd

    x = torch.zeros(8, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K % 16"):
        gated_mlp_fwd(x, torch.zeros(128, 40, device=cuda, dtype=torch.bfloat16))
    x = torch.zeros(8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="H % 64"):
        gated_mlp_fwd(x, torch.zeros(96, 64, device=cuda, dtype=torch.bfloat16))
