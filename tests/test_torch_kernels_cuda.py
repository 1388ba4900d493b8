"""Card-only tests: the port's CUDA kernels (K1–K4, K7–K9) against their plain
twins, the autograd Functions' gradients, and one flagship-width Block's
backward in each mode.

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


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view", [
    (1, 2, 64, 64, False),   # one exact tile
    (2, 3, 100, 32, True),   # ragged T, head dim 32, strided QKV views
    (2, 4, 130, 64, True),   # ragged T, head dim 64
    (4, 12, 784, 64, True),  # the smoke test's flagship shape
])
def test_k2_matches_twin(cuda, b, h, t, d, view):
    from nvit_tpu_torch.ops.flash_attention import (
        qknorm_attention_bwd,
        qknorm_attention_bwd_ref,
        qknorm_attention_fwd,
    )

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t + 1, qkv_view=view)
    do = torch.randn(b, t, h, d, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    do = do.permute(0, 2, 1, 3)  # the [B, H, T, D] view merge_heads' gradient arrives as
    scale = float(d) ** 0.5
    o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    got = qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do)
    want = qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do)
    torch.cuda.synchronize()
    for a, r in zip(got[:3], want[:3]):
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r.float(), **BF16_TOL)
    # fp32 dsqk: T·D products per (b, h), summed in another order
    assert got[3].shape == (b, h, d)
    assert (got[3] - want[3]).abs().max() <= 2e-2 * want[3].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,h", [
    (64, 128, 64),         # one exact tile
    (100, 128, 512),       # ragged rows
    (70, 48, 64),          # K % 32 == 16
    (784 + 17, 768, 768),  # ragged rows at the cross-attention proj width
    (2 * 784, 768, 3072),  # c_fc width
])
def test_k4_matches_twin(cuda, n, k, h):
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_duv_ref

    g = torch.Generator(device="cpu").manual_seed(n + 1)
    x = torch.randn(n, k, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(2 * h, k, generator=g) / k ** 0.5).to(cuda, torch.bfloat16)
    gy = torch.randn(n, h, generator=g).to(cuda, torch.bfloat16)
    duv = gated_mlp_bwd_duv(x, w, gy)
    ref = gated_mlp_duv_ref(x, w, gy)
    torch.cuda.synchronize()
    assert duv.shape == (n, 2 * h) and duv.dtype == torch.bfloat16
    torch.testing.assert_close(duv.float(), ref.float(), **BF16_TOL)


@pytest.mark.cuda
def test_cuda_forward_carries_gradients(cuda):
    """A CUDA forward through the kernels (K1/K3) yields gradients (K2/K4)
    for q, k, v, sqk, the c_fc weight and suv that match the plain twins'
    under autograd on the same tensors, to 2e-2 relative L2 (bf16)."""
    from nvit_tpu_torch.ops.flash_attention import flash_attention_qknorm, flash_attention_qknorm_ref
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp, gated_mlp_ref

    q, k, v, sqk = attn_inputs(2, 4, 130, 64, cuda, seed=5, qkv_view=True)
    do = torch.randn(2, 4, 130, 64, generator=torch.Generator().manual_seed(6)).to(cuda, torch.bfloat16)
    ours = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
    flash_attention_qknorm(*ours, 8.0).backward(do)
    flash_attention_qknorm_ref(*ref, 8.0)[0].backward(do)
    for a, r in zip(ours, ref):
        assert a.grad is not None
        assert rel_l2(a.grad, r.grad) <= 2e-2

    g = torch.Generator().manual_seed(7)
    x = torch.randn(3, 100, 256, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(2 * 512, 256, generator=g) / 16).to(cuda)
    suv = (1 + 0.1 * torch.randn(2 * 512, generator=g)).to(cuda)
    gy = torch.randn(3, 100, 512, generator=g).to(cuda, torch.bfloat16)
    grads = []
    for fn in (gated_mlp, lambda x_, w_: gated_mlp_ref(x_, w_)):
        w_, s_ = w.clone().requires_grad_(), suv.clone().requires_grad_()
        fn(x, (w_ * s_[:, None]).to(torch.bfloat16)).backward(gy)  # the suv weight fold
        grads.append((w_.grad, s_.grad))
    for a, r in zip(*grads):
        assert a is not None and rel_l2(a, r) <= 2e-2


@pytest.mark.cuda
def test_flagship_block_backward_matches_plain_path(cuda):
    """One nViT-B/16 Block (d = 768, 12 heads, T = 784) in bf16: the kernel
    path's input and parameter gradients against the plain path's
    (flash_attn=False, gated MLP off) on the same weights, within 5e-2
    relative L2 — the bound chip_smoke.py holds the whole model to."""
    import dataclasses

    from nvit_tpu_torch.configs import ViTConfig
    from nvit_tpu_torch.models.blocks import Block
    from nvit_tpu_torch.models.presets import preset

    cfg = ViTConfig(**preset("nvit-b16"), num_classes=1000)
    kernel = Block(cfg, device=cuda)
    kernel.init_weights(torch.Generator(device=cuda).manual_seed(0))
    plain = Block(dataclasses.replace(cfg, flash_attn=False, gated_mlp_kernel="off"), device=cuda)
    plain.load_state_dict(kernel.state_dict())
    blocks = (kernel, plain)
    h = torch.randn(2, cfg.n_patches, cfg.n_embd, generator=torch.Generator().manual_seed(1))
    h = torch.nn.functional.normalize(h, dim=-1).to(cuda, torch.bfloat16)
    dy = torch.randn(h.shape, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    hs = []
    for blk in blocks:
        hs.append(h.clone().requires_grad_())
        blk(hs[-1], compute_dtype=torch.bfloat16).backward(dy)
    assert rel_l2(hs[0].grad, hs[1].grad) <= 5e-2
    for (name, p), q in zip(blocks[0].named_parameters(), blocks[1].parameters()):
        if name == "skip_param":  # the ViT's outer norm_skip uses it, not Block.forward
            assert p.grad is None and q.grad is None
            continue
        assert p.grad is not None and rel_l2(p.grad, q.grad) <= 5e-2, name


# ------------------------------------------------------------ baseline mode
BASE_SHAPES = [
    (1, 2, 64, 32, False),   # one exact tile
    (2, 3, 100, 32, False),  # ragged T, head dim 32 (scale 1/sqrt(32) is not bf16-exact)
    (1, 2, 130, 64, True),   # ragged T, strided QKV views
    (4, 12, 784, 64, True),  # the flagship's T and head dim
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view", BASE_SHAPES)
def test_k7_matches_twin(cuda, b, h, t, d, view):
    from nvit_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref

    q, k, v, _ = attn_inputs(b, h, t, d, cuda, seed=t + 2, qkv_view=view)
    scale = 1.0 / float(d) ** 0.5
    o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
    o_ref, lse_ref = flash_attention_ref(q, k, v, scale)
    torch.cuda.synchronize()
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), o_ref.float(), **BF16_TOL)
    # fp32 scores of the same bf16 operands: summation order only
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k7_rejects_what_it_does_not_take(cuda):
    from nvit_tpu_torch.ops.flash_attention import flash_attention_fwd

    q, k, v, _ = attn_inputs(1, 2, 16, 48, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, k, v, 1.0)
    q, k, v, _ = attn_inputs(1, 2, 16, 32, cuda)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention_fwd(q.float(), k.float(), v.float(), 1.0)


def base_bwd_inputs(b, h, t, d, device, view, seed):
    q, k, v, _ = attn_inputs(b, h, t, d, device, seed=seed, qkv_view=view)
    do = torch.randn(b, t, h, d, generator=torch.Generator().manual_seed(seed + 1))
    return q, k, v, do.to(device, torch.bfloat16).permute(0, 2, 1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view", BASE_SHAPES)
def test_k8_matches_twin(cuda, b, h, t, d, view):
    from nvit_tpu_torch.ops.flash_attention import (
        attention_bwd_fused,
        attention_bwd_fused_ref,
        flash_attention_fwd,
    )

    q, k, v, do = base_bwd_inputs(b, h, t, d, cuda, view, seed=t + 3)
    scale = 1.0 / float(d) ** 0.5
    o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
    got = attention_bwd_fused(q, k, v, o, lse, do, scale)
    want = attention_bwd_fused_ref(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r.float(), **BF16_TOL)
    # dq, dk, dv are adjacent views of one [B, T, 3, H, D] buffer
    assert got[1].data_ptr() - got[0].data_ptr() == h * d * 2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view", [
    (2, 3, 100, 32, False),   # the split passes at a small ragged T
    (1, 4, 1100, 32, True),   # past FUSED_BWD_MAX_T, head dim 32, ragged
    (2, 12, 1100, 64, True),  # past FUSED_BWD_MAX_T at the flagship's heads
])
def test_k9_matches_twins(cuda, b, h, t, d, view):
    from nvit_tpu_torch.ops.flash_attention import (
        attention_bwd_split,
        attention_delta,
        attention_dkv_ref,
        attention_dq_ref,
        flash_attention_fwd,
    )

    q, k, v, do = base_bwd_inputs(b, h, t, d, cuda, view, seed=t + 4)
    scale = 1.0 / float(d) ** 0.5
    o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
    delta = attention_delta(o, do)
    got = attention_bwd_split(q, k, v, do, lse, delta, scale)
    want = (attention_dq_ref(q, k, v, do, lse, delta, scale),
            *attention_dkv_ref(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [130, 1100])  # K8, then K9 past FUSED_BWD_MAX_T
def test_flash_attn_fn_gradients_on_cuda(cuda, t):
    """A CUDA forward through K7 yields gradients (K8 or K9) that match
    autograd through the twins on the same tensors, to 2e-2 relative L2."""
    from nvit_tpu_torch.ops.flash_attention import (
        attention_bwd_fused,
        attention_bwd_split,
        flash_attention,
        flash_attention_ref,
    )

    q, k, v, do = base_bwd_inputs(2, 4, t, 64, cuda, True, seed=9)
    ours = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    fused, split = attention_bwd_fused.launches, attention_bwd_split.launches
    flash_attention(*ours, 0.125).backward(do)
    assert (attention_bwd_fused.launches - fused, attention_bwd_split.launches - split) == (
        (1, 0) if t <= 1024 else (0, 1))
    flash_attention_ref(*ref, 0.125)[0].backward(do)
    for a, r in zip(ours, ref):
        assert a.grad is not None and rel_l2(a.grad, r.grad) <= 2e-2


@pytest.mark.cuda
def test_flagship_baseline_block_backward_matches_plain_path(cuda):
    """One baseline ViT-B/16 Block (use_nvit=False; d = 768, 12 heads,
    T = 784) in bf16: the kernel path's (K7/K8, K3/K4) input and parameter
    gradients against the plain path's on the same weights, within 5e-2
    relative L2 — the bound chip_smoke.py holds the whole model to."""
    import dataclasses

    from nvit_tpu_torch.models.blocks import Block
    from nvit_tpu_torch.models.presets import flagship_config

    cfg = flagship_config(use_nvit=False).model
    kernel = Block(cfg, device=cuda)
    kernel.init_weights(torch.Generator(device=cuda).manual_seed(0))
    plain = Block(dataclasses.replace(cfg, flash_attn=False, gated_mlp_kernel="off"), device=cuda)
    plain.load_state_dict(kernel.state_dict())
    blocks = (kernel, plain)
    h = torch.randn(2, cfg.n_patches, cfg.n_embd, generator=torch.Generator().manual_seed(1))
    h = h.to(cuda, torch.bfloat16)
    dy = torch.randn(h.shape, generator=torch.Generator().manual_seed(2)).to(cuda)
    hs = []
    for blk in blocks:
        hs.append(h.clone().requires_grad_())
        blk(hs[-1], compute_dtype=torch.bfloat16).backward(dy)
    assert rel_l2(hs[0].grad, hs[1].grad) <= 5e-2
    for (name, p), q in zip(blocks[0].named_parameters(), blocks[1].parameters()):
        if name == "skip_param":  # the ViT's outer norm_skip uses it, not Block.forward
            assert p.grad is None and q.grad is None
            continue
        assert p.grad is not None and rel_l2(p.grad, q.grad) <= 5e-2, name
