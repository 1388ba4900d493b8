"""Card-only tests: the port's CUDA kernels (K1–K10, the projection
prologues and the residual updates) against their plain twins, K2–K6,
K8–K10 and the residual backwards bit-deterministic,
the autograd Functions' gradients, one flagship-width Block's backward in
each mode, with and without a bias and the bounded softmax, and
``device_prefetch``'s side-stream upload against the host batches.

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
    (17, 80, 192),         # below one 128-row tile; K tail of 16 past a 64-step; a 64-wide column tail
    (784, 48, 192),        # batch 1's ragged 16 rows; K = 48, short of one 64-step; a column tail
    (4 * 784, 768, 3072),  # c_fc width at batch 4
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
    (17, 80, 192),         # below one 128-row tile; K tail of 16 past a 64-step; a 64-wide column tail
    (784, 48, 192),        # batch 1's ragged 16 rows; K = 48, short of one 64-step; a column tail
    (4 * 784, 768, 3072),  # c_fc width at batch 4
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
def test_k4_takes_a_misaligned_g(cuda):
    """A g whose data starts off a 16-byte boundary (a view into a larger
    buffer, as an upstream split can hand it) is copied, not refused."""
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_duv_ref

    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(100, 128, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(2 * 192, 128, generator=g) / 128 ** 0.5).to(cuda, torch.bfloat16)
    buf = torch.randn(100 * 192 + 1, generator=g).to(cuda, torch.bfloat16)
    gy = buf[1:].view(100, 192)
    assert gy.is_contiguous() and gy.data_ptr() % 16
    duv = gated_mlp_bwd_duv(x, w, gy)
    torch.testing.assert_close(duv.float(), gated_mlp_duv_ref(x, w, gy).float(), **BF16_TOL)


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
    (1, 2, 40, 64, True),    # below one tile: the ring holds one ragged tile
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


# ------------------------------------------------------- bias (K6), bounded (K5)
def mlp_bias_inputs(n, k, h, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, k, generator=g).to(device, torch.bfloat16)
    w = (torch.randn(2 * h, k, generator=g) / k ** 0.5).to(device, torch.bfloat16)
    b = (0.5 * torch.randn(2 * h, generator=g)).to(device, torch.bfloat16)
    gy = torch.randn(n, h, generator=g).to(device, torch.bfloat16)
    return x, w, b, gy


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,h", [
    (100, 128, 512),       # ragged rows
    (70, 48, 64),          # K % 32 == 16
    (784 + 17, 768, 768),  # ragged rows at the cross-attention proj width
    (2 * 784, 768, 3072),  # c_fc width
    (17, 80, 192),         # below one 128-row tile; K tail of 16 past a 64-step; a 64-wide column tail
    (784, 48, 192),        # batch 1's ragged 16 rows; K = 48, short of one 64-step; a column tail
    (4 * 784, 768, 3072),  # c_fc width at batch 4
])
def test_k6_matches_twins(cuda, n, k, h):
    """K6 forward and backward ([du | dv]) against gated_mlp_ref /
    gated_mlp_duv_ref with the bias; launches counted apart from K3/K4."""
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_duv_ref, gated_mlp_fwd, gated_mlp_ref

    x, w, b, gy = mlp_bias_inputs(n, k, h, cuda, seed=n + 2)
    before = (gated_mlp_fwd.launches, gated_mlp_fwd.launches_bias,
              gated_mlp_bwd_duv.launches, gated_mlp_bwd_duv.launches_bias)
    out, duv = gated_mlp_fwd(x, w, b), gated_mlp_bwd_duv(x, w, gy, b)
    after = (gated_mlp_fwd.launches, gated_mlp_fwd.launches_bias,
             gated_mlp_bwd_duv.launches, gated_mlp_bwd_duv.launches_bias)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(after, before)] == [0, 1, 0, 1]
    torch.testing.assert_close(out.float(), gated_mlp_ref(x, w, b).float(), **BF16_TOL)
    torch.testing.assert_close(duv.float(), gated_mlp_duv_ref(x, w, gy, b).float(), **BF16_TOL)
    with pytest.raises(ValueError, match="bias"):
        gated_mlp_fwd(x, w, b[:-8])


@pytest.mark.cuda
def test_k6_autograd_carries_bias_and_suv_gradients(cuda):
    """The suv fold with a bias (w·suv, b·suv in fp32, then bf16): a CUDA
    forward through K6 gives w, b and suv gradients (K6's backward and db)
    within 2e-2 relative L2 of autograd through the twins."""
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp, gated_mlp_ref

    g = torch.Generator().manual_seed(17)
    x = torch.randn(3, 100, 256, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(2 * 512, 256, generator=g) / 16).to(cuda)
    b = (0.1 * torch.randn(2 * 512, generator=g)).to(cuda)
    suv = (1 + 0.1 * torch.randn(2 * 512, generator=g)).to(cuda)
    gy = torch.randn(3, 100, 512, generator=g).to(cuda, torch.bfloat16)
    grads = []
    for fn in (gated_mlp, gated_mlp_ref):
        w_, b_, s_ = (t.clone().requires_grad_() for t in (w, b, suv))
        fn(x, (w_ * s_[:, None]).to(torch.bfloat16), (b_ * s_).to(torch.bfloat16)).backward(gy)
        grads.append((w_.grad, b_.grad, s_.grad))
    for a, r in zip(*grads):
        assert a is not None and rel_l2(a, r) <= 2e-2


# sqk_eff ≈ 1: bound 8·max(s²) ≈ 12, the clamp inert; ≈ 3: bound ≈ 110, the
# floor fires in whole rows (uniform attention, finite gradients)
K5_REGIMES = {"inert": 1.0, "clamp": 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", K5_REGIMES)
@pytest.mark.parametrize("b,h,t,d,view", [
    (2, 3, 100, 32, False),  # ragged T, head dim 32
    (4, 12, 784, 64, True),  # the flagship's T and head dim, strided QKV views
])
def test_k5_matches_twins(cuda, regime, b, h, t, d, view):
    """mode="bounded": K5's forward (o, lse) and backward (dq, dk, dv, dsqk)
    against the bounded twins; outputs finite in both regimes."""
    from nvit_tpu_torch.ops import flash_attention as fa

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t + 7, qkv_view=view)
    sqk = K5_REGIMES[regime] * sqk
    do = torch.randn(b, t, h, d, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    do = do.permute(0, 2, 1, 3)
    scale = float(d) ** 0.5
    before = (fa.qknorm_attention_fwd.launches, fa.qknorm_attention_fwd.launches_bounded,
              fa.qknorm_attention_bwd.launches, fa.qknorm_attention_bwd.launches_bounded)
    o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True, mode="bounded")
    got = fa.qknorm_attention_bwd(q, k, v, sqk, scale, o, lse, do, "bounded")
    after = (fa.qknorm_attention_fwd.launches, fa.qknorm_attention_fwd.launches_bounded,
             fa.qknorm_attention_bwd.launches, fa.qknorm_attention_bwd.launches_bounded)
    o_ref, lse_ref = fa.flash_attention_qknorm_ref(q, k, v, sqk, scale, "bounded")
    want = fa.qknorm_attention_bwd_ref(q, k, v, sqk, scale, o, lse, do, "bounded")
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(after, before)] == [0, 1, 0, 1]
    for x in (o, lse, *got):
        assert torch.isfinite(x).all()
    torch.testing.assert_close(o.float(), o_ref.float(), **BF16_TOL)
    torch.testing.assert_close(lse, lse_ref, rtol=1e-4, atol=1e-4)
    for a, r in zip(got[:3], want[:3]):
        torch.testing.assert_close(a.float(), r.float(), **BF16_TOL)
    assert (got[3] - want[3]).abs().max() <= 2e-2 * want[3].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["bounded", "rowmax"])
def test_auto_takes_the_arm_of_its_gate(cuda, side):
    """mode="auto" decides on the card: below the gate (sqk ≈ 1, bound ≈ 12)
    its output is bit-equal to the static bounded arm's, above it (sqk × 2)
    to the row-max arm's — and differs from the other arm's."""
    from nvit_tpu_torch.ops import flash_attention as fa

    q, k, v, sqk = attn_inputs(2, 12, 784, 64, cuda, seed=11, qkv_view=True)
    if side == "rowmax":
        sqk = 2 * sqk
    other = "rowmax" if side == "bounded" else "bounded"
    before = fa.qknorm_attention_fwd.launches_auto
    o, lse = fa.qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True, mode="auto")
    assert fa.qknorm_attention_fwd.launches_auto == before + 1
    o_arm, lse_arm = fa.qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True, mode=side)
    _, lse_other = fa.qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True, mode=other)
    torch.cuda.synchronize()
    assert fa.bounded_arm(sqk, 8.0, "auto") == (side == "bounded")
    assert torch.equal(o, o_arm) and torch.equal(lse, lse_arm)
    assert not torch.equal(lse, lse_other)


@pytest.mark.cuda
def test_long_sequence_nvit_attention_takes_k7_and_k9(cuda):
    """nViT attention at T = 1100 > FUSED_BWD_MAX_T, in every mode: the fp32
    projection, then K7 forward and K9 backward, never K1/K2/K5; gradients
    within 2e-2 relative L2 of autograd through the twins."""
    from nvit_tpu_torch.ops import flash_attention as fa

    q, k, v, sqk = attn_inputs(2, 4, 1100, 64, cuda, seed=13, qkv_view=True)
    do = torch.randn(2, 4, 1100, 64, generator=torch.Generator().manual_seed(14)).to(cuda, torch.bfloat16)
    qknorm = (fa.qknorm_attention_fwd, fa.qknorm_attention_bwd)

    def counts():
        return ([getattr(f, a) for f in qknorm for a in dir(f) if a.startswith("launches")],
                fa.flash_attention_fwd.launches, fa.attention_bwd_fused.launches,
                fa.attention_bwd_split.launches)

    for mode in ("rowmax", "bounded", "auto"):
        ours = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
        ref = [x.detach().clone().requires_grad_() for x in (q, k, v, sqk)]
        (qk0, k7, k8, k9) = counts()
        fa.flash_attention_qknorm(*ours, 8.0, mode=mode).backward(do)
        (qk1, k7b, k8b, k9b) = counts()
        assert qk1 == qk0 and (k7b - k7, k8b - k8, k9b - k9) == (1, 0, 1), mode
        s = ref[3].reshape(1, 4, 1, 64)
        fa.flash_attention_ref(fa._normed_scaled(ref[0], s).to(v.dtype),
                               fa._normed_scaled(ref[1], s).to(v.dtype), ref[2], 8.0)[0].backward(do)
        for a, r in zip(ours, ref):
            assert a.grad is not None and rel_l2(a.grad, r.grad) <= 2e-2, mode


def use_twins(monkeypatch):
    """Route the autograd Functions' CUDA launches to the plain twins, so a
    model runs on the card with the kernels' rounding points but no kernel."""
    from nvit_tpu_torch.ops import flash_attention as fa
    from nvit_tpu_torch.ops import gated_mlp as gm

    monkeypatch.setattr(fa, "qknorm_attention_fwd", lambda q, k, v, s, scale, *, with_lse=False, mode="rowmax":
                        fa.flash_attention_qknorm_ref(q, k, v, s, scale, mode))
    monkeypatch.setattr(fa, "qknorm_attention_bwd", fa.qknorm_attention_bwd_ref)
    monkeypatch.setattr(fa, "flash_attention_fwd", lambda q, k, v, scale, *, with_lse=False:
                        fa.flash_attention_ref(q, k, v, scale))
    monkeypatch.setattr(fa, "attention_bwd_fused", fa.attention_bwd_fused_ref)
    monkeypatch.setattr(gm, "gated_mlp_fwd", gm.gated_mlp_ref)
    monkeypatch.setattr(gm, "gated_mlp_bwd_duv", gm.gated_mlp_duv_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(bias=True), dict(bias=True, bounded_softmax="bounded"),
                                dict(bias=True, use_nvit=False)], ids=["bias", "bias-bounded", "baseline-bias"])
def test_flagship_block_with_bias_backward_matches_plain_path(cuda, monkeypatch, kw):
    """One ViT-B/16 Block (d = 768, 12 heads, T = 784) with bias=True, in
    bf16: the kernel path's (K6; K1/K2, K5 or K7/K8) input and parameter
    gradients, biases and suv included, against the plain path's and against
    the same path through the twins, on the same weights with random biases,
    within 5e-2 relative L2.

    Two gradients are sums over the 1568 tokens that cancel, and are held
    only where they mean something.  nViT's key bias, Σ_t dk_t: the TPU
    kernels' bf16 dS leaves it ~0.2 from its fp32 value in the JAX package's
    own kernel path (tests/test_torch_bias_bounded.py::
    test_flagship_block_bf16_gradients_match_jax_kernel_path; 0.17 from the
    plain path here), so it is held against the twins only, and to 0.1:
    kernel and twin round dS alike but sum in another order, which the
    cancellation amplifies (measured 0.062).  Baseline's key bias is 0 in
    exact arithmetic (softmax ignores a shift of every score in a row) and
    is not held."""
    import dataclasses

    from nvit_tpu_torch.models.blocks import Block
    from nvit_tpu_torch.models.presets import flagship_config

    cfg = flagship_config(**kw).model
    kernel = Block(cfg, device=cuda)
    kernel.init_weights(torch.Generator(device=cuda).manual_seed(0))
    with torch.no_grad():
        for name, p in kernel.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0.0, 0.02, generator=torch.Generator(device=cuda).manual_seed(len(name)))
    plain = Block(dataclasses.replace(cfg, flash_attn=False, gated_mlp_kernel="off"), device=cuda)
    twin = Block(cfg, device=cuda)
    for blk in (plain, twin):
        blk.load_state_dict(kernel.state_dict())
    h = torch.randn(2, cfg.n_patches, cfg.n_embd, generator=torch.Generator().manual_seed(1))
    h = torch.nn.functional.normalize(h, dim=-1).to(cuda, torch.bfloat16)
    dy = torch.randn(h.shape, generator=torch.Generator().manual_seed(2)).to(cuda, torch.bfloat16)
    hs = []
    for blk in (kernel, plain, twin):
        if blk is twin:
            use_twins(monkeypatch)
        hs.append(h.clone().requires_grad_())
        blk(hs[-1], compute_dtype=torch.bfloat16).backward(dy)
    assert rel_l2(hs[0].grad, hs[1].grad) <= 5e-2 and rel_l2(hs[0].grad, hs[2].grad) <= 5e-2
    for (name, p), q, r in zip(kernel.named_parameters(), plain.parameters(), twin.parameters()):
        if name == "skip_param":  # the ViT's outer norm_skip uses it, not Block.forward
            continue
        if name == "key.bias" and not cfg.use_nvit:
            continue
        assert p.grad is not None and rel_l2(p.grad, r.grad) <= (0.1 if name == "key.bias" else 5e-2), name
        if name != "key.bias":
            assert rel_l2(p.grad, q.grad) <= 5e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d,view,nsplit", [
    (1, 2, 64, 64, False, 1),    # one chunk, one key tile
    (2, 3, 112, 32, True, 7),    # seven 16-row sub-tiles, head dim 32
    (2, 3, 112, 64, True, 2),    # 48 + 64 rows: ragged chunks
    (1, 2, 784, 64, True, 2),    # the bench's T: 384 + 400 rows
    (1, 2, 784, 64, True, 7),    # 7 × 112 = 7 × (64 + 48)
    (1, 2, 1104, 32, True, 7),   # past 1024, 18 key tiles, head dim 32: 22 chunks
    (1, 2, 1104, 64, True, 2),   # 544 + 560 rows: 32- and 48-row chunks close them
])
def test_k10_matches_twin_and_is_deterministic(cuda, b, h, t, d, view, nsplit):
    """K10 against its twin; each call runs the projection prologue once
    and K10 once, and two calls give the same bytes."""
    from nvit_tpu_torch.ops.flash_attention import (
        qknorm_attention_bwd_subtiled,
        qknorm_attention_bwd_subtiled_ref,
        qknorm_attention_fwd,
        qknorm_project_bf16,
    )

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t + nsplit, qkv_view=view)
    do = torch.randn(b, t, h, d, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    do = do.permute(0, 2, 1, 3)
    o, lse = qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True)
    before = qknorm_attention_bwd_subtiled.launches, qknorm_project_bf16.launches
    got = qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, do, nsplit)
    again = qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, do, nsplit)
    want = qknorm_attention_bwd_subtiled_ref(q, k, v, sqk, 8.0, o, lse, do, nsplit)
    torch.cuda.synchronize()
    assert (qknorm_attention_bwd_subtiled.launches, qknorm_project_bf16.launches) == (before[0] + 2, before[1] + 2)
    for a, r in zip(got[:3], want[:3]):
        assert a.shape == q.shape and a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r.float(), **BF16_TOL)
        assert rel_l2(a, r) <= 1e-3  # the twin's bf16 rounding points, shared
    assert got[3].shape == (b, h, d)
    assert (got[3] - want[3]).abs().max() <= 2e-2 * want[3].abs().max()
    for a, r in zip(got, again):  # no atomics: the same bytes every call
        assert torch.equal(a.contiguous().view(torch.uint8), r.contiguous().view(torch.uint8))


@pytest.mark.cuda
def test_k10_rejects_what_it_does_not_take(cuda):
    from nvit_tpu_torch.ops.flash_attention import qknorm_attention_bwd_subtiled, qknorm_attention_fwd

    q, k, v, sqk = attn_inputs(1, 2, 64, 32, cuda)
    o, lse = qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True)
    with pytest.raises(ValueError, match="empty q sub-tile"):
        qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, o, 5)
    q, k, v, sqk = attn_inputs(1, 2, 100, 32, cuda)
    o, lse = qknorm_attention_fwd(q, k, v, sqk, 8.0, with_lse=True)
    with pytest.raises(ValueError, match="multiple of 16"):
        qknorm_attention_bwd_subtiled(q, k, v, sqk, 8.0, o, lse, o, 2)


def as_bytes(x):
    return x.contiguous().view(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rowmax", "bounded"])
@pytest.mark.parametrize("b,h,t,d", [(4, 12, 784, 64), (2, 4, 100, 32)])
def test_k2_and_k5_backward_are_deterministic(cuda, b, h, t, d, mode):
    """No atomics in K2 or K5's backward: two calls give the same bytes."""
    from nvit_tpu_torch.ops.flash_attention import qknorm_attention_bwd, qknorm_attention_fwd

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t + 3, qkv_view=True)
    do = torch.randn(b, t, h, d, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    do = do.permute(0, 2, 1, 3)
    o, lse = qknorm_attention_fwd(q, k, v, sqk, float(d) ** 0.5, with_lse=True, mode=mode)
    got, again = (qknorm_attention_bwd(q, k, v, sqk, float(d) ** 0.5, o, lse, do, mode) for _ in range(2))
    torch.cuda.synchronize()
    for a, r in zip(got, again):
        assert torch.equal(as_bytes(a), as_bytes(r))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d", [(4, 12, 784, 64), (2, 4, 100, 32)])
def test_projection_prologue_matches_twin(cuda, b, h, t, d):
    """The prologue against its twin, q/k as strided QKV views: q̂_s, k̂, k̂_s
    within one bf16 rounding (the fp32 norms sum in another order), the
    padded lse exact, Δ to fp32 order; its launches counted."""
    from nvit_tpu_torch.ops.flash_attention import (
        qknorm_attention_fwd,
        qknorm_project_bf16,
        qknorm_project_bf16_ref,
    )

    q, k, v, sqk = attn_inputs(b, h, t, d, cuda, seed=t + 4, qkv_view=True)
    do = torch.randn(b, h, t, d, generator=torch.Generator().manual_seed(t)).to(cuda, torch.bfloat16)
    scale = float(d) ** 0.5
    before = qknorm_project_bf16.launches
    o, lse = qknorm_attention_fwd(q, k, v, sqk, scale, with_lse=True)
    got = qknorm_project_bf16(q, k, sqk, scale, o=o, do=do, lse=lse)
    want = qknorm_project_bf16_ref(q, k, sqk, scale, o=o, do=do, lse=lse)
    torch.cuda.synchronize()
    assert qknorm_project_bf16.launches == before + 2
    for a, r in zip(got[:3], want[:3]):
        assert a.shape == (b * h, t, d) and a.dtype == torch.bfloat16
        assert bool(((a.float() - r.float()).abs() <= r.float().abs() * 2.0 ** -7).all())
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])  # K8, K9
@pytest.mark.parametrize("b,h,t,d", [(4, 12, 784, 64), (2, 4, 100, 32)])
def test_k8_and_k9_are_deterministic(cuda, b, h, t, d, split):
    """No atomics in K8 or K9: two calls give the same bytes."""
    from nvit_tpu_torch.ops.flash_attention import (
        attention_bwd_fused,
        attention_bwd_split,
        attention_delta,
        flash_attention_fwd,
    )

    q, k, v, do = base_bwd_inputs(b, h, t, d, cuda, True, seed=t + 5)
    scale = 1.0 / float(d) ** 0.5
    o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
    delta = attention_delta(o, do)
    call = ((lambda: attention_bwd_split(q, k, v, do, lse, delta, scale)) if split
            else (lambda: attention_bwd_fused(q, k, v, o, lse, do, scale)))
    got, again = call(), call()
    torch.cuda.synchronize()
    for a, r in zip(got, again):
        assert torch.equal(as_bytes(a), as_bytes(r))


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])  # K8's call, K9's
@pytest.mark.parametrize("b,h,t,d", [(4, 12, 784, 64), (2, 4, 100, 32)])
def test_flash_project_matches_twin(cuda, b, h, t, d, split):
    """The baseline backward's prologue against its twin, q/k as strided QKV
    views: qs (and K8's ks) bit-equal — both round the same fp32 product
    q·bf16(scale) once — lse exact, Δ to fp32 order (K8) or copied exactly
    (K9); its launches counted."""
    from nvit_tpu_torch.ops.flash_attention import (
        attention_delta,
        flash_attention_fwd,
        flash_project_bf16,
        flash_project_bf16_ref,
    )

    q, k, v, do = base_bwd_inputs(b, h, t, d, cuda, True, seed=t + 6)
    scale = 1.0 / float(d) ** 0.5
    o, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
    kw = dict(delta=attention_delta(o, do)) if split else dict(o=o, do=do)
    before = flash_project_bf16.launches
    got = flash_project_bf16(q, k, scale, lse=lse, **kw)
    want = flash_project_bf16_ref(q, k, scale, lse=lse, **kw)
    torch.cuda.synchronize()
    assert flash_project_bf16.launches == before + 1
    assert (got[1] is None) == split == (want[1] is None)
    for a, r in zip(got[:2], want[:2]):
        if r is not None:
            assert a.shape == (b * h, t, d) and a.dtype == torch.bfloat16
            assert torch.equal(as_bytes(a), as_bytes(r))
    assert torch.equal(got[2], want[2])
    if split:
        assert torch.equal(got[3], want[3])
    else:
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K4", "K6", "K6 backward"])
def test_gated_mlp_kernels_are_deterministic(cuda, kernel):
    """No split-K and no atomics in K3, K4 or K6: two calls give the same bytes."""
    from nvit_tpu_torch.ops.gated_mlp import gated_mlp_bwd_duv, gated_mlp_fwd

    x, w, b, gy = mlp_bias_inputs(2 * 784, 768, 3072, cuda, seed=31)
    b = b if kernel.startswith("K6") else None
    if kernel.endswith("backward") or kernel == "K4":
        got, again = (gated_mlp_bwd_duv(x, w, gy, b) for _ in range(2))
    else:
        got, again = (gated_mlp_fwd(x, w, b) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(as_bytes(got), as_bytes(again))


@pytest.mark.cuda
def test_checkpoint_resume_on_the_card_is_bit_equal(cuda, tmp_path):
    """A tiny nViT trained on the card (K1–K4 and the prologue in every
    step): four straight steps against two, a checkpoint, a resume and two
    more — every leaf of the final checkpoint bit-equal; the restored state
    equal to the one saved."""
    import numpy as np

    from nvit_tpu_torch import configs
    from nvit_tpu_torch.ckpt.checkpoint import restore_for_resume, state_leaves
    from nvit_tpu_torch.models.presets import preset
    from nvit_tpu_torch.train.trainer import Trainer

    model = preset("nvit-tiny4")
    model.update(n_layer=1, num_classes=10, image_size=16, flash_attn=True, gated_mlp_kernel="on")

    def config(out, **training):
        return configs.Config(
            model=configs.ViTConfig(**model),
            training=configs.TrainingConfig(batch_size=8, max_iters=4, eval_interval=2, log_interval=1,
                                            eval_iters=1, **training),
            optimizer=configs.OptimizerConfig(warmup_iters=0, lr_decay_iters=10),
            system=configs.SystemConfig(remat=False, quick_validation_size=8),
            data=configs.DataConfig(dataset="synthetic", out_dir=str(out), checkpoint_dir=str(out),
                                    augmentation=configs.AugmentationConfig(auto_augment=False)))

    def leaves(out):
        with np.load(out / "checkpoint_latest.npz") as z:
            return [z[f"leaf_{i}"] for i in range(len(z.files))]

    Trainer(config(tmp_path / "a"), device=cuda).train()
    Trainer(config(tmp_path / "b", max_iters_per_launch=2), device=cuda).train()
    resumed = Trainer(config(tmp_path / "b", init_from="resume"), device=cuda)
    assert resumed.iter_num == 2
    resumed.train()
    a, b = leaves(tmp_path / "a"), leaves(tmp_path / "b")
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    state, cfg, meta = restore_for_resume(tmp_path / "b", "checkpoint_latest", device=cuda)
    assert meta["iter_num"] == 4 and cfg.model == configs.ViTConfig(**model)
    assert next(state.model.parameters()).is_cuda
    assert all(np.array_equal(x, y) for x, y in zip(state_leaves(state), b))


@pytest.mark.cuda
def test_device_prefetch_side_stream_delivers_the_host_bytes(cuda):
    """device_prefetch uploads on a side stream while the consumer's stream
    is busy: each batch, read on the consumer's stream only after a ~10 ms
    sleep queued there and freed at once, must hold the host's bytes.  A
    missing event wait would let the read overtake the copy; a missing
    ``record_stream`` would let the allocator hand the freed batch's memory
    to the next upload before the delayed read ran."""
    import numpy as np

    from nvit_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 256, (64, 3, 64, 64), dtype=np.uint8), rng.integers(0, 100, 64).astype(np.int32))
            for _ in range(12)]
    got = []
    for imgs, labels in device_prefetch(iter(host), cuda, size=2):
        assert imgs.is_cuda and imgs.dtype == torch.uint8 and labels.dtype == torch.int64
        torch.cuda._sleep(20_000_000)  # the consumer's stream is busy before it reads the batch
        got.append((imgs.clone(), labels.clone()))
        del imgs, labels
    torch.cuda.synchronize()
    assert len(got) == len(host)
    for (gi, gl), (hi, hl) in zip(got, host):
        assert np.array_equal(gi.cpu().numpy(), hi) and np.array_equal(gl.cpu().numpy(), hl)


# ------------------------------------------------------------ residual updates
RESIDUAL_CASES = [  # (shape, h_new's and h_update's dtype, h's dtype)
    ((32, 784, 768), torch.bfloat16, torch.bfloat16),  # nViT-B/16's batch 32
    ((32, 784, 768), torch.float32, torch.float32),  # the baseline's outer skips
    ((32, 784, 768), torch.float32, torch.bfloat16),  # its first: an fp32 block output on bf16 patches
    ((3, 50, 64), torch.bfloat16, torch.bfloat16),  # a small width: one chunk a row, lanes past d idle
]
# kernel and twin round at the same points but sum the norms in another
# order: in fp32 that is the last bits (relative L2 ≤ 1e-7 measured); with a
# bf16 input it flips a few bf16 roundings by one ulp (25 and 128 of 19.3M
# outputs; relative L2 1.5e-5 forward, ≤ 2.2e-5 for every gradient)
RESIDUAL_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-6}


def residual_inputs(shape, dt_new, dt_h, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn(shape, generator=g).to(device, dt_h)
    new = (0.5 * torch.randn(shape, generator=g)).to(device, dt_new)
    gy = torch.randn(shape, generator=g).to(device, torch.promote_types(dt_new, dt_h))
    alpha = (0.05 * torch.randn(shape[-1], generator=g)).to(device)  # both signs: sign(α·c) in dα
    return h, new, gy, alpha, torch.tensor([0.83], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt_new,dt_h", RESIDUAL_CASES)
def test_residual_kernels_match_twins(cuda, shape, dt_new, dt_h):
    """The SLERP (one dtype) and norm_skip kernels through their autograd
    Functions against the plain chains on the same CUDA tensors: the output
    and every gradient, dα and d_skip included, in the inputs' dtypes."""
    from nvit_tpu_torch.core import residual as R
    from nvit_tpu_torch.ops import residual as kernels

    h, new, gy, alpha, skip = residual_inputs(shape, dt_new, dt_h, cuda, seed=shape[-1])
    tol = RESIDUAL_TOL[torch.bfloat16 if torch.bfloat16 in (dt_new, dt_h) else torch.float32]
    cases = [(R.norm_skip, R.norm_skip_ref, R.norm_skip_bwd_ref, (new, h, skip), (), kernels.norm_skip_fwd)]
    if dt_new == dt_h:
        cases.append((lambda *x: R.slerp_residual(*x, 0.05, 1 / 32), R.slerp_residual_ref,
                      R.slerp_residual_bwd_ref, (h, new, alpha), (32 * 0.05,), kernels.slerp_fwd))
    for fn, ref, ref_bwd, args, c, counted in cases:
        leaves = [x.clone().requires_grad_() for x in args]
        before = counted.launches
        out = fn(*leaves)
        out.backward(gy)
        want = ref(*args, *c)
        grads = ref_bwd(*args, *c, gy)
        torch.cuda.synchronize()
        assert counted.launches == before + 1
        assert out.dtype == want.dtype and rel_l2(out, want) <= tol
        if out.dtype == torch.bfloat16:  # one-ulp flips only
            assert (out != want).float().mean().item() <= 1e-4
        for leaf, r in zip(leaves, grads):
            assert leaf.grad.dtype == leaf.dtype and rel_l2(leaf.grad, r) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_kernels_are_deterministic(cuda, dtype):
    """No atomics: the per-block partials of dα and d_skip are summed in a
    fixed order, so two calls give the same bytes, forward and backward."""
    from nvit_tpu_torch.ops import residual as kernels

    h, new, gy, alpha, skip = residual_inputs((32, 784, 768), dtype, dtype, cuda, seed=9)
    for fwd, bwd in ((lambda: kernels.slerp_fwd(h, new, alpha, 1.6), lambda: kernels.slerp_bwd(h, new, alpha, 1.6, gy)),
                     (lambda: kernels.norm_skip_fwd(new, h, skip), lambda: kernels.norm_skip_bwd(new, h, skip, gy))):
        assert torch.equal(as_bytes(fwd()), as_bytes(fwd()))
        first, again = bwd(), bwd()
        torch.cuda.synchronize()
        assert all(torch.equal(as_bytes(a), as_bytes(b)) for a, b in zip(first, again))


@pytest.mark.cuda
def test_residual_updates_raise_on_float64_cuda_tensors(cuda):
    """CUDA tensors launch the kernels or raise: float64 is not taken, with
    grad (the Functions) or without (the registered operators)."""
    from nvit_tpu_torch.core import residual as R

    h, new, _, alpha, skip = residual_inputs((2, 5, 64), torch.float64, torch.float64, cuda, seed=1)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            leaf = h.clone().requires_grad_(grad)
            with pytest.raises(ValueError, match="bf16 or fp32"):
                R.slerp_residual(leaf, new, alpha, 0.05, 1 / 32)
            with pytest.raises(ValueError, match="bf16 or fp32"):
                R.norm_skip(new, leaf, skip)


@pytest.mark.cuda
@pytest.mark.parametrize("use_nvit", [True, False])
def test_residual_launches_per_flagship_step(cuda, use_nvit):
    """One training step of the flagship (batch 2) launches the SLERP kernels
    25 times each with nViT (2 a block, 1 for the cross-attention) and
    norm_skip's 12 times each in both modes; a forward without grad launches
    the forwards alone, through the registered operators."""
    import dataclasses

    from nvit_tpu_torch.models.presets import flagship_config
    from nvit_tpu_torch.ops import residual as kernels
    from nvit_tpu_torch.train.state import create_train_state
    from nvit_tpu_torch.train.step import make_train_step

    cfg = flagship_config(use_nvit=use_nvit)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(cfg.training, batch_size=2))
    state = create_train_state(cfg, seed=0, device=cuda)
    images = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(3)).to(cuda)
    labels = torch.tensor([1, 7], device=cuda)
    counted = (kernels.slerp_fwd, kernels.slerp_bwd, kernels.norm_skip_fwd, kernels.norm_skip_bwd)

    def launches(fn):
        before = [f.launches for f in counted]
        fn()
        torch.cuda.synchronize()
        return [f.launches - b for f, b in zip(counted, before)]

    slerp = 25 if use_nvit else 0
    assert launches(lambda: make_train_step(cfg)(state, images, labels)) == [slerp, slerp, 12, 12]
    with torch.no_grad():
        assert launches(lambda: state.model(images, compute_dtype=torch.bfloat16)) == [slerp, 0, 12, 0]
