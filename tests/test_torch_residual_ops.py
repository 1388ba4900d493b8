"""The residual updates' registered operators (``torch.ops.nvit.slerp_residual``,
``torch.ops.nvit.norm_skip``), their fake implementations, their record in
a ``torch.export`` program, and the kernel wrappers' refusals, on the CPU
(the kernels themselves: tests/test_torch_kernels_cuda.py)."""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from nvit_tpu_torch.core import residual as tr
from nvit_tpu_torch.ops import residual as kernels

torch.set_num_threads(1)

C = 0.05 * 32  # ATTN_ALPHA_INIT_VALUE / base_scale at d = 1024


def inputs(dtype, seed=0, shape=(2, 5, 32)):
    g = torch.Generator().manual_seed(seed)
    h, u = (torch.randn(shape, generator=g).to(dtype) for _ in range(2))
    alpha = 0.03 * torch.randn(shape[-1], generator=g)  # signs of both kinds: sign(α·c) in dα
    return h, u, alpha, torch.tensor([0.7])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_equal_the_twins_and_the_functions(dtype):
    """No grad: the operators, as the dispatch calls them, give the twins'
    bits; with grad the Functions' forwards give the same bits."""
    h, u, alpha, skip = inputs(dtype)
    slerp = tr.slerp_residual_ref(h, u, alpha, C)
    skipped = tr.norm_skip_ref(u, h, skip)
    assert slerp.dtype == dtype == skipped.dtype
    with torch.no_grad():
        assert torch.equal(torch.ops.nvit.slerp_residual(h, u, alpha, C), slerp)
        assert torch.equal(tr.slerp_residual(h, u, alpha, 0.05, 1 / 32), slerp)
        assert torch.equal(torch.ops.nvit.norm_skip(u, h, skip), skipped)
        assert torch.equal(tr.norm_skip(u, h, skip), skipped)
    leaf = alpha.clone().requires_grad_()
    assert torch.equal(tr.slerp_residual(h, u, leaf, 0.05, 1 / 32).detach(), slerp)
    leaf = skip.clone().requires_grad_()
    assert torch.equal(tr.norm_skip(u, h, leaf).detach(), skipped)


def test_mixed_dtype_norm_skip_promotes():
    """The baseline's first outer skip adds an fp32 block output to bf16
    patches: fp32 out, each gradient in its input's dtype."""
    h, u, _, skip = inputs(torch.bfloat16, seed=1)
    u = u.float().requires_grad_()
    h = h.clone().requires_grad_()
    skip = skip.clone().requires_grad_()
    out = tr.norm_skip(u, h, skip)
    assert out.dtype == torch.float32
    out.backward(torch.ones_like(out))
    assert (u.grad.dtype, h.grad.dtype, skip.grad.dtype) == (torch.float32, torch.bfloat16, torch.float32)
    want = tr.norm_skip_bwd_ref(u.detach(), h.detach(), skip.detach(), torch.ones_like(out))
    for got, ref in zip((u.grad, h.grad, skip.grad), want):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("hn_dtype,h_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                                              (torch.float32, torch.float32)])
def test_fake_implementations_give_shape_and_dtype(hn_dtype, h_dtype):
    with FakeTensorMode():
        h = torch.empty(3, 7, 64, dtype=h_dtype)
        hn = torch.empty(3, 7, 64, dtype=hn_dtype)
        alpha, skip = torch.empty(64), torch.empty(1)
        out = torch.ops.nvit.norm_skip(hn, h, skip)
        slerp = torch.ops.nvit.slerp_residual(h, h, alpha, C)
    assert out.shape == (3, 7, 64) and out.dtype == torch.promote_types(hn_dtype, h_dtype)
    assert slerp.shape == (3, 7, 64) and slerp.dtype == h_dtype


def test_export_of_a_block_records_both_operators():
    """A small nViT block and the outer skip after it, exported without
    grad: the program calls both operators and runs as the eager model."""
    from nvit_tpu_torch.models.blocks import Block
    from nvit_tpu_torch.models.presets import flagship_config

    cfg = flagship_config(image_size=16, n_layer=1, n_head=2, n_embd=32, num_classes=10, local_patch_size=4,
                          global_patch_size=8).model
    blk = Block(cfg, device="cpu")
    blk.init_weights(torch.Generator().manual_seed(0))

    class Skipped(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blk = blk

        def forward(self, h):
            return tr.norm_skip(self.blk(h, compute_dtype=torch.bfloat16), h, self.blk.skip_param)

    h = torch.nn.functional.normalize(torch.randn(2, cfg.n_patches, 32), dim=-1).to(torch.bfloat16)
    with torch.no_grad():
        program = torch.export.export(Skipped().eval(), (h,))
        want = Skipped()(h)
    ops = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert ops.count("nvit.slerp_residual.default") == 2 and ops.count("nvit.norm_skip.default") == 1
    with torch.no_grad():
        assert torch.equal(program.module()(h), want)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Every refusal comes before the library is built, so it shows here."""
    h, u, alpha, skip = inputs(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.slerp_fwd(h, u, alpha, C)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.norm_skip_fwd(torch.empty(2, 12), torch.empty(2, 12), skip)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.slerp_bwd(torch.empty(2, 2048), torch.empty(2, 2048), torch.empty(2048), C, torch.empty(2, 2048))
