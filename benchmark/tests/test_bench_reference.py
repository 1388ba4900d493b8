"""The plain reference against the program's CPU path at nViT-tiny size
(float32 on both sides), and the lower-precision control against the
limits."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.traffic import train
from benchmark.reference import check
from benchmark.reference import model as ref
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import generator, make_images, make_weights

SEED = 2**35 + 11


@pytest.mark.parametrize("name", ["nvit-b16.train", "vit-b16.train"])
def test_logits_match_the_program(name):
    from nvit_tpu_torch.models.vit import ViT
    from benchmark.spec import port_config

    cell = tiny_cell(name)
    m = cell.model
    sd = make_weights(m, SEED, "cpu")
    model = ViT(port_config(cell.config).model, device="cpu")
    model.load_state_dict(sd)
    images = make_images(6, m["image_size"], m["channels"], generator("cpu", SEED, "t"), "cpu")
    with torch.no_grad():
        want = model(ref.pixels(images))
        got = ref.logits(m, sd, images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["nvit-b16.train", "vit-b16.train"])
def test_training_steps_match_the_program(name):
    """Three steps of the program's step (float32) against the reference's:
    the losses, the first gradient by leaf, each leaf's change."""
    cell = tiny_cell(name, fp32=True)
    prog = train.Program(cell, SEED, torch.device("cpu"))
    got = prog.check_steps()
    want = train.reference(cell, SEED, "cpu", 1)
    numbers = check.train_numbers(got, want)
    assert numbers["loss_gap"] < 1e-5 and numbers["recon_gap"] < 1e-5, numbers
    assert numbers["grad_gap"] < 1e-4 and numbers["change_gap"] < 1e-4, numbers


@pytest.mark.parametrize("name", ["nvit-b16.train", "vit-b16.train"])
def test_the_fp8_control_is_not_correct(name):
    """The reference in fp8 in the program's place fails the cell's limits."""
    cell = tiny_cell(name)
    fp8 = train.reference(cell, SEED, "cpu", 1, quant=ref.fp8_quant)
    want = train.reference(cell, SEED, "cpu", 1)
    ok, checks = check.judge(check.train_numbers(fp8, want), cell.workload["limits"])
    assert not ok, checks


def test_the_fp8_control_quantises_the_backward_too():
    """Each product's backward takes fp8 operands: the incoming gradient
    and the saved inputs."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, generator=g, requires_grad=True)
    w = torch.randn(6, 8, generator=g, requires_grad=True)
    dy = torch.randn(4, 6, generator=g)
    ref._linear(x, w, None, ref.fp8_quant).backward(dy)
    q = ref.fp8_quant
    torch.testing.assert_close(x.grad, q(dy) @ q(w.detach()))
    torch.testing.assert_close(w.grad, q(dy).t() @ q(x.detach()))
    assert not torch.allclose(x.grad, dy @ q(w.detach()))


def test_fp8_quant_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, 0.3])
    q = ref.fp8_quant(x)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] == 1.0  # 1 + 1/16 is below e4m3's step of 1/8
    assert abs(q[3] - 0.3) / 0.3 < 1 / 16


def test_the_int8_control_is_not_correct():
    """Serving's control, the program's own int8 path, fails the cell's
    limit where the bf16 path passes.  The cell's widths (d = 768, 12
    heads), at 4 layers and 64 px so that the CPU holds it: at nViT-tiny
    widths int8's error stays under the limit."""
    import time

    from benchmark.traffic import serve
    from benchmark.spec import load_cell

    cell = load_cell("nvit-b16.serve")
    cell = dataclasses.replace(
        cell, config=dict(cell.config, model=dict(cell.model, image_size=64, n_layer=4)),
        workload=dict(cell.workload, rate_per_s=40.0, pool_images=32, check_sample=32, clients=16, max_batch=8))
    for quantize, want in ((None, True), ("int8", False)):
        run, labels, probs, ref_logp = serve.open_loop(cell, 2**34 + 9, 1.0, False, torch.device("cpu"),
                                                       time.time(), quantize=quantize)
        numbers = check.serve_numbers(labels, probs, ref_logp, run.counters["failed"])
        ok, checks = check.judge(numbers, cell.workload["limits"])
        assert ok is want, (quantize, checks)
