"""The port's norms, residuals, linear contract, normalize, losses and LR
schedule against the JAX package's (a companion of
tests/test_torch_core.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.core import layers as jl
from nvit_tpu.core import norms as jn
from nvit_tpu.core import residual as jr
from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu_torch.core import layers as tl
from nvit_tpu_torch.core import norms as tn
from nvit_tpu_torch.core import residual as tr
from nvit_tpu_torch.data.augment import normalize
from tests.torch_core_cases import both, close, rnd

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norms(dtype):
    xj, xt = both(rnd(0, 4, 6, 32), dtype)
    w = rnd(1, 32)
    b = rnd(2, 32)
    close(tn.justnorm(xt), jn.justnorm(xj), dtype)
    close(tn.rms_norm(xt, torch.from_numpy(w)), jn.rms_norm(xj, jnp.asarray(w)), dtype)
    close(tn.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b)),
          jn.layer_norm(xj, jnp.asarray(w), jnp.asarray(b)), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_residuals(dtype):
    hj, ht = both(rnd(3, 2, 5, 16), dtype)
    uj, ut = both(rnd(4, 2, 5, 16), dtype)
    alpha = np.abs(rnd(5, 16)) * 0.03
    close(tr.slerp_residual(ht, ut, torch.from_numpy(alpha), 0.05, 1 / 32),
          jr.slerp_residual(hj, uj, jnp.asarray(alpha), 0.05, 1 / 32), dtype)
    skip = np.array([0.7], np.float32)
    close(tr.norm_skip(ut, ht, torch.from_numpy(skip)), jr.norm_skip(uj, hj, jnp.asarray(skip)), dtype)


@pytest.mark.parametrize("compute", [None, "bf16"])
def test_linear_casting_contract(compute):
    x, w, b = rnd(6, 3, 7, 24), rnd(7, 24, 40), rnd(8, 40)  # JAX layout w [in, out]
    jdt = jnp.bfloat16 if compute else None
    tdt = torch.bfloat16 if compute else None
    ref = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), compute_dtype=jdt)
    out = tl.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                    compute_dtype=tdt)
    close(out, ref, "bf16" if compute else "fp32")


def test_concat_linears_is_the_out_axis_concat():
    parts = [(rnd(9 + i, 8, 5), rnd(20 + i, 8)) for i in range(3)]  # torch [out, in]
    w, b = tl.concat_linears([(torch.from_numpy(a), torch.from_numpy(c)) for a, c in parts])
    ref = jl.concat_linears([{"w": jnp.asarray(a.T), "b": jnp.asarray(c)} for a, c in parts])
    np.testing.assert_array_equal(w.numpy().T, np.asarray(ref["w"]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(ref["b"]))


def test_normalize():
    img = np.random.default_rng(10).integers(0, 256, (2, 3, 4, 4), dtype=np.uint8)
    np.testing.assert_array_equal(normalize(torch.from_numpy(img)).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(img))))


def test_losses_match_jax():
    from nvit_tpu.models import losses as jlosses
    from nvit_tpu_torch.models import losses as tlosses

    logits = rnd(13, 6, 9)
    labels = np.random.default_rng(14).integers(0, 9, 6).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(tlosses.cross_entropy(lt, yt).item(),
                               float(jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    np.testing.assert_allclose(tlosses.mse_loss(lt, lt * 0.5).item(),
                               float(jlosses.mse_loss(jnp.asarray(logits), jnp.asarray(logits) * 0.5)),
                               rtol=1e-6)
    for got, want in zip(tlosses.topk_accuracy(lt, yt), jlosses.topk_accuracy(jnp.asarray(logits), jnp.asarray(labels))):
        assert got.item() == pytest.approx(float(want))


@pytest.mark.parametrize("decay_lr", [True, False])
def test_cosine_lr_matches_jax(decay_lr):
    from nvit_tpu.configs.schema import OptimizerConfig as JaxOpt
    from nvit_tpu.models.schedules import cosine_lr as jax_cosine_lr
    from nvit_tpu_torch.configs import OptimizerConfig
    from nvit_tpu_torch.models.schedules import cosine_lr

    kw = dict(learning_rate=3e-3, min_lr=1e-4, warmup_iters=5, lr_decay_iters=20, decay_lr=decay_lr)
    steps = np.arange(0, 20 + 6)
    got = np.array([cosine_lr(OptimizerConfig(**kw), int(s)).item() for s in steps], np.float32)
    want = np.asarray(jax_cosine_lr(JaxOpt(**kw), jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
