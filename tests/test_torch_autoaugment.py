"""The port's AutoAugment against the JAX package's, on the CPU.

torch's generator cannot reproduce JAX's random bits, so the draw and the
application are held apart:

* every op at all 10 magnitude bins and both signs, on images of odd,
  non-square size (a flat one among them), against ``jax.vmap`` of
  ``nvit_tpu.data.autoaugment._apply_op`` in one jitted call;
* the whole batch transform on the decisions JAX's keys draw, against
  ``auto_augment_batch``;
* the policies and the magnitude table equal to the JAX package's;
* the draw: keyed by (run key, step), and its sub-policy, coin and sign
  frequencies near their probabilities over a large batch.

Tolerance, stated once: after rounding to uint8, the geometric ops and
posterize, solarize, autocontrast, equalize and invert are equal to JAX's;
brightness, color, contrast and sharpness sum in another order than XLA's
(grayscale, the mean, the smoothing kernel), so a value on a .5 boundary
may round the other way: at most 1 apart, on at most 0.1% of the values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.data import autoaugment as J
from nvit_tpu_torch.data import autoaugment as P
from nvit_tpu_torch.data.augment import normalize, preprocess

torch.set_num_threads(1)

H, W = 19, 23
PHOTOMETRIC_SUMS = {P.OP_BRIGHTNESS, P.OP_COLOR, P.OP_CONTRAST, P.OP_SHARPNESS}
MAX_SHARE = 1e-3


def make_images(n=4, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, 3, H, W), dtype=np.uint8)
    imgs[1] = (imgs[1] // 4 + 60).astype(np.uint8)  # low contrast
    imgs[2, :, :, :] = 90  # flat: autocontrast and equalize leave it
    imgs[3, 0] = np.arange(W, dtype=np.uint8)[None, :] * 11  # a ramp channel
    return imgs


def assert_rounded_close(got, want, ops):
    """Per op: uint8 after rounding, equal or within the stated tolerance."""
    g8 = np.clip(np.round(got), 0, 255).astype(np.int32)
    w8 = np.clip(np.round(want), 0, 255).astype(np.int32)
    for op in np.unique(ops):
        d = np.abs(g8[ops == op] - w8[ops == op])
        if op in PHOTOMETRIC_SUMS:
            assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE, (op, d.max(), (d > 0).mean())
        else:
            assert d.max() == 0, (op, d.max())


def test_every_op_at_every_bin_and_sign_matches_jax():
    imgs = make_images()
    table = P.magnitude_table(W)
    ops, mags, which = [], [], []
    for op in range(P.NUM_OPS):
        for b in range(10):
            for sign in (1.0, -1.0):
                for i in range(len(imgs)):
                    ops.append(op)
                    mags.append(sign * table[op, b] if op in P._SIGNED else table[op, b])
                    which.append(i)
    ops, mags = np.array(ops), np.array(mags, np.float32)
    x = imgs[np.array(which)].astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(J._apply_op))(jnp.asarray(x), jnp.asarray(ops, jnp.int32),
                                                     jnp.asarray(mags)))
    got = P.apply_ops(torch.from_numpy(x), ops, mags).numpy()
    assert got.dtype == np.float32 and got.shape == x.shape
    assert_rounded_close(got, want, ops)
    # the ops really act: every op but identity changes some image at some bin
    for op in range(1, P.NUM_OPS):
        assert not np.array_equal(got[ops == op], x[ops == op]), op


def test_policies_and_magnitude_table_equal_the_jax_package():
    for name in ("cifar10", "cifar100", "imagenet", "synthetic", "digits"):
        for got, want in zip(P.policy_arrays(P._POLICIES[name]), J._policy_arrays(J._POLICIES[name])):
            np.testing.assert_array_equal(got, want)
    assert P._POLICIES["cifar100"] is P.CIFAR10_POLICY and P._POLICIES["digits"] is P.CIFAR10_POLICY
    grid = np.meshgrid(np.arange(15), np.arange(10), indexing="ij")
    for size in (16, 23, 32, 224):
        want = np.asarray(jax.jit(lambda o, b: J._magnitude(o, b, size))(*grid))  # noqa: B023
        np.testing.assert_array_equal(P.magnitude_table(size), want)


def jax_decisions(key, batch):
    """The draws of JAX's ``_augment_one`` for each image of a batch."""
    def one(k):
        k_pol, k_coin, k_sign = jax.random.split(k, 3)
        return (jax.random.randint(k_pol, (), 0, 25), jax.random.uniform(k_coin, (2,)),
                jnp.where(jax.random.bernoulli(k_sign, 0.5, (2,)), 1.0, -1.0))

    pol, coins, signs = jax.vmap(one)(jax.random.split(key, batch))
    return P.Decisions(np.asarray(pol), np.asarray(coins), np.asarray(signs, np.float32))


@pytest.mark.parametrize("dataset", ["cifar100", "imagenet"])
def test_batch_on_jax_decisions_matches_auto_augment_batch(dataset):
    imgs = np.concatenate([make_images(seed=s) for s in range(8)])  # 32 images
    key = jax.random.PRNGKey(11)
    want = np.asarray(J.auto_augment_batch(jnp.asarray(imgs), key, dataset=dataset))
    op, mag = P.plan(jax_decisions(key, len(imgs)), dataset, W)
    got = P.apply_plan(torch.from_numpy(imgs), op, mag).numpy()
    assert got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want)
    assert d.max() <= 1 and (d > 0).mean() <= MAX_SHARE
    assert (op != P.OP_IDENTITY).any(axis=1).mean() > 0.5  # most images augmented
    assert not np.array_equal(got, imgs)


def test_draw_is_keyed_by_the_run_key_and_the_step():
    imgs = torch.from_numpy(np.concatenate([make_images(seed=s) for s in range(4)]))
    key = np.array([0, 42], np.uint32)

    def run(rng, step):
        return P.auto_augment_batch(imgs, P.step_generator(rng, step), dataset="cifar10")

    assert torch.equal(run(key, 5), run(key, 5))
    assert not torch.equal(run(key, 5), run(key, 6))
    assert not torch.equal(run(key, 5), run(np.array([1, 42], np.uint32), 5))
    assert P.step_seed(key, 5) != P.step_seed(key, 6) and 0 <= P.step_seed(key, 5) < 2**64
    # preprocess: AutoAugment then normalize for training; normalize alone otherwise
    g = P.step_generator(key, 5)
    torch.testing.assert_close(preprocess(imgs, g, train=True, dataset="cifar10"), normalize(run(key, 5)),
                               rtol=0, atol=0)
    assert torch.equal(preprocess(imgs, P.step_generator(key, 5), train=False), normalize(imgs))
    assert torch.equal(preprocess(imgs, None, train=True), normalize(imgs))


def test_draw_frequencies_match_the_policy():
    """Over 40,000 images: each sub-policy near 1/25, each stage applied at
    its probability, signs near ½ — each within 5 standard deviations."""
    n = 40_000
    dec = P.draw(n, torch.Generator().manual_seed(3))
    counts = np.bincount(dec.policy, minlength=25)
    p = 1 / 25
    assert np.all(np.abs(counts - n * p) <= 5 * np.sqrt(n * p * (1 - p)))
    _, probs, _ = P.policy_arrays(P.CIFAR10_POLICY)
    op, _ = P.plan(dec, "cifar10", 32)
    ops, _, _ = P.policy_arrays(P.CIFAR10_POLICY)
    for stage in range(2):
        prob = probs[dec.policy, stage]
        applied = op[:, stage] == ops[dec.policy, stage]
        expected = prob.sum()
        assert abs(applied.sum() - expected) <= 5 * np.sqrt((prob * (1 - prob)).sum())
        assert abs((dec.signs[:, stage] > 0).mean() - 0.5) <= 5 * np.sqrt(0.25 / n)
    assert set(np.unique(dec.signs)) == {-1.0, 1.0}
    assert dec.coins.min() >= 0 and dec.coins.max() < 1
