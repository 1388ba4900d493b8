"""The port's training data path against the JAX package, on the CPU (a
companion of tests/test_torch_train.py): ``make_synthetic`` arrays, epoch
order and batches equal to the JAX package's, ``preprocess``, and the
datasets, which read their files or name the missing layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvit_tpu.data.augment import normalize as jax_normalize
from nvit_tpu_torch.data.augment import normalize, preprocess

torch.set_num_threads(1)


# ------------------------------------------------------------------ data
def test_make_synthetic_is_the_jax_draw():
    """The chunked draw yields the JAX package's arrays from the same seed
    (32 px, one chunk boundary crossed with a small chunk)."""
    from nvit_tpu.data.datasets import make_synthetic as jax_make_synthetic
    from nvit_tpu_torch.data import datasets

    want = jax_make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3)
    got = datasets.make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    saved = datasets._NOISE_CHUNK
    datasets._NOISE_CHUNK = 3 * 32 * 32 * 7  # 7 images per chunk
    try:
        np.testing.assert_array_equal(
            datasets.make_synthetic(num_examples=300, image_size=32, num_classes=7, seed=3).images,
            want.images)
    finally:
        datasets._NOISE_CHUNK = saved


def test_epoch_order_and_batches_are_the_jax_pipeline():
    from nvit_tpu.data.datasets import ArrayDataset as JaxArrayDataset
    from nvit_tpu.data.pipeline import iterate_array as jax_iterate
    from nvit_tpu_torch.data.datasets import ArrayDataset
    from nvit_tpu_torch.data.pipeline import device_prefetch, iterate_array

    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (37, 3, 4, 4), dtype=np.uint8)
    labels = rng.integers(0, 5, 37).astype(np.int32)
    for kw in (dict(epoch=2, shuffle=True), dict(epoch=0, shuffle=False, drop_last=False),
               dict(epoch=1, shuffle=True, start_batch=2)):
        want = list(jax_iterate(JaxArrayDataset(imgs, labels, 5), batch_size=8, seed=4, **kw))
        got = list(iterate_array(ArrayDataset(imgs, labels, 5), batch_size=8, seed=4, **kw))
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    x, y = next(device_prefetch(iter(got[:1]), "cpu"))
    assert x.dtype == torch.uint8 and y.dtype == torch.int64


def test_preprocess_normalizes_and_autoaugment_raises():
    """AutoAugment is ported (tests/test_torch_autoaugment.py): a train
    batch with a generator is augmented, then normalized; without one, or
    with AutoAugment off, or for eval, preprocess is the JAX normalize."""
    from nvit_tpu_torch.data.autoaugment import auto_augment_batch, step_generator

    imgs = torch.from_numpy(np.random.default_rng(23).integers(0, 256, (8, 3, 8, 8), dtype=np.uint8))
    np.testing.assert_array_equal(preprocess(imgs, train=True, auto_augment=False).numpy(),
                                  np.asarray(jax_normalize(jnp.asarray(imgs.numpy()))))
    assert torch.equal(preprocess(imgs, train=False), normalize(imgs))
    key = np.array([0, 1], np.uint32)
    augmented = preprocess(imgs, step_generator(key, 3), train=True, auto_augment=True, dataset="cifar100")
    assert torch.equal(augmented, normalize(auto_augment_batch(imgs, step_generator(key, 3), dataset="cifar100")))
    assert not torch.equal(augmented, normalize(imgs))


@pytest.mark.parametrize("name", ["cifar10", "cifar100", "imagenet", "digits"])
def test_unported_datasets_raise(tmp_path, name):
    """Every dataset is ported (tests/test_torch_data.py): without their
    files the CIFAR and ImageNet readers raise ``FileNotFoundError`` naming
    the layout; digits, bundled with scikit-learn, equal the JAX package's."""
    from nvit_tpu.data.datasets import load_dataset as jax_load_dataset
    from nvit_tpu_torch.data.datasets import load_dataset

    if name == "digits":
        got, want = load_dataset(name, tmp_path, image_size=16), jax_load_dataset(name, tmp_path, image_size=16)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        return
    with pytest.raises(FileNotFoundError, match="imagenet" if name == "imagenet" else "data.download=true"):
        load_dataset(name, tmp_path)
