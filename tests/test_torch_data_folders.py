"""The port's ImageNet folders, decoders, digits and native loader against the
JAX package's (a companion of tests/test_torch_data.py)."""

import threading
import time

import numpy as np
import pytest
import torch

from nvit_tpu.data import datasets as jax_datasets
from nvit_tpu.data import pipeline as jax_pipeline
from nvit_tpu_torch.data import datasets, native, pipeline
from tests.torch_data_cases import jpeg_root

torch.set_num_threads(1)


def test_imagenet_folder_and_decodes_equal_the_jax_package(jpeg_root):
    got = datasets.load_dataset("imagenet", jpeg_root, train=True, image_size=16)
    want = jax_datasets.load_dataset("imagenet", jpeg_root, train=True, image_size=16)
    assert [p.name for p in got.paths] == [p.name for p in want.paths] and len(got) == 12
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.num_classes == want.num_classes == 3
    for i in range(len(got)):  # PIL, one image
        np.testing.assert_array_equal(got.decode(i), want.decode(i))
    idx = np.array([5, 0, 11, 3])
    batch = got.decode_batch(idx)
    assert batch.shape == (4, 3, 16, 16) and batch.dtype == np.uint8
    np.testing.assert_array_equal(batch, want.decode_batch(idx))
    assert len(datasets.load_dataset("imagenet", jpeg_root, train=False, image_size=16)) == 6
    with pytest.raises(FileNotFoundError, match="imagenet"):
        datasets.load_imagenet(jpeg_root / "nowhere")


def test_decode_batch_without_the_library_is_pil(jpeg_root, monkeypatch):
    ds = datasets.load_imagenet(jpeg_root, image_size=16)
    monkeypatch.setattr(native, "available", lambda: False)
    idx = np.arange(len(ds))
    np.testing.assert_array_equal(ds.decode_batch(idx), np.stack([ds.decode(int(i)) for i in idx]))


# ----------------------------------------------------------------- digits
@pytest.mark.parametrize("train", [True, False])
def test_digits_equal_the_jax_package(train):
    got = datasets.load_dataset("digits", "unused", train=train, image_size=16)
    want = jax_datasets.load_digits_dataset(train=train, image_size=16)
    assert got.images.shape == ((1438 if train else 359), 3, 16, 16)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    with pytest.raises(ValueError, match="multiple of 8"):
        datasets.load_digits_dataset(image_size=12)


# ----------------------------------------------------------------- native
def test_native_loader_builds_into_the_ports_build_dir_and_gathers():
    src = np.random.default_rng(3).integers(0, 256, (9, 3, 4, 5), dtype=np.uint8)
    idx = np.array([8, 0, 3, 3, 7])
    np.testing.assert_array_equal(native.gather_rows(src, idx), src[idx])
    np.testing.assert_array_equal(native.gather_rows(src.astype(np.int16), idx), src[idx])  # numpy route
    assert native.route() in ("native", "python")
    if native.route() == "native":
        assert native._library_path().is_file()
        assert native._library_path().parent == native.PKG_DIR / "_build"
        with pytest.raises(IndexError):
            native.gather_rows(src, np.array([9]))


@pytest.mark.parametrize("start_batch", [0, 1])
def test_folder_batches_equal_the_jax_pipeline(jpeg_root, start_batch):
    kw = dict(batch_size=5, epoch=2, seed=9, shuffle=True, drop_last=False, num_workers=2,
              start_batch=start_batch)
    got = list(pipeline.make_epoch_iterator(datasets.load_imagenet(jpeg_root, image_size=16), **kw))
    want = list(jax_pipeline.make_epoch_iterator(jax_datasets.load_imagenet(jpeg_root, image_size=16), **kw))
    assert len(got) == len(want) == 3 - start_batch
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_folder_iterator_abandoned_shuts_its_pool(jpeg_root):
    ds = datasets.load_imagenet(jpeg_root, image_size=16)
    it = pipeline.iterate_folder(ds, batch_size=2, num_workers=2)
    next(it)
    it.close()
    time.sleep(0.2)
    assert not [t for t in threading.enumerate() if t.name.startswith("nvit-decode") and t.is_alive()]
