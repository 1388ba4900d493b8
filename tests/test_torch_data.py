"""The port's data path against the JAX package's, on the CPU.

* readers: CIFAR-10/100 (splits, labels, pixel layout) against
  ``nvit_tpu.data.datasets.load_cifar`` on tiny files the test writes; the
  archive's atomic extraction and the repair of a half-extracted tree; the
  checksum-pinned download against a local HTTP server (refusal,
  idempotence, ``wait_for_cifar``, the pin override); ``load_imagenet`` and
  ``decode`` / ``decode_batch`` bit-equal to the JAX package's on JPEGs
  written with PIL; digits arrays equal to JAX's;
* the native loader: built from ``native/nvit_loader.cpp`` into the port's
  own build directory, ``gather_rows`` equal to numpy's gather, ``route()``;
* the pipeline: ``epoch_indices`` (sharded), ``iterate_array``,
  ``iterate_folder`` and ``make_epoch_iterator`` batches equal to the JAX
  package's for the same seed, epoch and ``start_batch``;
  ``device_prefetch`` yields every batch, re-raises the producer's error,
  and releases its thread and the source when abandoned.

Companion files: tests/test_torch_data_folders.py,
tests/test_torch_data_pipeline.py; shared inputs: tests/torch_data_cases.py.
"""

import pickle
import time

import numpy as np
import pytest
import torch

from nvit_tpu.data import datasets as jax_datasets
from nvit_tpu_torch.data import datasets
from tests.torch_data_cases import UNREACHABLE, archive_server, write_cifar

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", ["cifar10", "cifar100"])
@pytest.mark.parametrize("train", [True, False])
def test_cifar_readers_equal_the_jax_package(tmp_path, variant, train):
    write_cifar(tmp_path, variant)
    got = datasets.load_dataset(variant, tmp_path, train=train)
    want = jax_datasets.load_dataset(variant, tmp_path, train=train)
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    assert got.images.shape == ((60 if variant == "cifar10" and train else 12), 3, 32, 32)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert (got.num_classes, got.name) == (want.num_classes, want.name)


def test_cifar_pixel_layout(tmp_path):
    """A 3072-byte row is the R, G and B planes of a 32×32 image."""
    base = tmp_path / "cifar-100-python"
    base.mkdir()
    img = np.zeros((3, 32, 32), dtype=np.uint8)
    img[0, 0, 0], img[1, 5, 7], img[2, 31, 31] = 255, 77, 128
    for split in ("train", "test"):
        (base / split).write_bytes(pickle.dumps({b"data": img.reshape(1, -1), b"fine_labels": [42]}))
    ds = datasets.load_cifar(tmp_path, variant="cifar100")
    np.testing.assert_array_equal(ds.images[0], img)
    assert ds.labels[0] == 42


def test_missing_cifar_names_the_remedy(tmp_path):
    with pytest.raises(FileNotFoundError, match="data.download=true"):
        datasets.load_cifar(tmp_path, variant="cifar10")
    with pytest.raises(ValueError, match="unknown CIFAR variant"):
        datasets.load_cifar(tmp_path, variant="cifar20")


def test_archive_is_extracted_atomically_and_repaired(tmp_path, archive_server):
    """An archive beside the data is extracted on load; a tree missing a
    file (an interrupted extract) and a stale temporary directory are
    replaced from the archive; the result equals the JAX package's."""
    _, _, payload = archive_server
    (tmp_path / "cifar-10-python.tar.gz").write_bytes(payload)
    assert len(datasets.load_cifar(tmp_path, variant="cifar10")) == 20
    assert datasets.cifar_ready(tmp_path, "cifar10")
    (tmp_path / "cifar-10-batches-py" / "data_batch_3").unlink()
    (tmp_path / "cifar-10-batches-py.extract-99999").mkdir()
    assert not datasets.cifar_ready(tmp_path, "cifar10")
    ds = datasets.load_cifar(tmp_path, variant="cifar10")
    assert datasets.cifar_ready(tmp_path, "cifar10") and len(ds) == 20
    assert not list(tmp_path.glob("*.extract-*"))
    np.testing.assert_array_equal(ds.images, jax_datasets.load_cifar(tmp_path, variant="cifar10").images)


def test_download_verifies_extracts_and_loads(tmp_path, archive_server):
    url, sha, _ = archive_server
    ds = datasets.load_cifar(tmp_path, variant="cifar10", download=True, url=url, sha256=sha)
    assert ds.images.shape == (20, 3, 32, 32) and ds.num_classes == 10
    assert (tmp_path / "cifar-10-python.tar.gz").exists()
    assert not (tmp_path / "cifar-10-python.tar.gz.part").exists()
    # the test split from disk, no second fetch
    assert len(datasets.load_cifar(tmp_path, variant="cifar10", train=False, download=True, url=UNREACHABLE,
                                   sha256=sha)) == 4


def test_download_is_idempotent(tmp_path, archive_server):
    url, sha, _ = archive_server
    first = datasets.download_cifar(tmp_path, "cifar10", url=url, sha256=sha)
    mtime = (tmp_path / "cifar-10-python.tar.gz").stat().st_mtime_ns
    assert datasets.download_cifar(tmp_path, "cifar10", url=UNREACHABLE, sha256=sha) == first
    assert (tmp_path / "cifar-10-python.tar.gz").stat().st_mtime_ns == mtime


def test_download_refuses_a_checksum_mismatch(tmp_path, archive_server):
    url, _, _ = archive_server
    with pytest.raises(RuntimeError, match="checksum"):
        datasets.download_cifar(tmp_path, "cifar10", url=url, sha256="0" * 64)
    assert not (tmp_path / "cifar-10-python.tar.gz").exists()
    assert not (tmp_path / "cifar-10-python.tar.gz.part").exists()
    (tmp_path / "cifar-10-python.tar.gz").write_bytes(b"corrupt")  # a pre-staged bad archive
    with pytest.raises(RuntimeError, match="existing archive"):
        datasets.download_cifar(tmp_path, "cifar10", url=UNREACHABLE, sha256="a" * 64)
    assert (tmp_path / "cifar-10-python.tar.gz").exists()  # left for inspection


def test_download_pin_override_and_wait(tmp_path, archive_server, monkeypatch):
    url, sha, _ = archive_server
    monkeypatch.setenv("NVIT_CIFAR_WAIT_S", "0.05")
    with pytest.raises(TimeoutError, match="0.05"):
        datasets.wait_for_cifar(tmp_path, "cifar10")
    monkeypatch.setenv("NVIT_CIFAR10_SHA256", sha)
    assert len(datasets.load_cifar(tmp_path, variant="cifar10", download=True, url=url)) == 20
    t0 = time.monotonic()
    datasets.wait_for_cifar(tmp_path, "cifar10", timeout=1.0)  # ready: returns at once
    assert time.monotonic() - t0 < 0.5
