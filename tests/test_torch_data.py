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
"""

import hashlib
import http.server
import io
import pickle
import tarfile
import threading
import time

import numpy as np
import pytest
import torch

from nvit_tpu.data import datasets as jax_datasets
from nvit_tpu.data import pipeline as jax_pipeline
from nvit_tpu_torch.data import datasets, native, pipeline

torch.set_num_threads(1)


def write_cifar(root, variant, n=12, seed=0):
    """A tiny CIFAR tree in the python batch format under ``root``."""
    rng = np.random.RandomState(seed)
    if variant == "cifar10":
        base = root / "cifar-10-batches-py"
        files, key, classes = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"], b"labels", 10
    else:
        base = root / "cifar-100-python"
        files, key, classes = ["train", "test"], b"fine_labels", 100
    base.mkdir(parents=True)
    for name in files:
        labels = rng.randint(0, classes, n)
        batch = {b"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8), key: labels.tolist()}
        if variant == "cifar100":
            batch[b"coarse_labels"] = (labels // 5).tolist()
        (base / name).write_bytes(pickle.dumps(batch))
    return base


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


# ------------------------------------------------------- archive, download
def mini_cifar10_targz() -> bytes:
    """A format-correct cifar-10-python.tar.gz of 4 images per batch."""
    buf = io.BytesIO()
    rng = np.random.RandomState(0)
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
            data = pickle.dumps({b"data": rng.randint(0, 256, (4, 3072), dtype=np.uint8),
                                 b"labels": rng.randint(0, 10, 4).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


@pytest.fixture(scope="module")
def archive_server():
    """A local HTTP server of the mini archive → (url, sha256, payload)."""
    payload = mini_cifar10_targz()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield (f"http://127.0.0.1:{srv.server_address[1]}/cifar-10-python.tar.gz",
           hashlib.sha256(payload).hexdigest(), payload)
    srv.shutdown()
    srv.server_close()


UNREACHABLE = "http://127.0.0.1:1/unused"


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


# --------------------------------------------------------------- ImageNet
@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """imagenet/{train,val}/<wnid>/*.JPEG: 3 classes, odd sizes, grayscale among them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folders")
    rng = np.random.default_rng(7)
    sizes = [(40, 30), (23, 37), (32, 32), (50, 20)]
    for split, n in (("train", 4), ("val", 2)):
        for c in range(3):
            folder = root / "imagenet" / split / f"n0000{c}"
            folder.mkdir(parents=True)
            for i in range(n):
                w, h = sizes[(c + i) % len(sizes)]
                px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                im = Image.fromarray(px).convert("L") if (c, i) == (1, 1) else Image.fromarray(px)
                im.save(folder / f"img_{i}.JPEG", quality=85)
    return root


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


# --------------------------------------------------------------- pipeline
@pytest.mark.parametrize("kw", [
    dict(epoch=3, shuffle=True),
    dict(epoch=0, shuffle=False, drop_last=False),
    dict(epoch=1, shuffle=True, start_batch=2),
    dict(epoch=2, shuffle=True, shard_index=1, shard_count=3),
])
def test_array_batches_equal_the_jax_pipeline(kw):
    rng = np.random.default_rng(22)
    imgs = rng.integers(0, 256, (41, 3, 4, 4), dtype=np.uint8)
    labels = rng.integers(0, 5, 41).astype(np.int32)
    idx_kw = {k: v for k, v in kw.items() if k in ("epoch", "shuffle", "shard_index", "shard_count")}
    np.testing.assert_array_equal(pipeline.epoch_indices(41, seed=4, **idx_kw),
                                  jax_pipeline.epoch_indices(41, seed=4, **idx_kw))
    want = list(jax_pipeline.make_epoch_iterator(jax_datasets.ArrayDataset(imgs, labels, 5), batch_size=4,
                                                 seed=4, **{"drop_last": True, **kw}))
    got = list(pipeline.make_epoch_iterator(datasets.ArrayDataset(imgs, labels, 5), batch_size=4, seed=4,
                                            **{"drop_last": True, **kw}))
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


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


def host_batches(n):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 256, (2, 3, 4, 4), dtype=np.uint8), np.arange(2, dtype=np.int32) + i)
            for i in range(n)]


def test_device_prefetch_yields_every_batch():
    host = host_batches(7)
    got = list(pipeline.device_prefetch(iter(host), "cpu", size=2))
    assert len(got) == 7
    for (gi, gl), (hi, hl) in zip(got, host):
        assert gi.dtype == torch.uint8 and gl.dtype == torch.int64
        np.testing.assert_array_equal(gi.numpy(), hi)
        np.testing.assert_array_equal(gl.numpy(), hl)


def test_device_prefetch_reraises_the_producers_error():
    def source():
        yield from host_batches(2)
        raise OSError("corrupt shard")

    got = []
    with pytest.raises(OSError, match="corrupt shard"):
        for batch in pipeline.device_prefetch(source(), "cpu", size=1):
            got.append(batch)
    assert len(got) == 2


def test_device_prefetch_abandoned_releases_the_producer_and_the_source():
    closed = threading.Event()

    def source():
        try:
            yield from host_batches(1000)
        finally:
            closed.set()

    before = {t.ident for t in threading.enumerate()}
    it = pipeline.device_prefetch(source(), "cpu", size=2)
    assert len([next(it) for _ in range(3)]) == 3
    it.close()  # what a capped eval's break does
    assert closed.wait(5)
    left = [t for t in threading.enumerate() if t.ident not in before and t.name == "nvit-prefetch"]
    for t in left:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in left)


def test_folder_iterator_abandoned_shuts_its_pool(jpeg_root):
    ds = datasets.load_imagenet(jpeg_root, image_size=16)
    it = pipeline.iterate_folder(ds, batch_size=2, num_workers=2)
    next(it)
    it.close()
    time.sleep(0.2)
    assert not [t for t in threading.enumerate() if t.name.startswith("nvit-decode") and t.is_alive()]
