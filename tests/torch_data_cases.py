"""Shared inputs, helpers and fixtures of tests/test_torch_data.py,
tests/test_torch_data_folders.py, tests/test_torch_data_pipeline.py."""

import hashlib
import http.server
import io
import pickle
import tarfile
import threading

import numpy as np
import pytest


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


def host_batches(n):
    rng = np.random.default_rng(5)
    return [(rng.integers(0, 256, (2, 3, 4, 4), dtype=np.uint8), np.arange(2, dtype=np.int32) + i)
            for i in range(n)]
