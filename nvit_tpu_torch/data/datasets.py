"""Datasets (≙ nvit_tpu/data/datasets.py): CIFAR-10/100 in the python
batch format, ImageNet folders, scikit-learn's digits, and the
deterministic synthetic data.

* CIFAR-10/100: ``cifar-10-batches-py`` / ``cifar-100-python`` under
  ``data_dir``, read whole into one uint8 [N, 3, 32, 32] array; the
  archive beside it is extracted atomically, and ``data.download=true``
  fetches it, checksum-pinned (``download_cifar``).
* ImageNet: ``<data_dir>/imagenet/<split>/<wnid>/*.JPEG``, decoded by
  batch on the host (``data/native.py``, PIL where the library cannot be
  built): the shorter side resized to ``image_size``, then center-cropped.
* digits: scikit-learn's bundled 8×8 digits, upscaled and replicated to
  three channels; no download.
* synthetic: class-structured random arrays from a seed.

Images are CHW uint8 [0, 255]; normalization and AutoAugment run on the
device (``data/augment.py``).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tarfile
import time
import urllib.request
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nvit_tpu_torch.data import native

# elements of int64 noise drawn at once by make_synthetic (~64 MB)
_NOISE_CHUNK = 1 << 23


@dataclass
class ArrayDataset:
    """In-memory dataset: images uint8 [N, C, H, W], labels int32 [N]."""

    images: np.ndarray
    labels: np.ndarray
    num_classes: int
    name: str = "array"

    def __len__(self) -> int:
        return len(self.images)


# ------------------------------------------------------------------ CIFAR
def _cifar_unpickle(path: Path) -> dict:
    # the CIFAR batch files are pickles: read only files the user placed in
    # data_dir or an archive whose sha256 download_cifar verified
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def _maybe_extract(root: Path, archive_name: str, member_dir: str, variant: str) -> None:
    """Extract the archive atomically: unpack into a temporary sibling, then
    rename (≙ datasets.py:_maybe_extract).  A reader polling ``cifar_ready``
    never sees a half-written batch file; completeness, not the directory's
    existence, gates the no-op, so an incomplete directory left by a crash
    is moved aside and replaced, and stale temporary directories are swept."""
    archive = root / archive_name
    target = root / member_dir
    for stale in root.glob(member_dir + ".extract-*"):
        shutil.rmtree(stale, ignore_errors=True)
    if not archive.exists() or cifar_ready(root, variant):
        return
    tmp = root / f"{member_dir}.extract-{os.getpid()}"
    with tarfile.open(archive, "r:gz") as tf:
        tf.extractall(tmp, filter="data")  # refuses links, devices and absolute paths
    if target.exists():  # an incomplete directory from an interrupted extract
        broken = root / f"{member_dir}.extract-{os.getpid()}-old"
        target.rename(broken)
        shutil.rmtree(broken, ignore_errors=True)
    (tmp / member_dir).rename(target)  # atomic: readers see all or nothing
    shutil.rmtree(tmp, ignore_errors=True)


# variant → (url, archive, extracted directory, sha256 of the archive);
# NVIT_CIFAR{10,100}_SHA256 overrides the pin should the archive be re-rolled
_CIFAR_SOURCES = {
    "cifar10": (
        "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz",
        "cifar-10-python.tar.gz",
        "cifar-10-batches-py",
        "6d958be074577803d12ecdefd02955f39262c83c16fe9348329d7fe0b5c001ce",
    ),
    "cifar100": (
        "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz",
        "cifar-100-python.tar.gz",
        "cifar-100-python",
        "85cd44d02ba6437773c5bbd22e183051d648de2e7d6b014e1ef29b855ba677a7",
    ),
}


def _cifar_required_files(base: Path, variant: str) -> list[Path]:
    if variant == "cifar10":
        return [base / f"data_batch_{i}" for i in range(1, 6)] + [base / "test_batch"]
    return [base / "train", base / "test"]


def cifar_ready(data_dir: str | Path, variant: str) -> bool:
    """True when the extracted CIFAR batch files are all present."""
    base = Path(data_dir) / _CIFAR_SOURCES[variant][2]
    return all(p.exists() for p in _cifar_required_files(base, variant))


def _sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            h.update(chunk)
    return h.hexdigest()


def download_cifar(
    data_dir: str | Path,
    variant: str = "cifar10",
    *,
    url: str | None = None,
    sha256: str | None = None,
    timeout: float = 600.0,
) -> Path:
    """The opt-in CIFAR download (``data.download=true``), checksum-pinned
    (≙ datasets.py:download_cifar): fetch into ``<archive>.part``, verify
    its sha256, rename, extract.  Idempotent: extracted files short-circuit,
    and an archive already present is verified, never re-fetched."""
    src_url, archive_name, member_dir, pinned = _CIFAR_SOURCES[variant]
    url = url or src_url
    sha256 = sha256 or os.environ.get(f"NVIT_{variant.upper()}_SHA256") or pinned
    root = Path(data_dir)
    root.mkdir(parents=True, exist_ok=True)
    archive = root / archive_name
    if cifar_ready(root, variant):
        return root / member_dir
    if not archive.exists():
        part = archive.with_suffix(archive.suffix + ".part")
        h = hashlib.sha256()
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(part, "wb") as f:
            while chunk := resp.read(1 << 20):
                h.update(chunk)
                f.write(chunk)
        if h.hexdigest() != sha256:
            part.unlink()
            raise RuntimeError(
                f"{variant} download from {url} failed checksum verification: "
                f"got sha256 {h.hexdigest()}, expected {sha256}. Refusing to use it. "
                f"(Override with NVIT_{variant.upper()}_SHA256 only if the upstream "
                f"archive legitimately changed.)")
        part.rename(archive)  # atomic: readers never see a torn archive
    elif (got := _sha256_of(archive)) != sha256:
        raise RuntimeError(
            f"existing archive {archive} failed checksum verification: got sha256 {got}, "
            f"expected {sha256}. Delete it to re-download, or override "
            f"NVIT_{variant.upper()}_SHA256 if the upstream archive legitimately changed.")
    _maybe_extract(root, archive_name, member_dir, variant)
    return root / member_dir


def wait_for_cifar(data_dir: str | Path, variant: str, *, timeout: float | None = None) -> None:
    """Wait until another process's download and extract are complete
    (≙ datasets.py:wait_for_cifar); ``timeout`` defaults to
    ``NVIT_CIFAR_WAIT_S``, else 3600 s."""
    if timeout is None:
        timeout = float(os.environ.get("NVIT_CIFAR_WAIT_S", "") or 3600.0)
    deadline = time.monotonic() + timeout
    while not cifar_ready(data_dir, variant):
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out after {timeout}s waiting for the master process to "
                               f"download/extract {variant} under {data_dir}")
        time.sleep(1.0)


def load_cifar(
    data_dir: str | Path,
    *,
    variant: str = "cifar10",
    train: bool = True,
    download: bool = False,
    url: str | None = None,
    sha256: str | None = None,
) -> ArrayDataset:
    """CIFAR-10/100 from the python batch format (CIFAR-100: fine labels)."""
    root = Path(data_dir)
    if variant not in _CIFAR_SOURCES:
        raise ValueError(f"unknown CIFAR variant: {variant}")
    if download and not cifar_ready(root, variant):
        download_cifar(root, variant, url=url, sha256=sha256)
    _, archive_name, member_dir, _ = _CIFAR_SOURCES[variant]
    _maybe_extract(root, archive_name, member_dir, variant)
    base = root / member_dir
    if variant == "cifar10":
        files = [base / f"data_batch_{i}" for i in range(1, 6)] if train else [base / "test_batch"]
        label_key, num_classes = b"labels", 10
    else:
        files = [base / ("train" if train else "test")]
        label_key, num_classes = b"fine_labels", 100
    if not base.exists():
        raise FileNotFoundError(
            f"{variant} not found under {root} (expected {base}). Place the standard "
            f"python-format archive ({base.name}) there, set data.download=true "
            f"(checksum-pinned fetch, needs egress), or use dataset='synthetic'.")
    imgs, labels = [], []
    for f in files:
        d = _cifar_unpickle(f)
        imgs.append(np.asarray(d[b"data"], dtype=np.uint8).reshape(-1, 3, 32, 32))
        labels.append(np.asarray(d[label_key], dtype=np.int32))
    return ArrayDataset(images=np.concatenate(imgs), labels=np.concatenate(labels),
                        num_classes=num_classes, name=variant)


# --------------------------------------------------------------- ImageNet
@dataclass
class ImageFolderDataset:
    """A JPEG folder (ImageNet layout): paths and labels, decoded by batch
    (≙ datasets.py:ImageFolderDataset)."""

    paths: list[Path]
    labels: np.ndarray
    num_classes: int
    image_size: int
    name: str = "imagenet"

    def __len__(self) -> int:
        return len(self.paths)

    def decode_batch(self, indices: np.ndarray) -> np.ndarray:
        """Decode a batch → uint8 [n, 3, S, S]: the native threaded decoder
        (``data/native.py``) where it builds, PIL image by image otherwise
        and for any file the native decoder could not read."""
        if native.available():
            out, ok = native.decode_jpeg_batch([self.paths[int(i)] for i in indices], self.image_size)
            for j in np.nonzero(~ok)[0]:
                out[j] = self.decode(int(indices[j]))
            return out
        return np.stack([self.decode(int(i)) for i in indices])

    def decode(self, idx: int) -> np.ndarray:
        """Decode one image → uint8 CHW at ``image_size``: the shorter side
        resized to it (PIL's default filter), then the center crop."""
        from PIL import Image

        s = self.image_size
        with Image.open(self.paths[idx]) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = s / min(w, h)
            im = im.resize((max(s, round(w * scale)), max(s, round(h * scale))))
            w, h = im.size
            left, top = (w - s) // 2, (h - s) // 2
            arr = np.asarray(im.crop((left, top, left + s, top + s)), dtype=np.uint8)
        return arr.transpose(2, 0, 1)


def load_imagenet(data_dir: str | Path, *, split: str = "train", image_size: int = 224) -> ImageFolderDataset:
    """The ``<data_dir>/imagenet/<split>/<wnid>/*`` folder, classes in sorted order."""
    root = Path(data_dir) / "imagenet" / split
    if not root.exists():
        raise FileNotFoundError(
            f"ImageNet split not found at {root}; expected <data_dir>/imagenet/{split}/<wnid>/*.JPEG. "
            f"This environment cannot download datasets; use dataset='synthetic' otherwise.")
    classes = sorted(p.name for p in root.iterdir() if p.is_dir())
    paths: list[Path] = []
    labels: list[int] = []
    for i, c in enumerate(classes):
        files = sorted((root / c).iterdir())
        paths += files
        labels += [i] * len(files)
    return ImageFolderDataset(paths=paths, labels=np.asarray(labels, dtype=np.int32),
                              num_classes=len(classes), image_size=image_size)


# ------------------------------------------------------- synthetic, digits
def make_synthetic(
    *, num_examples: int = 2048, image_size: int = 32, num_classes: int = 100, seed: int = 0
) -> ArrayDataset:
    """Deterministic synthetic data with class-dependent structure, so models
    can overfit it — the same arrays as the JAX package's from the same seed.

    The JAX package draws the noise for all images in one call and adds it to
    ``base[labels]`` in int64 (about 11 GB of intermediates at 224 px and
    4096 images).  Here the noise is drawn in chunks of images: the legacy
    ``RandomState.randint`` stream draws element by element, so the values
    are unchanged (tests/test_torch_train.py holds them equal)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=num_examples).astype(np.int32)
    base = rng.randint(0, 255, size=(num_classes, 3, image_size, image_size)).astype(np.int16)
    images = np.empty((num_examples, 3, image_size, image_size), dtype=np.uint8)
    rows = max(1, _NOISE_CHUNK // (3 * image_size * image_size))
    for i in range(0, num_examples, rows):
        n = min(rows, num_examples - i)
        noise = rng.randint(-30, 30, size=(n, 3, image_size, image_size)).astype(np.int16)
        images[i:i + n] = np.clip(base[labels[i:i + n]] + noise, 0, 255)
    return ArrayDataset(images=images, labels=labels, num_classes=num_classes, name="synthetic")


def load_digits_dataset(*, train: bool = True, image_size: int = 16) -> ArrayDataset:
    """scikit-learn's bundled UCI digits (1797 8×8 grayscale images, 10
    classes; no download) (≙ datasets.py:load_digits_dataset): a fixed 80/20
    split, nearest-neighbour upscale to ``image_size`` (a multiple of 8) and
    the channel replicated to [N, 3, S, S] uint8."""
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise RuntimeError("dataset='digits' requires scikit-learn (its data is bundled; no download)") from e
    if image_size % 8 != 0:
        raise ValueError(f"digits images are 8×8; image_size must be a multiple of 8, got {image_size}")
    d = load_digits()
    imgs = (d.images * (255.0 / 16.0)).round().clip(0, 255).astype(np.uint8)  # pixels are 0..16
    perm = np.random.RandomState(1797).permutation(len(imgs))
    idx = perm[len(imgs) // 5:] if train else perm[: len(imgs) // 5]
    f = image_size // 8
    sel = np.repeat(np.repeat(imgs[idx], f, axis=1), f, axis=2)
    images = np.broadcast_to(sel[:, None, :, :], (len(idx), 3, image_size, image_size)).copy()
    return ArrayDataset(images=images, labels=d.target[idx].astype(np.int32), num_classes=10, name="digits")


def load_dataset(
    dataset: str,
    data_dir: str | Path,
    *,
    train: bool = True,
    image_size: int = 32,
    num_classes: int = 100,
    download: bool = False,
) -> ArrayDataset | ImageFolderDataset:
    """Dataset dispatch (≙ datasets.py:load_dataset)."""
    d = dataset.lower()
    if d in ("cifar10", "cifar100"):
        return load_cifar(data_dir, variant=d, train=train, download=download)
    if d == "imagenet":
        return load_imagenet(data_dir, split="train" if train else "val", image_size=image_size)
    if d == "digits":
        return load_digits_dataset(train=train, image_size=image_size)
    if d == "synthetic":
        return make_synthetic(num_examples=4096 if train else 1024, image_size=image_size,
                              num_classes=num_classes, seed=0 if train else 1)
    raise ValueError(f"Unknown dataset: {dataset}")
