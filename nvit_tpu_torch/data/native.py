"""The native host loader (≙ nvit_tpu/data/native.py): a ctypes binding of
``native/nvit_loader.cpp``, which decodes a batch of JPEGs on a C++ thread
pool (libjpeg's DCT downscale, bilinear resize of the shorter side, center
crop, CHW) and gathers uint8 rows on several threads, without the GIL.

The library is the port's own: built at first use with ``g++ -O3
-march=native -std=c++17 -shared -fPIC … -ljpeg -lpthread`` (the flags of
``native/build.sh``) into ``nvit_tpu_torch/_build/``, named by a hash of the
source, the flags and the host's CPU (``-march=native`` builds for it), as
``ops/_build.py`` names the kernels: a library built on another host is
never loaded.  This is host
code, not a kernel: where the library cannot be built or loaded (no
compiler, no ``jpeglib.h``, no source beside the package), ``gather_rows``
takes numpy's gather and the folder datasets decode with PIL, as the JAX
package does; that is logged once at WARNING and ``route()`` says which
route runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("nvit_tpu_torch.native")

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR.parent / "native" / "nvit_loader.cpp"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = ("-ljpeg", "-lpthread")
ABI_VERSION = 1

_U8P, _I64P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64)


class _Loader:
    """The library, built and loaded once per process (``None`` after a failure)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib: ctypes.CDLL | None = None

    def get(self) -> ctypes.CDLL | None:
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self.lib = _load(_build())
                    logger.info("native loader ready")
                except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                    logger.warning("native loader unavailable (%s); using the Python route "
                                   "(numpy gather, PIL decode)", e)
            return self.lib


_loader = _Loader()


def _host_cpu() -> str:
    """The machine and the first CPU's model name and flags: what
    ``-march=native`` compiles for."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    first = text.split("\n\n", 1)[0]
    keys = [line for line in first.splitlines()
            if line.split(":")[0].strip() in ("model name", "flags", "Features")]
    return "\n".join([platform.machine(), platform.processor(), *keys])


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libnvit_loader-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile the loader unless its library is built → path."""
    if not SOURCE.is_file():
        raise RuntimeError(f"no loader source at {SOURCE}")
    out = _library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}): {proc.stderr.strip()[-500:]}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.nvit_decode_jpeg_batch.restype = ctypes.c_int
    lib.nvit_decode_jpeg_batch.argtypes = [ctypes.c_char_p, _I64P, ctypes.c_int, ctypes.c_int,
                                           _U8P, _U8P, ctypes.c_int]
    lib.nvit_gather_u8.restype = None
    lib.nvit_gather_u8.argtypes = [_U8P, _I64P, ctypes.c_int, ctypes.c_int64, _U8P, ctypes.c_int]
    lib.nvit_loader_abi_version.restype = ctypes.c_int
    lib.nvit_loader_abi_version.argtypes = []
    if lib.nvit_loader_abi_version() != ABI_VERSION:
        raise RuntimeError(f"loader ABI {lib.nvit_loader_abi_version()}, expected {ABI_VERSION}")
    return lib


def available() -> bool:
    return _loader.get() is not None


def route() -> str:
    """``"native"`` when the library runs the gather and decode, else ``"python"``."""
    return "native" if available() else "python"


def decode_jpeg_batch(paths: list[str | os.PathLike], target: int, num_threads: int = 8
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs → (uint8 [n, 3, target, target] CHW, ok [n] bool); a
    file that fails to decode is zero-filled and flagged.  Raises
    ``RuntimeError`` without the library: the caller picks the fallback
    (``ImageFolderDataset.decode_batch``)."""
    lib = _loader.get()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    encoded = [os.fsencode(p) + b"\0" for p in paths]
    offsets = np.cumsum([0] + [len(e) for e in encoded[:-1]], dtype=np.int64)
    n = len(paths)
    out = np.empty((n, 3, target, target), dtype=np.uint8)
    ok = np.empty((n,), dtype=np.uint8)
    lib.nvit_decode_jpeg_batch(b"".join(encoded), offsets.ctypes.data_as(_I64P), n, target,
                               out.ctypes.data_as(_U8P), ok.ctypes.data_as(_U8P), num_threads)
    return out, ok.astype(bool)


def gather_rows(src: np.ndarray, indices: np.ndarray, num_threads: int = 4) -> np.ndarray:
    """``src[indices]`` along the first axis: a threaded memcpy for a
    C-contiguous uint8 ``src``, numpy's gather otherwise or without the
    library.  Indices are checked here: the native gather does not."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    lib = _loader.get()
    if lib is None or src.dtype != np.uint8 or not src.flags.c_contiguous:
        return src[idx]
    if len(idx) and (idx.min() < 0 or idx.max() >= len(src)):
        raise IndexError(f"gather index out of range for {len(src)} rows")
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64))
    dst = np.empty((len(idx),) + src.shape[1:], dtype=np.uint8)
    lib.nvit_gather_u8(src.ctypes.data_as(_U8P), idx.ctypes.data_as(_I64P), len(idx), row_bytes,
                       dst.ctypes.data_as(_U8P), num_threads)
    return dst
