"""Build and load the port's CUDA kernels (``nvit_tpu_torch/csrc/*.cu``).

Each source file is compiled on first use with ``nvcc`` into its own shared
library with a plain C interface, then loaded with ``ctypes``; the wrappers
in ``ops/`` pass device pointers and the current stream as ``c_void_p``.  No
PyTorch headers are compiled, so a build takes seconds.

The library lands in ``nvit_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so an edited kernel is rebuilt and
a stale library is never loaded.  Each build keeps ``ptxas -v``'s report
(registers, shared memory, spills per kernel) beside its library, read by
``ptxas_report``.  ``nvcc`` comes from ``PATH``, else from
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).  Without ``nvcc``, or when
the compile fails, ``load_library`` raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, kept beside the library
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # a shared header edit rebuilds too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built → path."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    out = _library_path(name)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build kernel {name!r}: nvcc not found on PATH or under CUDA_HOME "
            "(the CUDA toolkit is required to run the port's kernels)"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {name!r} (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def ptxas_report(name: str) -> dict[str, dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (mangled name) → its ``registers``,
    static ``smem`` bytes, ``stack`` bytes and ``spill_stores`` /
    ``spill_loads`` bytes, from ``ptxas -v`` at its build."""
    report: dict[str, dict[str, int]] = {}
    kernel = None
    for line in build(name).with_suffix(".ptxas.txt").read_text().splitlines():
        if m := _PTXAS_ENTRY.search(line):
            kernel = report.setdefault(m.group(1), {})
        elif kernel is not None and (m := _PTXAS_FRAME.search(line)):
            kernel.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif kernel is not None and (m := _PTXAS_USED.search(line)):
            kernel.update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu`` → the ctypes library."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
