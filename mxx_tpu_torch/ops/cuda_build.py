"""Build the port's native sources and load them with ctypes.

Each source under `mxx_tpu_torch/csrc/` is a plain-C-interface shared library
(no PyTorch headers, so a build takes seconds): a `.cu` file is compiled by
nvcc for sm_90a, a host `.cpp` file (`csrc/host/`: the artifact codec and
writer) by g++. It is built at first use into `build/mxx_tpu_torch/` at the
root of the checkout, under a name keyed by a hash of the source and the
flags; a later process finds the library there and only loads it. A failed
or impossible build raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mxx_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

# source name -> (ctypes.CDLL, seconds spent building in this process)
_LOADED: dict[str, tuple[ctypes.CDLL, float]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return str(path)


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host codec and writer are built with g++")
    return found


def _flags(source: str) -> tuple[str, ...]:
    """nvcc's flags for a .cu source, g++'s for a host .cpp one."""
    return NVCC_FLAGS if source.endswith(".cu") else HOST_FLAGS


def _stem(source: str) -> Path:
    """Build path without suffix: source name plus a hash of source and flags."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(source)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}"


def load(source: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<source>`, building it if needed."""
    if source in _LOADED:
        return _LOADED[source][0]
    src = CSRC / source
    stem = _stem(source)
    lib_path = stem.with_suffix(".so")
    seconds = 0.0
    if not lib_path.exists():
        compiler = _nvcc() if source.endswith(".cu") else _gxx()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build under a temporary name and rename, so that concurrent
        # processes never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *_flags(source), "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        stem.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{Path(compiler).name} failed on {src.name}:\n{log}")
        os.replace(tmp, lib_path)
        seconds = time.perf_counter() - t0
    _LOADED[source] = (ctypes.CDLL(str(lib_path)), seconds)
    return _LOADED[source][0]


def build_seconds(source: str) -> float:
    """Seconds this process spent compiling `source` (0 if it was cached)."""
    return _LOADED[source][1]


def build_log(source: str) -> str:
    """The compiler's output for the current build of `source` (for a .cu
    source, ptxas resource usage)."""
    path = _stem(source).with_suffix(".log")
    return path.read_text() if path.exists() else ""
