"""ctypes bindings for the host asynchronous artifact writer
(`csrc/host/writer.cpp`).

The port's counterpart of `mxx_tpu/native/writer.py`: a pool of C++ worker
threads writes queued files (each to `<path>.tmp`, then renamed), and
`wait_all_writes` is the barrier. The library is built with g++ at first use
into `build/mxx_tpu_torch/` (`ops/cuda_build.py`); a failed build raises, and
no path of the port falls back to Python writes.

`submit_write` hands the writer pointers into the caller's buffers instead of
copying them. The buffers of a file are held here, under the file's sequence
number, until the writer reports that number finished; the next
`submit_write` or `wait_all_writes` then lets them go. At interpreter exit
the writer is drained first.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import threading

import numpy as np

from ..ops import cuda_build

SOURCE = "host/writer.cpp"
WORKERS = 4

_held_lock = threading.Lock()
_held: dict[int, list] = {}  # sequence number -> buffers of a queued file
_next_seq = 0
_DONE_BATCH = 256


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.mxx_writer_init.argtypes = [ctypes.c_uint32]
    lib.mxx_writer_init.restype = None
    lib.mxx_writer_submit_parts.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint32, ctypes.c_uint64,
    ]
    lib.mxx_writer_submit_parts.restype = None
    lib.mxx_writer_take_done.argtypes = [ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32]
    lib.mxx_writer_take_done.restype = ctypes.c_uint32
    lib.mxx_writer_wait_all.argtypes = []
    lib.mxx_writer_wait_all.restype = None
    lib.mxx_writer_errors.argtypes = []
    lib.mxx_writer_errors.restype = ctypes.c_uint64
    lib.mxx_writer_init(WORKERS)
    atexit.register(wait_all_writes)
    return lib


def build() -> float:
    """Build (or load) the library; seconds spent compiling."""
    _lib()
    return cuda_build.build_seconds(SOURCE)


def _release_done(lib: ctypes.CDLL) -> None:
    """Drop the buffers of every file the writer has finished."""
    out = (ctypes.c_uint64 * _DONE_BATCH)()
    with _held_lock:
        while n := lib.mxx_writer_take_done(out, _DONE_BATCH):
            for seq in out[:n]:
                del _held[seq]


def submit_write(path, parts) -> None:
    """Queue the file `path` made of the bytes-like `parts`, in order. The
    writer reads them in place; they stay referenced until it has written
    them."""
    lib = _lib()
    _release_done(lib)
    arrays = [np.frombuffer(part, dtype=np.uint8) for part in parts]
    count = len(arrays)
    ptrs = (ctypes.c_void_p * count)(*[a.ctypes.data for a in arrays])
    lens = (ctypes.c_uint64 * count)(*[a.size for a in arrays])
    global _next_seq
    with _held_lock:
        seq = _next_seq
        _next_seq += 1
        _held[seq] = arrays
    lib.mxx_writer_submit_parts(str(path).encode(), ptrs, lens, count, seq)


def held_files() -> int:
    """Queued files whose buffers are still held (written ones not yet
    released included)."""
    with _held_lock:
        return len(_held)


def wait_all_writes() -> None:
    """Block until every write submitted before this call is on disk (or
    counted in `write_errors`), then release the buffers of every finished
    file."""
    lib = _lib()
    lib.mxx_writer_wait_all()
    _release_done(lib)


def write_errors() -> int:
    """Writes that failed since the writer started (cumulative)."""
    return int(_lib().mxx_writer_errors())
