"""ctypes bindings for the host bit-packing codec (`csrc/host/codec.cpp`).

The port's counterpart of `mxx_tpu/native/codec.py`, with the same bytes: a
little-endian bitstream of `bits` bits per uint32 value. The library is built
with g++ at first use into `build/mxx_tpu_torch/` (`ops/cuda_build.py`); a
failed build raises, and no path of the port falls back to numpy.
`pack_u32_plain`/`unpack_u32_plain` are the numpy versions the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import cuda_build

SOURCE = "host/codec.cpp"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U32P = ctypes.POINTER(ctypes.c_uint32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.mxx_pack_u32.argtypes = [_U32P, ctypes.c_uint64, ctypes.c_uint32, _U8P]
    lib.mxx_pack_u32.restype = None
    lib.mxx_unpack_u32.argtypes = [_U8P, ctypes.c_uint64, ctypes.c_uint32, _U32P]
    lib.mxx_unpack_u32.restype = None
    return lib


def build() -> float:
    """Build (or load) the library; seconds spent compiling."""
    _lib()
    return cuda_build.build_seconds(SOURCE)


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")


def packed_size(count: int, bits: int) -> int:
    return (count * bits + 7) // 8


def pack_u32(values: np.ndarray, bits: int) -> bytes:
    """Pack uint32 values (the low `bits` bits of each) into a bitstream."""
    _check_bits(bits)
    values = np.ascontiguousarray(values, dtype=np.uint32).ravel()
    out = np.empty(packed_size(values.size, bits), dtype=np.uint8)
    _lib().mxx_pack_u32(values.ctypes.data_as(_U32P), values.size, bits,
                        out.ctypes.data_as(_U8P))
    return out.tobytes()


def unpack_u32(raw, count: int, bits: int) -> np.ndarray:
    """`count` uint32 values of `bits` bits from a bitstream."""
    _check_bits(bits)
    inp = np.frombuffer(raw, dtype=np.uint8)
    if inp.size < packed_size(count, bits):
        raise ValueError(f"{inp.size} packed bytes hold fewer than {count} values of {bits} bits")
    out = np.empty(count, dtype=np.uint32)
    _lib().mxx_unpack_u32(inp.ctypes.data_as(_U8P), count, bits, out.ctypes.data_as(_U32P))
    return out


def pack_u32_plain(values: np.ndarray, bits: int) -> bytes:
    """numpy version of `pack_u32` (bit planes, then `packbits`)."""
    values = np.ascontiguousarray(values, dtype=np.uint32).ravel()
    v = values & np.uint32((1 << bits) - 1 if bits < 32 else 0xFFFFFFFF)
    planes = ((v[:, None] >> np.arange(bits, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
    return np.packbits(planes.ravel(), bitorder="little")[: packed_size(values.size, bits)].tobytes()


def unpack_u32_plain(raw, count: int, bits: int) -> np.ndarray:
    """numpy version of `unpack_u32`."""
    bit_arr = np.unpackbits(np.frombuffer(raw, dtype=np.uint8), bitorder="little")
    bit_arr = bit_arr[: count * bits].reshape(count, bits).astype(np.uint32)
    return (bit_arr << np.arange(bits, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
