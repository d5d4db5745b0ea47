"""Out-of-core polynomial matrices: host/disk offload and streamed products.

The port's counterpart of `mxx_tpu/matrix/offload.py`. A large matrix lives
in a numpy memmap of its uint32 limb planes [L, r, c, n] (the JAX package's
layout, so either package maps the other's files); the products stream
column or row chunks through the device, so peak device memory is one chunk
instead of the whole operand. Every `load*` takes the device to load onto
explicitly: the device of the operands it meets.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

from ..ring.params import RingParams
from .poly_matrix import PolyMatrix


@dataclass
class OffloadedMatrix:
    """A PolyMatrix resident in a host memmap (disk-backed)."""

    path: str
    shape: tuple[int, int, int, int]  # [L, r, c, n]
    fmt: str
    params: RingParams
    _owns_file: bool = False

    @property
    def nrow(self) -> int:
        return self.shape[1]

    @property
    def ncol(self) -> int:
        return self.shape[2]

    def _mmap(self) -> np.memmap:
        return np.memmap(self.path, dtype=np.uint32, mode="r", shape=self.shape)

    def _to_device(self, planes: np.ndarray, device) -> PolyMatrix:
        # residues are below 2^31: move them as int32 and widen on the device
        data = torch.from_numpy(np.array(planes).view(np.int32)).to(device)
        return PolyMatrix(data.to(torch.int64), self.fmt, self.params)

    def load(self, device) -> PolyMatrix:
        """Materialize the whole matrix on `device`."""
        return self._to_device(self._mmap(), device)

    def load_columns(self, start: int, end: int, device) -> PolyMatrix:
        """Materialize a column window on `device` (column-chunk streaming)."""
        return self._to_device(self._mmap()[:, :, start:end, :], device)

    def load_rows(self, start: int, end: int, device) -> PolyMatrix:
        return self._to_device(self._mmap()[:, start:end, :, :], device)

    def delete(self):
        if self._owns_file and os.path.exists(self.path):
            os.unlink(self.path)


def offload_matrix(mat: PolyMatrix, path: str | None = None) -> OffloadedMatrix:
    """Copy a matrix into a host memmap; its device memory is freed once the
    caller drops its reference. Without `path`, the file is a temporary one
    that `delete()` removes."""
    owns = path is None
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".mxmm")
        os.close(fd)
    data = mat.data.to(torch.int32).cpu().numpy().view(np.uint32)
    mm = np.memmap(path, dtype=np.uint32, mode="w+", shape=data.shape)
    mm[:] = data
    mm.flush()
    return OffloadedMatrix(path, tuple(data.shape), mat.fmt, mat.params, owns)


def matmul_streamed(a: PolyMatrix, b: OffloadedMatrix, chunk_cols: int = 64) -> PolyMatrix:
    """a @ B for an offloaded B, streaming column chunks of B onto a's device."""
    if a.ncol != b.nrow:
        raise ValueError(f"shape mismatch {a.shape} @ {(b.nrow, b.ncol)}")
    outs = [a @ b.load_columns(start, min(start + chunk_cols, b.ncol), a.data.device)
            for start in range(0, b.ncol, chunk_cols)]
    return outs[0].concat_columns(outs[1:])


def matmul_offloaded_lhs(a: OffloadedMatrix, b: PolyMatrix, chunk_rows: int = 64) -> PolyMatrix:
    """A @ b for an offloaded A, streaming row chunks of A onto b's device."""
    if a.ncol != b.nrow:
        raise ValueError(f"shape mismatch {(a.nrow, a.ncol)} @ {b.shape}")
    outs = [a.load_rows(start, min(start + chunk_rows, a.nrow), b.data.device) @ b
            for start in range(0, a.nrow, chunk_rows)]
    return outs[0].concat_rows(outs[1:])
