"""Radix-2 forward negacyclic NTT: the plain PyTorch version and the wrappers
of the CUDA kernel in `csrc/radix_ntt.cu`.

The port's counterpart of `mxx_tpu/ops/pallas_ntt.py`, whose TPU kernel runs
the merged-twist butterfly stages with pair distance t >= 128 (the "head")
and leaves the stages with t < 128 (the "tail") to jnp, because Mosaic cannot
reshape below the 128-wide lane dimension. The card has no such limit: one
kernel launch runs the stages down to a pair distance it is given.

- `ntt_fwd_head`: the TPU kernel's function, the stages with t >= 128, on
  int64[L, ..., n] for n > 128.
- `ntt_fwd_hybrid`: the whole forward transform, equal to
  `ring.ntt.ntt_fwd`; for n <= 128 it is the radix chain, as in the JAX
  package.

Each launches the kernel for a tensor on a CUDA device and takes its plain
version (`ntt_fwd_head_plain`, `ntt_fwd_hybrid_plain`) for a tensor on the
CPU; anything the kernel does not take raises. `launches` counts kernel
launches per entry point.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ring import ntt
from ..utils.u32 import addmod, submod
from . import cuda_build

LANE = 128
SOURCE = "radix_ntt.cu"

# kernel launches per entry point; a plain integer each, reset by callers that
# want to count the launches of one run
launches = {"head": 0, "hybrid": 0}


# ------------------------------------------------------------ plain version


def _radix2(x: torch.Tensor, psi_rev: torch.Tensor, q: torch.Tensor, m_lo: int,
            m_hi: int) -> torch.Tensor:
    """Stages m = m_lo, 2 m_lo, ... < m_hi (pair distance t = n / 2m) of the
    merged-twist forward transform on [L, P, n], as `pallas_ntt.py:45-56`
    (head) and `:99-108` (tail) compute them."""
    L, P, n = x.shape
    qb = q.view(L, 1, 1, 1)
    m = m_lo
    while m < m_hi:
        t = n // (2 * m)
        v = x.reshape(L, P, m, 2, t)
        a = v[..., 0, :]
        wb = v[..., 1, :] * psi_rev[:, m : 2 * m].reshape(L, 1, m, 1) % qb
        x = torch.stack((addmod(a, wb, qb), submod(a, wb, qb)), dim=-2).reshape(L, P, n)
        m *= 2
    return x


def _head_n(x: torch.Tensor) -> int:
    n = x.shape[-1]
    if n <= LANE:
        raise ValueError(f"the NTT head needs n > {LANE}, got n={n}")
    return n


def ntt_fwd_head_plain(x: torch.Tensor, params) -> torch.Tensor:
    """Plain PyTorch head: the stages with pair distance t >= 128."""
    n = _head_n(x)
    t = params.tables(x.device)
    flat = x.reshape(x.shape[0], -1, n)
    return _radix2(flat, t.psi_rev, t.moduli, 1, n // LANE).reshape(x.shape)


def ntt_fwd_hybrid_plain(x: torch.Tensor, params) -> torch.Tensor:
    """Plain PyTorch whole forward transform: the head, then the tail stages."""
    n = x.shape[-1]
    t = params.tables(x.device)
    if n <= LANE:
        return ntt.ntt_fwd(x, t.psi_rev, t.moduli)
    flat = x.reshape(x.shape[0], -1, n)
    return _radix2(flat, t.psi_rev, t.moduli, 1, n).reshape(x.shape)


# -------------------------------------------------------------- CUDA kernel


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load(SOURCE)
    fn = lib.mxx_radix_ntt_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load) the kernel library; seconds spent compiling."""
    _kernel()
    return cuda_build.build_seconds(SOURCE)


def _device_tables(params, device: torch.device):
    """(psi_rev, Shoup quotients floor(psi_rev 2^32 / q), moduli) as 32-bit
    tensors on `device` (uint32 bits in int32), cached on the params."""
    def build():
        psi = params.np_psi_rev.astype(np.uint64)
        q = params.np_moduli.astype(np.uint64)
        shoup = (psi << np.uint64(32)) // q[:, None]
        return tuple(
            torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(device)
            for a in (psi, shoup, q)
        )

    return params._table(("radix_ntt", str(device)), build)


def check_shape(x: torch.Tensor, params) -> None:
    """Raise unless the kernel takes x: int64 [L, ..., n], contiguous, on a
    CUDA device, with the bounds stated in csrc/radix_ntt.cu."""
    if x.device.type != "cuda":
        raise ValueError(f"radix NTT kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"radix NTT kernel takes int64 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("radix NTT kernel takes a contiguous tensor")
    n = params.n
    if x.ndim < 2 or x.shape[0] != params.crt_depth or x.shape[-1] != n:
        raise ValueError(f"shape {tuple(x.shape)} is not [L={params.crt_depth}, ..., n={n}]")
    if not 2 * LANE <= n <= 16384:
        raise ValueError(f"radix NTT kernel bounds: 256 <= n <= 16384, got n={n}")
    if max(params.moduli) >= 1 << 31:
        raise ValueError("radix NTT kernel needs q < 2^31")
    if x.numel() // (params.crt_depth * n) >= 1 << 31:
        raise ValueError("batch too large for one launch")


def _launch(x: torch.Tensor, params, t_min: int, name: str) -> torch.Tensor:
    check_shape(x, params)
    out = torch.empty_like(x)
    L, n = params.crt_depth, params.n
    B = x.numel() // (L * n)
    if B == 0:
        return out
    psi, psi_shoup, q = _device_tables(params, x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), psi.data_ptr(), psi_shoup.data_ptr(),
                 q.data_ptr(), L, B, params.log_n, t_min, stream)
    if err != 0:
        raise RuntimeError(f"radix NTT kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def ntt_fwd_head(x: torch.Tensor, params) -> torch.Tensor:
    """Forward stages with pair distance t >= 128 (the TPU kernel's part).
    x: int64[L, ..., n], n > 128."""
    _head_n(x)
    if x.device.type == "cpu":
        return ntt_fwd_head_plain(x, params)
    return _launch(x, params, LANE, "head")


def ntt_fwd_hybrid(x: torch.Tensor, params) -> torch.Tensor:
    """Whole forward negacyclic NTT (bit-reversed EVAL output), equal to
    `ring.ntt.ntt_fwd`. x: int64[L, ..., n]."""
    if x.shape[-1] <= LANE:
        t = params.tables(x.device)
        return ntt.ntt_fwd(x, t.psi_rev, t.moduli)
    if x.device.type == "cpu":
        return ntt_fwd_hybrid_plain(x, params)
    return _launch(x, params, 1, "hybrid")
