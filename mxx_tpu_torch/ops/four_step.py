"""Four-step negacyclic NTT: host tables, the plain PyTorch version, and the
wrappers of the CUDA kernels in `csrc/four_step_ntt.cu`.

The port's counterpart of `mxx_tpu/ops/four_step_ntt.py` (tables) and
`mxx_tpu/ops/pallas_four_step.py` (the fused TPU kernels it replaces). With
n = n1 * n2 and a poly viewed as x[n2, n1] (x[i2, i1] = x_flat[i2 * n1 + i1]):

    forward  X = ((W2 @ x) * T) @ W1
    inverse  x = W2^-1 @ ((X @ W1^-1) * T^-1)

all mod q, where W2 has bit-reversed rows and W1 bit-reversed columns so that
X lands in the same bit-reversed EVAL order as ring/ntt.ntt_fwd.

The kernel computes the same function as butterflies (see the note in the
source): step a is the merged-twist negacyclic NTT of length n2 on each
column, T one product per element, step c the cyclic NTT of length n1 on
each row. `_kernel_tables` builds its twiddle tables with their Shoup
quotients; the dense plain version below is independent of them.

`four_step_ntt_fwd` / `four_step_ntt_inv` launch the kernel for a tensor on
a CUDA device and take the plain version for a tensor on the CPU; anything
the kernel does not take raises. Each launch is counted in the tracer's
`ntt.k1` (forward) or `ntt.k2` (inverse).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import tracing
from ..utils.numth import bit_reverse, find_primitive_2n_root
from . import cuda_build

R32 = 1 << 32
SOURCE = "four_step_ntt.cu"
# the shapes the kernel takes: n2 = 128, n1 = n / 128 for 2048 <= n <= 16384
KERNEL_N2 = 128
KERNEL_N1 = (16, 32, 64, 128)


# --------------------------------------------------------------- host tables


@functools.lru_cache(maxsize=None)
def _tables(params, n1: int):
    """Per-limb W2 [L, n2, n2], T_mont [L, n2, n1], W1 [L, n1, n1] (numpy
    uint32; T in Montgomery form), as `mxx_tpu/ops/four_step_ntt.py:_tables`."""
    n = params.n
    n2 = n // n1
    assert n1 * n2 == n and n1 & (n1 - 1) == 0 and n2 & (n2 - 1) == 0
    a_bits = n1.bit_length() - 1
    b_bits = n2.bit_length() - 1
    L = params.crt_depth
    w2 = np.empty((L, n2, n2), dtype=np.uint32)
    t_mont = np.empty((L, n2, n1), dtype=np.uint32)
    w1 = np.empty((L, n1, n1), dtype=np.uint32)
    for t, q in enumerate(params.moduli):
        psi = find_primitive_2n_root(q, n)
        om = psi * psi % q
        for r in range(n2):
            k2 = bit_reverse(r, b_bits)
            base = pow(psi, n1, q) * pow(om, n1 * k2, q) % q  # (psi om^{k2})^{n1}
            v = 1
            for i2 in range(n2):
                w2[t, r, i2] = v
                v = v * base % q
            tw = psi * pow(om, k2, q) % q  # psi om^{k2}
            u = 1
            for i1 in range(n1):
                t_mont[t, r, i1] = u * R32 % q
                u = u * tw % q
        for i1 in range(n1):
            for c in range(n1):
                k1 = bit_reverse(c, a_bits)
                w1[t, i1, c] = pow(om, n2 * i1 * k1 % n, q)
    return w2, t_mont, w1


def _mod_matinv(m: np.ndarray, q: int) -> np.ndarray:
    """Inverse of a square matrix over Z_q (q prime < 2^31): Gauss-Jordan
    elimination, vectorized over rows in int64 (products stay below 2^62)."""
    n = m.shape[0]
    a = np.concatenate([m.astype(np.int64) % q, np.eye(n, dtype=np.int64)], axis=1)
    for col in range(n):
        piv = col + int(np.flatnonzero(a[col:, col])[0])
        a[[col, piv]] = a[[piv, col]]
        a[col] = a[col] * pow(int(a[col, col]), -1, q) % q
        f = a[:, col].copy()
        f[col] = 0
        a = (a - f[:, None] * a[col][None, :]) % q
    return a[:, n:].astype(np.uint32)


def _pow_mod(x: np.ndarray, e: int, q: int) -> np.ndarray:
    """Elementwise x^e mod q (int64, q < 2^31)."""
    out = np.ones_like(x)
    base = x % q
    while e:
        if e & 1:
            out = out * base % q
        base = base * base % q
        e >>= 1
    return out


@functools.lru_cache(maxsize=None)
def _std_tables(params, n1: int, inverse: bool):
    """Standard-form (left, twiddle, right) int64 tables [L, ...]: (W2, T, W1)
    for the forward transform, (W2^-1, T^-1, W1^-1) for the inverse."""
    w2, t_mont, w1 = _tables(params, n1)
    left, twiddle, right = [], [], []
    for t, q in enumerate(params.moduli):
        t_std = t_mont[t].astype(np.int64) * pow(R32, -1, q) % q
        if inverse:
            left.append(_mod_matinv(w2[t], q).astype(np.int64))
            twiddle.append(_pow_mod(t_std, q - 2, q))
            right.append(_mod_matinv(w1[t], q).astype(np.int64))
        else:
            left.append(w2[t].astype(np.int64))
            twiddle.append(t_std)
            right.append(w1[t].astype(np.int64))
    return np.stack(left), np.stack(twiddle), np.stack(right)


def _device_tables(params, n1: int, inverse: bool, device: torch.device):
    """(left, twiddle, right, moduli) of the plain version as int64 tensors on
    `device`, cached on the params."""
    def build():
        arrays = _std_tables(params, n1, inverse) + (params.np_moduli,)
        return tuple(torch.from_numpy(a.astype(np.int64)).to(device) for a in arrays)

    return params._table(("four_step", n1, inverse, str(device)), build)


def _powers(base: int, count: int, q: int) -> np.ndarray:
    """base^k mod q for k < count, a power of two (int64, q < 2^31)."""
    out = np.ones(1, dtype=np.int64)
    step = base % q
    while out.size < count:
        out = np.concatenate([out, out * step % q])
        step = step * step % q
    return out


def _with_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """Pairs (w, floor(w 2^32 / q)) along a new last axis, uint32."""
    return np.stack([w, (w << 32) // q], axis=-1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _kernel_tables(params, n1: int, inverse: bool):
    """The kernel's tables, numpy uint32 [L, ..., 2] of (w, floor(w 2^32 / q)),
    with psi the limb's primitive 2n-th root (that of `_tables`):

    col [L, n2, 2]: psi^(n1 bitrev(k)) at k, the merged-twist table of the
        negacyclic length-n2 column transform (root psi^n1; entry 0 unused);
    twist [L, n, 2]: T[r][i1] = psi^((2 bitrev(r) + 1) i1) at r n1 + i1;
    row [L, n1/2, 2]: w^bitrev(i) with w = psi^(2 n2) and bitrev over
        log2(n1) - 1 bits, the twiddle of block i of every stage of the
        cyclic length-n1 row transform.

    The inverse tables hold the inverse powers, and twist holds n^-1 T^-1,
    so that the inverse needs no scaling pass."""
    n = params.n
    n2 = n // n1
    assert n1 * n2 == n and n1 >= 2 and n1 & (n1 - 1) == 0 and n2 & (n2 - 1) == 0
    a_bits = n1.bit_length() - 1
    b_bits = n2.bit_length() - 1
    sign = -1 if inverse else 1
    kb = np.array([bit_reverse(k, b_bits) for k in range(n2)], dtype=np.int64)
    rb = np.array([bit_reverse(i, a_bits - 1) for i in range(n1 // 2)], dtype=np.int64)
    col_e = sign * n1 * kb % (2 * n)
    row_e = sign * 2 * n2 * rb % (2 * n)
    twist_e = (sign * (2 * kb[:, None] + 1) * np.arange(n1)[None, :] % (2 * n)).reshape(-1)
    col, twist, row = [], [], []
    for q in params.moduli:
        pw = _powers(find_primitive_2n_root(q, n), 2 * n, q)
        t = pw[twist_e]
        if inverse:
            t = t * pow(n, -1, q) % q
        col.append(_with_shoup(pw[col_e], q))
        twist.append(_with_shoup(t, q))
        row.append(_with_shoup(pw[row_e], q))
    return np.stack(col), np.stack(twist), np.stack(row)


def _kernel_device_tables(params, n1: int, inverse: bool, device: torch.device):
    """(col, twist, row, moduli) of the kernel as 32-bit tensors on `device`
    (uint32 bits in int32), cached on the params."""
    def build():
        arrays = _kernel_tables(params, n1, inverse) + (params.np_moduli,)
        return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
                     for a in arrays)

    return params._table(("four_step_kernel", n1, inverse, str(device)), build)


# ------------------------------------------------------------ plain version


def _left(w, x, q):
    """out[l, b, r, c] = sum_k w[l, r, k] x[l, b, k, c] mod q."""
    acc = torch.zeros(x.shape[:2] + (w.shape[1], x.shape[3]), dtype=torch.int64, device=x.device)
    for k in range(w.shape[2]):
        acc = (acc + w[:, None, :, k, None] * x[:, :, k, None, :]) % q
    return acc


def _right(x, w, q):
    """out[l, b, r, c] = sum_k x[l, b, r, k] w[l, k, c] mod q."""
    acc = torch.zeros(x.shape[:3] + (w.shape[2],), dtype=torch.int64, device=x.device)
    for k in range(w.shape[1]):
        acc = (acc + x[:, :, :, k, None] * w[:, None, None, k, :]) % q
    return acc


def _plain(x: torch.Tensor, params, n1: int, inverse: bool) -> torch.Tensor:
    L, n = x.shape[0], x.shape[-1]
    n2 = n // n1
    left, twiddle, right, q = _device_tables(params, n1, inverse, x.device)
    q = q.view(L, 1, 1, 1)
    xs = x.reshape(L, -1, n2, n1)
    if inverse:
        out = _left(left, _right(xs, right, q) * twiddle[:, None] % q, q)
    else:
        out = _right(_left(left, xs, q) * twiddle[:, None] % q, right, q)
    return out.reshape(x.shape)


def four_step_ntt_fwd_plain(x: torch.Tensor, params, n1: int) -> torch.Tensor:
    """Plain PyTorch forward four-step NTT, on the kernel's layout."""
    return _plain(x, params, n1, inverse=False)


def four_step_ntt_inv_plain(x: torch.Tensor, params, n1: int) -> torch.Tensor:
    """Plain PyTorch inverse four-step NTT, on the kernel's layout."""
    return _plain(x, params, n1, inverse=True)


# ------------------------------------------------------------- CUDA kernels


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load(SOURCE)
    fn = lib.mxx_four_step_ntt
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load) the kernel library; seconds spent compiling."""
    _kernel()
    return cuda_build.build_seconds(SOURCE)


def check_shape(x: torch.Tensor, params, n1: int) -> None:
    """Raise unless the kernel takes x: int64 [L, ..., n], contiguous, on a
    CUDA device, with the bounds stated in csrc/four_step_ntt.cu."""
    if x.device.type != "cuda":
        raise ValueError(f"four-step kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"four-step kernel takes int64 residues, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("four-step kernel takes a contiguous tensor")
    n = params.n
    if x.ndim < 2 or x.shape[0] != params.crt_depth or x.shape[-1] != n:
        raise ValueError(f"shape {tuple(x.shape)} is not [L={params.crt_depth}, ..., n={n}]")
    if not (n1 in KERNEL_N1 and n1 * KERNEL_N2 == n):
        raise ValueError(f"four-step kernel bounds: n2 = n / n1 = {KERNEL_N2} and n1 in "
                         f"{KERNEL_N1}, got n1={n1}, n={n}")
    if max(params.moduli) >= 1 << 31:
        raise ValueError("four-step kernel needs q < 2^31")
    if x.numel() // (params.crt_depth * n) >= 1 << 31:
        raise ValueError("batch too large for one launch")


def _launch(x: torch.Tensor, params, n1: int, inverse: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return _plain(x, params, n1, inverse)
    check_shape(x, params, n1)
    out = torch.empty_like(x)
    L, n = params.crt_depth, params.n
    B = x.numel() // (L * n)
    if B == 0:
        return out
    if x.data_ptr() % 16:
        x = x.clone()  # the kernel reads 16 bytes at a time
    col, twist, row, q = _kernel_device_tables(params, n1, inverse, x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), col.data_ptr(), twist.data_ptr(),
                 row.data_ptr(), q.data_ptr(), L, B, n1, n // n1, int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"four-step NTT kernel launch failed: cudaError {err}")
    tracing.count("ntt.k2" if inverse else "ntt.k1")
    return out


def four_step_ntt_fwd(x: torch.Tensor, params, n1: int) -> torch.Tensor:
    """Forward negacyclic NTT (bit-reversed EVAL output). x: int64[L, ..., n]."""
    return _launch(x, params, n1, inverse=False)


def four_step_ntt_inv(x: torch.Tensor, params, n1: int) -> torch.Tensor:
    """Inverse negacyclic NTT (bit-reversed EVAL input -> natural coeffs)."""
    return _launch(x, params, n1, inverse=True)
