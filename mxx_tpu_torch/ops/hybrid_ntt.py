"""Radix-2 forward negacyclic NTT: the plain PyTorch version, the launch plan
and twiddle table of the CUDA kernel in `csrc/radix_ntt.cu`, and its wrappers.

The port's counterpart of `mxx_tpu/ops/pallas_ntt.py`, whose TPU kernel runs
the merged-twist butterfly stages with pair distance t >= 128 (the "head")
and leaves the stages with t < 128 (the "tail") to jnp, because Mosaic cannot
reshape below the 128-wide lane dimension. The card has no such limit: one
kernel launch runs the stages down to a pair distance it is given.

- `ntt_fwd_head`: the TPU kernel's function, the stages with t >= 128, on
  int64[L, ..., n] for n > 128.
- `ntt_fwd_hybrid`: the whole forward transform, equal to
  `ring.ntt.ntt_fwd`; for n <= 128 it is the radix chain, as in the JAX
  package. `ring.ntt.ntt_fwd_auto` routes forward transforms on a card here
  for 256 <= n < 2048 and 16384 < n <= 65536.

Each launches the kernel for a tensor on a CUDA device (256 <= n <= 65536,
q < 2^31) and takes its plain version (`ntt_fwd_head_plain`,
`ntt_fwd_hybrid_plain`) for a tensor on the CPU; anything the kernel does not
take raises. Each launch is counted in the tracer's `ntt.k3_head` or
`ntt.k3_whole`.

`launch_plan` decides how the kernel runs a transform (stages per register
pass, polys per block iteration, the cluster for n > 2^14, shared-memory
bytes) and `twiddle_table` lays the twiddles out in the order the kernel's
threads read them. Both are host code that the CPU tests check:
`plan_accesses` restates the kernel's thread-to-coefficient map for the
bank-conflict check, and `emulate_kernel` runs the kernel's arithmetic (Shoup
products, the cluster's stages) over the table with numpy.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ring import ntt
from ..utils import tracing
from ..utils.u32 import addmod, submod
from . import cuda_build

LANE = 128
SOURCE = "radix_ntt.cu"
MIN_N, MAX_N = 256, 1 << 16
# csrc/radix_ntt.cu: threads of a block, stages a thread holds in registers
THREADS = 512
MAX_STAGES_PER_PASS = 5
# coefficients a block iteration transforms: polys of n < 2^14 go several at
# a time, and polys of n > 2^14 over a cluster of n / 2^14 blocks
BLOCK_COEFFS = 1 << 14
# twiddle table entries ahead of the passes', for the cluster's stages
EXCHANGE_SLOTS = 2
# the most dynamic shared memory an H100 block of csrc/radix_ntt.cu may have
# (227 KB, less its 16 bytes of static shared memory: the mbarrier)
SMEM_PER_BLOCK = 227 * 1024 - 16


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


# -------------------------------------------------------------- launch plan


def _log2(v: int) -> int:
    return v.bit_length() - 1


def _split_passes(stages: int) -> tuple[int, ...]:
    """Stages per register pass: at most 5 each, as few passes as can be, and
    the last pass 5 stages when there are 10 or more, so that every pass
    before it walks its groups 32 or more words apart (no bank conflicts)."""
    if stages <= MAX_STAGES_PER_PASS:
        return (stages,) if stages else ()
    if stages <= 2 * MAX_STAGES_PER_PASS:
        return (MAX_STAGES_PER_PASS, stages - MAX_STAGES_PER_PASS)
    if stages <= 3 * MAX_STAGES_PER_PASS:
        return (MAX_STAGES_PER_PASS, stages - 2 * MAX_STAGES_PER_PASS, MAX_STAGES_PER_PASS)
    raise ValueError(f"{stages} stages need more than 3 passes")


@dataclass(frozen=True)
class LaunchPlan:
    """How csrc/radix_ntt.cu runs the stages t >= t_min of one ring degree n:
    one block of THREADS threads per SM, BLOCK_COEFFS coefficients a block
    iteration (staged in as int64), the leading passes' twiddles in shared
    memory."""

    n: int
    t_min: int
    cluster: int  # blocks per poly (n / 16384 for n > 16384), each holding a part
    polys: int  # polys per block iteration
    passes: tuple[int, ...]  # stages per register pass of a block's part
    tw_entries: int  # entries of a rank's twiddle table
    tw_shared: int  # its leading entries held in shared memory (whole passes)
    smem_bytes: int  # dynamic shared memory of a block
    threads: int = THREADS

    @property
    def n_local(self) -> int:
        """Coefficients of a poly that one block holds."""
        return self.n // self.cluster

    @property
    def starts(self) -> tuple[int, ...]:
        """First stage of each pass, counted within a block's part (the
        cluster's stages come before them)."""
        out, j = [], 0
        for k in self.passes:
            out.append(j)
            j += k
        return tuple(out)

    @property
    def tw_offsets(self) -> tuple[int, ...]:
        """Where each pass's twiddles start in a rank's table (entries 0 and
        1 are the twiddles of the cluster's stages)."""
        out, off = [], EXCHANGE_SLOTS
        for j0, k in zip(self.starts, self.passes):
            out.append(off)
            off += ((1 << k) - 1) << j0
        return tuple(out)

    @property
    def packed_passes(self) -> int:
        return sum(k << (4 * i) for i, k in enumerate(self.passes))

    @property
    def data_bytes(self) -> int:
        """Shared memory of the poly rows (uint32 with one pad word per 32)
        and of the int64 staging buffer that the input lands in."""
        return 4 * self.polys * (self.n_local + self.n_local // 32) + 8 * BLOCK_COEFFS

    def units(self, L: int, B: int, sm_count: int) -> int:
        """Clusters of the persistent grid: one block per SM, at most one
        cluster per block iteration (the kernel lowers it to the clusters the
        card holds at once)."""
        iters = -(-B // self.polys)
        return max(1, min(L * iters, sm_count // self.cluster))


def launch_plan(n: int, t_min: int, q_max: int) -> LaunchPlan:
    """The plan of csrc/radix_ntt.cu for ring degree n, the stages with pair
    distance t >= t_min, and moduli up to q_max."""
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"radix NTT kernel bounds: {MIN_N} <= n <= {MAX_N}, got n={n}")
    cluster = max(1, n // BLOCK_COEFFS)
    if t_min < 1 or t_min & (t_min - 1) or t_min > n // max(2, cluster):
        raise ValueError(f"t_min must be a power of two up to n / max(2, cluster), got {t_min}")
    if q_max >= 1 << 31:
        raise ValueError("radix NTT kernel needs q < 2^31")
    n_local = n // cluster
    passes = _split_passes(_log2(n // t_min) - _log2(cluster))
    plan = LaunchPlan(n, t_min, cluster, BLOCK_COEFFS // n_local, passes, 0, 0, 0)
    shared = EXCHANGE_SLOTS  # whole passes, in order, while they fit
    for off, j0, k in zip(plan.tw_offsets, plan.starts, passes):
        end = off + (((1 << k) - 1) << j0)
        if plan.data_bytes + 8 * end > SMEM_PER_BLOCK:
            break
        shared = end
    entries = EXCHANGE_SLOTS + sum(((1 << k) - 1) << j0 for j0, k in zip(plan.starts, passes))
    return LaunchPlan(n, t_min, cluster, plan.polys, passes, entries, shared,
                      plan.data_bytes + 8 * shared)


def plan_accesses(plan: LaunchPlan, p: int) -> np.ndarray:
    """Shared-memory words that pass p of the plan touches, [tasks, 2^k]:
    row (task, r) is element r of the group of task `task`, as the kernel's
    `pass` computes it. Thread task mod THREADS takes the task, so a warp's
    accesses at one r are 32 consecutive rows of a column."""
    log_local = _log2(plan.n_local)
    j0, k = plan.starts[p], plan.passes[p]
    log_block = log_local - j0
    log_stride = log_block - k
    log_groups = log_local - k
    pitch = plan.n_local + plan.n_local // 32
    task = np.arange(plan.polys << log_groups)
    ps = task >> log_groups
    group = task & ((1 << log_groups) - 1)
    g = group >> log_stride
    p0 = (g << log_block) + (group & ((1 << log_stride) - 1))
    pos = p0[:, None] + (np.arange(1 << k) << log_stride)[None, :]
    return ps[:, None] * pitch + pos + (pos >> 5)


def _exchange_block(rank: int, c: int, cluster: int) -> int:
    """Block index, at stage c of the whole transform, of the coefficients
    that the pair of parts holding part `rank` mixes at that stage."""
    lo = rank & ~(cluster >> (c + 1))
    return lo >> (_log2(cluster) - c)


def twiddle_table(params, plan: LaunchPlan) -> np.ndarray:
    """uint32 [L, cluster, tw_entries, 2], C-contiguous: (w, floor(w 2^32 /
    q)) in the order the kernel reads them. For rank r of a cluster, entry c <
    log2(cluster) is the twiddle of stage c for r's pair of parts
    (psi_rev[2^c + block]; unused entries hold psi_rev[1]); pass p's
    twiddles start at plan.tw_offsets[p], stage l's block kb of group-block g
    at ((2^l - 1 + kb) 2^j0 + g), where the group-blocks of rank r are the
    blocks r 2^j0 + g of the whole transform's stage j0 + log2(cluster)."""
    psi = params.np_psi_rev.astype(np.uint64)
    q = params.np_moduli.astype(np.uint64)
    shoup = (psi << np.uint64(32)) // q[:, None]
    log_c = _log2(plan.cluster)
    idx = np.ones((plan.cluster, plan.tw_entries), dtype=np.int64)
    for rank in range(plan.cluster):
        for c in range(log_c):
            idx[rank, c] = (1 << c) + _exchange_block(rank, c, plan.cluster)
        for off, j0, k in zip(plan.tw_offsets, plan.starts, plan.passes):
            nblk = 1 << j0
            g = rank * nblk + np.arange(nblk)
            for l in range(k):
                kb = np.arange(1 << l)[:, None]
                i = (1 << (j0 + log_c + l)) + (g[None, :] << l) + kb
                lo = off + ((1 << l) - 1) * nblk
                idx[rank, lo : lo + i.size] = i.reshape(-1)
    return np.ascontiguousarray(np.stack((psi[:, idx], shoup[:, idx]), axis=-1), dtype=np.uint32)


def emulate_kernel(x: np.ndarray, params, plan: LaunchPlan) -> np.ndarray:
    """The kernel's arithmetic over `twiddle_table` in numpy (uint32 wrap,
    Shoup products, the cluster's stages across parts), on residues [L, B, n];
    the thread mapping is `plan_accesses`'s."""
    m32 = np.uint64(0xFFFFFFFF)
    table = twiddle_table(params, plan).astype(np.uint64)
    L, B, n = x.shape
    out = np.empty((L, B, n), dtype=np.uint64)

    def butterfly(a, b, w, wq, q):
        t = (b * w - ((b * wq) >> np.uint64(32)) * q) & m32
        t = np.minimum(t, (t - q) & m32)
        s, d = (a + t) & m32, (a - t) & m32
        return np.minimum(s, (s - q) & m32), np.minimum(d, (d + q) & m32)

    log_local = _log2(plan.n_local)
    for limb in range(L):
        q = np.uint64(params.moduli[limb])
        v = x[limb].astype(np.uint64)
        for c in range(_log2(plan.cluster)):
            span = plan.cluster >> (c + 1)
            parts = v.reshape(B, plan.cluster, plan.n_local).copy()
            for lo in (r for r in range(plan.cluster) if not r & span):
                w = table[limb, lo, c]
                parts[:, lo], parts[:, lo + span] = butterfly(
                    parts[:, lo], parts[:, lo + span], w[0], w[1], q)
            v = parts.reshape(B, n)
        for rank in range(plan.cluster):
            part = v[:, rank * plan.n_local : (rank + 1) * plan.n_local]
            tw = table[limb, rank]
            for off, j0, k in zip(plan.tw_offsets, plan.starts, plan.passes):
                nblk, log_stride = 1 << j0, log_local - j0 - k
                for l in range(k):
                    half = (1 << k) >> (l + 1)
                    lo = off + ((1 << l) - 1) * nblk
                    ent = tw[lo : lo + (nblk << l)].reshape(1 << l, nblk, 2).transpose(1, 0, 2)
                    view = part.reshape(B, nblk, 1 << l, 2, half, 1 << log_stride)
                    w = ent[None, :, :, None, None, :]
                    a, b = butterfly(view[:, :, :, 0], view[:, :, :, 1], w[..., 0], w[..., 1], q)
                    part = np.stack((a, b), axis=3).reshape(B, plan.n_local)
            out[limb, :, rank * plan.n_local : (rank + 1) * plan.n_local] = part
    return out.astype(np.int64)


# -------------------------------------------------------------- CUDA kernel


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = cuda_build.load(SOURCE)
    fn = lib.mxx_radix_ntt_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> float:
    """Build (or load) the kernel library; seconds spent compiling."""
    _kernel()
    return cuda_build.build_seconds(SOURCE)


def _device_moduli(params, device: torch.device) -> torch.Tensor:
    """The moduli as uint32 [L] on `device` (uint32 bits in int32), cached on
    the params."""
    return params._table(("radix_ntt_q", str(device)), lambda: torch.from_numpy(
        params.np_moduli.astype(np.uint32).view(np.int32)).to(device))


def _device_twiddles(params, plan: LaunchPlan, device: torch.device) -> torch.Tensor:
    """`twiddle_table` on `device` (uint32 bits in int32), cached on the params."""
    key = ("radix_ntt_tw", plan.t_min, plan.cluster, plan.passes, str(device))
    return params._table(key, lambda: torch.from_numpy(
        twiddle_table(params, plan).view(np.int32)).to(device))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_shape(x: torch.Tensor, params) -> None:
    """Raise unless the kernel takes x: int64 [L, ..., n], contiguous and
    16-byte aligned, on a CUDA device, with the bounds stated in
    csrc/radix_ntt.cu."""
    if x.device.type != "cuda":
        raise ValueError(f"radix NTT kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"radix NTT kernel takes int64 residues, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("radix NTT kernel takes a contiguous, 16-byte aligned tensor")
    n = params.n
    if x.ndim < 2 or x.shape[0] != params.crt_depth or x.shape[-1] != n:
        raise ValueError(f"shape {tuple(x.shape)} is not [L={params.crt_depth}, ..., n={n}]")
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f"radix NTT kernel bounds: {MIN_N} <= n <= {MAX_N}, got n={n}")
    if max(params.moduli) >= 1 << 31:
        raise ValueError("radix NTT kernel needs q < 2^31")
    if x.numel() // (params.crt_depth * n) >= 1 << 31:
        raise ValueError("batch too large for one launch")


def _launch(x: torch.Tensor, params, t_min: int, counter: str) -> torch.Tensor:
    check_shape(x, params)
    out = torch.empty_like(x)
    L, n = params.crt_depth, params.n
    B = x.numel() // (L * n)
    if B == 0:
        return out
    plan = launch_plan(n, t_min, max(params.moduli))
    tw = _device_twiddles(params, plan, x.device)
    q = _device_moduli(params, x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(), q.data_ptr(), L, B,
                 params.log_n, t_min, plan.cluster, plan.polys, plan.packed_passes,
                 plan.tw_entries, plan.tw_shared, plan.smem_bytes,
                 plan.units(L, B, _sm_count(x.device)), stream)
    if err != 0:
        raise RuntimeError(f"radix NTT kernel launch failed: cudaError {err}")
    tracing.count(counter)
    return out


def ntt_fwd_head(x: torch.Tensor, params) -> torch.Tensor:
    """Forward stages with pair distance t >= 128 (the TPU kernel's part).
    x: int64[L, ..., n], n > 128."""
    _head_n(x)
    if x.device.type == "cpu":
        return ntt_fwd_head_plain(x, params)
    return _launch(x, params, LANE, "ntt.k3_head")


def ntt_fwd_hybrid(x: torch.Tensor, params) -> torch.Tensor:
    """Whole forward negacyclic NTT (bit-reversed EVAL output), equal to
    `ring.ntt.ntt_fwd`. x: int64[L, ..., n]."""
    if x.shape[-1] <= LANE:
        t = params.tables(x.device)
        return ntt.ntt_fwd(x, t.psi_rev, t.moduli)
    if x.device.type == "cpu":
        return ntt_fwd_hybrid_plain(x, params)
    return _launch(x, params, 1, "ntt.k3_whole")
