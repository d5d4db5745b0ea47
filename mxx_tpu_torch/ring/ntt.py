"""Negacyclic NTT over CRT limbs (PyTorch; the CUDA four-step kernels in ops/).

The port's counterpart of `mxx_tpu/ring/ntt.py`. Merged-twist algorithm
(Longa-Naehrig 2016): the psi twist is folded into bit-reversed twiddle
tables, so the forward transform maps natural-order coefficients to
bit-reversed-order evaluations ("EVAL" format) and the inverse maps back;
pointwise products in EVAL realize negacyclic convolution.

Shapes: x is int64[L, ..., n]; twiddle tables are int64[L, n] in standard
form; per-limb constants are int64[L].

`ntt_inv_auto` routes as the JAX package does: a tensor on a CUDA device with
2048 <= n <= 16384 goes through the hand-written four-step kernel K2
(ops/four_step.py), everything else through the radix-2/4 chain here.
`ntt_fwd_auto` routes by `fwd_route`, a fixed rule over n: on a card, K1 (the
four-step forward kernel) for 2048 <= n <= 16384 as in the JAX package, and
the radix-2 kernel K3 (ops/hybrid_ntt.py) for 256 <= n < 2048 and
16384 < n <= 65536, where the JAX package runs the jnp chain; the chain
everywhere else and on the CPU. The JAX package's TPU has no kernel for those
n (its radix-2 head stops at t = 128 and the tail is jnp); on the card K3 runs
all log2(n) stages in one launch, where the chain launches a few dozen torch
operations per transform (PERF.md §6 gives the times). Every route computes
the same transform, bit for bit. A transform that goes through the chain is
counted in the tracer's `ntt.chain_fwd` or `ntt.chain_inv`; the kernels
count their own launches.
"""

from __future__ import annotations

import torch

from ..ops import four_step
from ..utils import tracing
from ..utils.u32 import addmod, mulmod, submod


def _bc(c: torch.Tensor, ndim: int, extra_dims: int = 0) -> torch.Tensor:
    """Broadcast per-limb const [L] against [L, ...] with `ndim`+extra dims."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1 + extra_dims))


def _fwd_stages(x, psi_rev, q):
    """Forward stage chain on [L, P, n]: radix-4 (two merged radix-2 levels
    per pass), with one leading radix-2 stage when log2(n) is odd."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nd = x.ndim
    L = x.shape[0]
    qb = _bc(q, nd, 1)
    m = 1

    def wslice(lo, hi, blocks):
        return psi_rev[:, lo:hi].reshape((L,) + (1,) * (nd - 2) + (blocks, 1))

    if (n.bit_length() - 1) % 2 == 1:
        t = n // 2
        v = x.reshape(lead + (1, 2, t))
        a = v[..., 0, :]
        b = v[..., 1, :]
        wb = mulmod(b, wslice(1, 2, 1), qb)
        x = torch.stack((addmod(a, wb, qb), submod(a, wb, qb)), dim=-2).reshape(lead + (n,))
        m = 2
    while m < n:
        t = n // (4 * m)
        v = x.reshape(lead + (m, 2, 2, t))
        a0 = v[..., 0, 0, :]
        a1 = v[..., 0, 1, :]
        b0 = v[..., 1, 0, :]
        b1 = v[..., 1, 1, :]
        w1 = wslice(m, 2 * m, m)  # psi[m+j], level-1 twiddle per block j
        w2 = psi_rev[:, 2 * m : 4 * m].reshape((L,) + (1,) * (nd - 2) + (m, 2, 1))
        w20 = w2[..., 0, :]  # psi[2m + 2j]
        w21 = w2[..., 1, :]  # psi[2m + 2j + 1]
        wb0 = mulmod(b0, w1, qb)
        wb1 = mulmod(b1, w1, qb)
        t0_ = addmod(a0, wb0, qb)
        t1_ = addmod(a1, wb1, qb)
        u0 = submod(a0, wb0, qb)
        u1 = submod(a1, wb1, qb)
        s1 = mulmod(t1_, w20, qb)
        s2 = mulmod(u1, w21, qb)
        x = torch.stack(
            (addmod(t0_, s1, qb), submod(t0_, s1, qb), addmod(u0, s2, qb), submod(u0, s2, qb)),
            dim=-2,
        ).reshape(lead + (n,))
        m *= 4
    return x


def _inv_stages(x, psi_inv_rev, n_inv, q):
    """Inverse stage chain on [L, P, n]: merged radix-4 Gentleman-Sande pairs,
    trailing radix-2 stage when log2(n) is odd."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nd = x.ndim
    L = x.shape[0]
    qb = _bc(q, nd, 1)
    t = 1
    m = n
    while m >= 4:
        h = m // 2
        h2 = m // 4
        v = x.reshape(lead + (h2, 2, 2, t))
        u0 = v[..., 0, 0, :]
        w0 = v[..., 0, 1, :]
        u1 = v[..., 1, 0, :]
        w1_ = v[..., 1, 1, :]
        tw1 = psi_inv_rev[:, h : 2 * h].reshape((L,) + (1,) * (nd - 2) + (h2, 2, 1))
        tw1e = tw1[..., 0, :]  # psi_inv[h + 2k]
        tw1o = tw1[..., 1, :]  # psi_inv[h + 2k + 1]
        tw2 = psi_inv_rev[:, h2 : 2 * h2].reshape((L,) + (1,) * (nd - 2) + (h2, 1))
        a_ = addmod(u0, w0, qb)
        b_ = mulmod(submod(u0, w0, qb), tw1e, qb)
        c_ = addmod(u1, w1_, qb)
        d_ = mulmod(submod(u1, w1_, qb), tw1o, qb)
        x = torch.stack(
            (
                torch.stack((addmod(a_, c_, qb), addmod(b_, d_, qb)), dim=-2),
                torch.stack(
                    (mulmod(submod(a_, c_, qb), tw2, qb), mulmod(submod(b_, d_, qb), tw2, qb)),
                    dim=-2,
                ),
            ),
            dim=-3,
        ).reshape(lead + (n,))
        t *= 4
        m = h2
    if m == 2:
        v = x.reshape(lead + (1, 2, t))
        u = v[..., 0, :]
        w_ = v[..., 1, :]
        tw = psi_inv_rev[:, 1:2].reshape((L,) + (1,) * (nd - 2) + (1, 1))
        x = torch.stack((addmod(u, w_, qb), mulmod(submod(u, w_, qb), tw, qb)), dim=-2).reshape(
            lead + (n,)
        )
    return mulmod(x, _bc(n_inv, nd), _bc(q, nd))


def _flat(stages, x, *tables):
    """Run a stage chain on [L, ..., n] flattened to [L, P, n]."""
    shape = x.shape
    out = stages(x.reshape(shape[0], -1, shape[-1]), *tables)
    return out.reshape(shape)


def ntt_fwd(x: torch.Tensor, psi_rev: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward negacyclic NTT along the last axis (natural -> bit-reversed)."""
    return _flat(_fwd_stages, x, psi_rev, q)


def ntt_inv(x: torch.Tensor, psi_inv_rev: torch.Tensor, n_inv: torch.Tensor,
            q: torch.Tensor) -> torch.Tensor:
    """Inverse negacyclic NTT along the last axis (bit-reversed -> natural)."""
    return _flat(_inv_stages, x, psi_inv_rev, n_inv, q)


def _fused_plan(x: torch.Tensor) -> int | None:
    """n1 for the four-step kernels, or None when the radix chain runs: the
    JAX package's plan (n2 = 128, for 2048 <= n <= 16384), keyed on the
    tensor's device instead of the JAX backend. The TPU's p_polys blocking
    has no counterpart: the CUDA kernel takes one poly per thread block."""
    if x.device.type != "cuda":
        return None
    n = x.shape[-1]
    if n < 2048 or n > 16384 or n & (n - 1):
        return None
    return n // four_step.KERNEL_N2


# ring degrees whose forward transforms go through K3 on a card: the rest of
# the radix-2 kernel's range 256 <= n <= 65536 goes through K1, which ran
# faster there on an H100 (PERF.md §6: K1 against K3 in turns at
# [10, 1000, 16384] and [8, 512, 8192], printed by chip_smoke.py)
K3_FWD_RANGES = ((256, 1024), (32768, 65536))


def fwd_route(device_type: str, n: int) -> str:
    """Which kernel takes a forward transform of ring degree n (a power of
    two) on a device of this type: "k1", "k3" or "chain"."""
    if device_type != "cuda":
        return "chain"
    if any(lo <= n <= hi for lo, hi in K3_FWD_RANGES):
        return "k3"
    if 2048 <= n <= 16384:
        return "k1"
    return "chain"


def ntt_fwd_auto(x: torch.Tensor, params) -> torch.Tensor:
    """Production forward NTT, routed by `fwd_route`. Every route is
    bit-exact."""
    route = fwd_route(x.device.type, x.shape[-1])
    if route == "k3":
        from ..ops import hybrid_ntt  # imports this module

        return hybrid_ntt.ntt_fwd_hybrid(x.contiguous(), params)
    if route == "k1":
        n1 = x.shape[-1] // four_step.KERNEL_N2
        return four_step.four_step_ntt_fwd(x.contiguous(), params, n1)
    tracing.count("ntt.chain_fwd")
    t = params.tables(x.device)
    return ntt_fwd(x, t.psi_rev, t.moduli)


def ntt_inv_auto(x: torch.Tensor, params) -> torch.Tensor:
    """Production inverse NTT: K2 on a card for 2048 <= n <= 16384, else the
    radix chain. Both are bit-exact."""
    n1 = _fused_plan(x)
    if n1 is not None:
        return four_step.four_step_ntt_inv(x.contiguous(), params, n1)
    tracing.count("ntt.chain_inv")
    t = params.tables(x.device)
    return ntt_inv(x, t.psi_inv_rev, t.n_inv, t.moduli)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact a*b mod q (elementwise, limb-leading)."""
    return mulmod(a, b, _bc(q, a.ndim))
