"""Plain PyTorch arithmetic of the DCRT ring Z_Q[X]/(X^n + 1), Q = prod q_t.

The yardstick's own ring: it imports nothing of the program. What it shares
with the program is the ring's definition, copied here and frozen:

- the moduli: the `crt_depth` largest primes q = 1 (mod 2n) below
  2^crt_bits, searched downward (upstream's convention);
- the evaluation ("EVAL") form: slot i of a polynomial holds its value at
  psi^(2 bitrev(i) + 1), psi the primitive 2n-th root of unity g^((q-1)/2n)
  for the least g >= 2 that gives one (the merged-twist negacyclic NTT of
  Longa and Naehrig 2016, natural-order coefficients to bit-reversed
  evaluations);
- the gadget: digit j of tower t has weight base^j on limb t and 0 on the
  other limbs (the CRT idempotent e_t is 1 mod q_t and 0 mod q_s).

Residues are int64 in [0, q) with q < 2^31, so a product of two is exact.
The transforms are the textbook radix-2 loops, one limb at a time so that
their temporaries stay small beside the tensors they judge.
"""

from __future__ import annotations

import math

import torch

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(num: int) -> bool:
    """Deterministic Miller-Rabin for num < 3.3e24."""
    if num < 2:
        return False
    for p in _MR_BASES:
        if num % p == 0:
            return num == p
    d, r = num - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, num)
        if x in (1, num - 1):
            continue
        for _ in range(r - 1):
            x = x * x % num
            if x == num - 1:
                break
        else:
            return False
    return True


def crt_moduli(n: int, depth: int, bits: int) -> tuple[int, ...]:
    """The `depth` largest primes q = 1 (mod 2n) below 2^bits, descending."""
    m = 2 * n
    cand = ((1 << bits) - 2) // m * m + 1
    out: list[int] = []
    while len(out) < depth:
        if cand < (1 << (bits - 1)):
            raise ValueError(f"not enough {bits}-bit primes = 1 mod {m}")
        if is_prime(cand):
            out.append(cand)
        cand -= m
    return tuple(out)


def primitive_2n_root(q: int, n: int) -> int:
    """g^((q-1)/2n) for the least g >= 2 for which it has order 2n."""
    e = (q - 1) // (2 * n)
    g = 2
    while True:
        psi = pow(g, e, q)
        if pow(psi, n, q) == q - 1:
            return psi
        g += 1


def _bitrev(n: int, device) -> torch.Tensor:
    bits = n.bit_length() - 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(bits):
        r |= ((i >> b) & 1) << (bits - 1 - b)
    return r


def _powers(base: list[int], q: torch.Tensor, n: int) -> torch.Tensor:
    """[L, n] table of base_t^i mod q_t, by doubling."""
    device = q.device
    pw = torch.ones((len(base), 1), dtype=torch.int64, device=device)
    step = torch.tensor(base, dtype=torch.int64, device=device)[:, None]
    while pw.shape[1] < n:
        pw = torch.cat([pw, pw * step % q[:, None]], dim=1)
        step = step * step % q[:, None]
    return pw


class Ring:
    """Tables and plain operations of one ring on one device."""

    def __init__(self, n: int, depth: int, crt_bits: int, base_bits: int, device):
        self.n, self.depth, self.crt_bits, self.base_bits = n, depth, crt_bits, base_bits
        self.device = torch.device(device)
        self.moduli = crt_moduli(n, depth, crt_bits)
        self.Q = math.prod(self.moduli)
        self.dpt = -(-crt_bits // base_bits)
        self.k = self.dpt * depth
        self.q = torch.tensor(self.moduli, dtype=torch.int64, device=self.device)
        psis = [primitive_2n_root(q, n) for q in self.moduli]
        rev = _bitrev(n, self.device)
        self.psi_rev = _powers(psis, self.q, n)[:, rev]
        self.psi_inv_rev = _powers([pow(p, -1, q) for p, q in zip(psis, self.moduli)],
                                   self.q, n)[:, rev]
        self.n_inv = [pow(n, -1, q) for q in self.moduli]

    def qb(self, ndim: int) -> torch.Tensor:
        """The moduli shaped [L, 1, ...] against a tensor of `ndim` dims."""
        return self.q.reshape((-1,) + (1,) * (ndim - 1))

    # ------------------------------------------------------------ transforms

    def _fwd_limb(self, a: torch.Tensor, t: int) -> torch.Tensor:
        q, n = self.moduli[t], self.n
        lead = a.shape[:-1]
        a = a.reshape(-1, n)
        m, h = 1, n
        while m < n:
            h //= 2
            v = a.reshape(-1, m, 2, h)
            w = self.psi_rev[t, m:2 * m].reshape(1, m, 1)
            u, x = v[:, :, 0], v[:, :, 1] * w % q
            a = torch.stack(((u + x) % q, (u - x) % q), dim=2).reshape(-1, n)
            m *= 2
        return a.reshape(lead + (n,))

    def _inv_limb(self, a: torch.Tensor, t: int) -> torch.Tensor:
        q, n = self.moduli[t], self.n
        lead = a.shape[:-1]
        a = a.reshape(-1, n)
        m, h = n, 1
        while m > 1:
            half = m // 2
            v = a.reshape(-1, half, 2, h)
            w = self.psi_inv_rev[t, half:m].reshape(1, half, 1)
            u, x = v[:, :, 0], v[:, :, 1]
            a = torch.stack(((u + x) % q, (u - x) * w % q), dim=2).reshape(-1, n)
            h *= 2
            m = half
        return (a * self.n_inv[t] % q).reshape(lead + (n,))

    def fwd(self, x: torch.Tensor) -> torch.Tensor:
        """COEFF [L, ..., n] -> EVAL."""
        return torch.stack([self._fwd_limb(x[t], t) for t in range(self.depth)])

    def inv(self, x: torch.Tensor) -> torch.Tensor:
        """EVAL [L, ..., n] -> COEFF."""
        return torch.stack([self._inv_limb(x[t], t) for t in range(self.depth)])

    # ------------------------------------------------------------ arithmetic

    def from_signed(self, v: torch.Tensor) -> torch.Tensor:
        """Small signed integers [..., n] -> residues [L, ..., n]."""
        return v.to(torch.int64)[None] % self.qb(v.dim() + 1)

    def from_ints(self, values: list[int]) -> torch.Tensor:
        """COEFF residues [L, n] of the polynomial with these coefficients."""
        out = torch.zeros((self.depth, self.n), dtype=torch.int64, device=self.device)
        for t, q in enumerate(self.moduli):
            out[t, : len(values)] = torch.tensor([v % q for v in values], dtype=torch.int64)
        return out

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """EVAL [L, r, k, n] @ [L, k, c, n] mod q, one contraction index at a
        time (each partial sum stays below q)."""
        L, r, k, n = a.shape
        qb = self.qb(4)
        acc = torch.zeros((L, r, b.shape[2], n), dtype=torch.int64, device=a.device)
        for j in range(k):
            acc = (acc + a[:, :, j, None, :] * b[:, None, j, :, :]) % qb
        return acc

    def gadget(self, d: int) -> torch.Tensor:
        """G = I_d tensor g in EVAL form [L, d, d k, n] (constant polys)."""
        g = torch.zeros((self.depth, d, d * self.k), dtype=torch.int64, device=self.device)
        for t, q in enumerate(self.moduli):
            for j in range(self.dpt):
                for i in range(d):
                    g[t, i, i * self.k + t * self.dpt + j] = pow(1 << self.base_bits, j, q)
        return g[..., None].expand(g.shape + (self.n,)).contiguous()

    def decompose(self, coeff: torch.Tensor) -> torch.Tensor:
        """G^{-1}: COEFF [L, r, c, n] -> COEFF digits [L, r k, c, n]; row
        i k + t dpt + j holds digit j (base 2^base_bits) of limb t's residue."""
        L, r, c, n = coeff.shape
        mask = (1 << self.base_bits) - 1
        rows = []
        for t in range(L):
            for j in range(self.dpt):
                rows.append((coeff[t] >> (j * self.base_bits)) & mask)
        dig = torch.stack(rows, dim=1)  # [r, k, c, n], each < 2^crt_bits
        return (dig[None] % self.qb(5)).reshape(L, r * self.k, c, n)

    def lift2(self, c0: torch.Tensor, c1: torch.Tensor) -> torch.Tensor:
        """Centered integers of absolute value below q0 q1 / 2 from their
        residues mod q0 and q1 (int64: q0 q1 < 2^62)."""
        q0, q1 = self.moduli[0], self.moduli[1]
        t = (c1 - c0 % q1) % q1 * pow(q0, -1, q1) % q1
        v = c0 + q0 * t
        return torch.where(v > q0 * q1 // 2, v - q0 * q1, v)
