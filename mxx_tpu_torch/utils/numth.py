"""Host-side number theory helpers (pure Python ints, exact).

A copy of `mxx_tpu/utils/numth.py`: that module is free of jax, but importing
anything under `mxx_tpu` runs `mxx_tpu/__init__.py`, which imports jax. Used
for parameter generation: CRT prime search, primitive roots of unity, modular
inverses, CRT reconstruction constants.
"""

from __future__ import annotations

import math

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(num: int) -> bool:
    """Deterministic Miller-Rabin for num < 3.3e24 (covers all 64-bit ints)."""
    if num < 2:
        return False
    for p in _MR_BASES:
        if num % p == 0:
            return num == p
    d = num - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, num)
        if x == 1 or x == num - 1:
            continue
        for _ in range(r - 1):
            x = x * x % num
            if x == num - 1:
                break
        else:
            return False
    return True


def gen_crt_moduli(ring_dimension: int, crt_depth: int, crt_bits: int) -> tuple[int, ...]:
    """Generate `crt_depth` distinct primes q with q = 1 (mod 2n), q < 2^crt_bits.

    Searches downward from 2^crt_bits so each prime has exactly `crt_bits` bits
    (matching the reference's convention that each tower modulus is a
    `crt_bits`-bit prime).
    """
    assert ring_dimension >= 1 and (ring_dimension & (ring_dimension - 1)) == 0
    assert 2 <= crt_bits <= 30, "crt_bits must be in [2, 30] for u32 Montgomery arithmetic"
    m = 2 * ring_dimension
    # Largest candidate == 1 mod 2n strictly below 2^crt_bits.
    cand = ((1 << crt_bits) - 2) // m * m + 1
    moduli: list[int] = []
    while len(moduli) < crt_depth:
        if cand < (1 << (crt_bits - 1)):
            raise ValueError(
                f"not enough {crt_bits}-bit primes = 1 mod {m} for depth {crt_depth}"
            )
        if is_prime(cand):
            moduli.append(cand)
        cand -= m
    return tuple(moduli)


def find_primitive_2n_root(q: int, n: int) -> int:
    """Find psi: a primitive 2n-th root of unity mod prime q (q = 1 mod 2n)."""
    m = 2 * n
    assert (q - 1) % m == 0
    e = (q - 1) // m
    g = 2
    while True:
        psi = pow(g, e, q)
        # psi has order dividing 2n; primitive iff psi^n == -1 (n a power of 2).
        if n == 1:
            if psi == q - 1:
                return psi
        elif pow(psi, n, q) == q - 1:
            return psi
        g += 1
        if g > 1 << 20:
            raise ValueError(f"no primitive 2n-th root found mod {q}")


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def modinv(a: int, q: int) -> int:
    return pow(a, -1, q)


def crt_reconstruct(residues: list[int], moduli: list[int]) -> int:
    """CRT-reconstruct an integer in [0, prod(moduli)) from its residues."""
    q = math.prod(moduli)
    acc = 0
    for r, qi in zip(residues, moduli):
        qh = q // qi
        acc += r * qh * modinv(qh % qi, qi)
    return acc % q
