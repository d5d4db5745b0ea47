"""Plain-gadget GSW over the full ring modulus Q (host + in-circuit decrypt).

Companion to the nested-RNS RingGSW: when a ciphertext is only decrypted
in-circuit (no homomorphic GSW ops — e.g. the DiamondIO mask channel and the
seed-ciphertext lift), the ciphertext can live directly over Z_Q with the
standard CRT gadget g (params.np_gadget_res). The decrypt combination
row . G^{-1}((0, Q/t)) is then a PUBLIC constant, so the in-circuit split
decrypt is just

    secret_dependent = (top constant) * (-k wire),   public_bottom = constant,

two gates and zero LUTs (the reference reaches the same structure through its
seed-ciphertext lift, diamond_io.rs:751-860).
"""

from __future__ import annotations

from ...ring.params import RingParams


def gadget_values(params: RingParams) -> list[int]:
    """g_t = b^j * e_t mod Q (tower-major), matching PolyMatrix.gadget_matrix."""
    k = params.modulus_digits
    out = []
    for t in range(k):
        out.append(params.reconstruct_coeff(params.np_gadget_res[t]))
    return out


def gadget_decompose_value(params: RingParams, value: int) -> list[int]:
    """d with sum_t g_t d_t == value (mod Q): per-tower base-2^b digits."""
    dpt = params.digits_per_tower
    masks = params.np_digit_masks
    out = []
    for q_t in params.moduli:
        r = value % q_t
        for j in range(dpt):
            out.append((r >> (j * params.base_bits)) & int(masks[j]))
    return out


def native_encrypt(params: RingParams, k_secret: int, m: int, rng,
                   plaintext_modulus: int, error_sigma: float = 0.0):
    """C = A + m*G in Z_Q^{2 x 2K}, A = [a ; k*a + e], key (-k, 1).

    NOTE: message scaling is separate — decrypt returns (Q/t)*m via the
    G^{-1}((0, Q/t)) combination.

    `rng` must be a CSPRNG (utils.rng.Drbg / random.SystemRandom): the
    a-values appear unmasked in the published ciphertext, so a recoverable
    generator state leaks the payload. Errors are drawn from
    the SAME rng so seeded runs reproduce."""
    q = params.modulus
    g = gadget_values(params)
    K = params.modulus_digits
    a = [rng.randrange(q) for _ in range(2 * K)]
    e = (
        [round(rng.gauss(0, error_sigma)) for _ in range(2 * K)]
        if error_sigma > 0
        else [0] * (2 * K)
    )
    row0 = list(a)
    row1 = [(k_secret * a[j] + e[j]) % q for j in range(2 * K)]
    for j in range(K):
        row0[j] = (row0[j] + m * g[j]) % q
        row1[K + j] = (row1[K + j] + m * g[j]) % q
    return [row0, row1]


def decrypt_constants(params: RingParams, native_ct, plaintext_modulus: int
                      ) -> tuple[int, int]:
    """(top, bottom) constants of the decrypt combination: the ciphertext is
    public, so row_i . G^{-1}((0, Q/t)) are plain integers.
    value = -k*top + bottom = (Q/t)*m + e.w."""
    q = params.modulus
    scaled = q // plaintext_modulus
    d = gadget_decompose_value(params, scaled)
    K = params.modulus_digits
    top = sum(native_ct[0][K + t] * d[t] for t in range(K)) % q
    bottom = sum(native_ct[1][K + t] * d[t] for t in range(K)) % q
    return top, bottom


def native_decrypt(params: RingParams, native_ct, k_secret: int,
                   plaintext_modulus: int) -> int:
    top, bottom = decrypt_constants(params, native_ct, plaintext_modulus)
    return (-k_secret * top + bottom) % params.modulus


# ------------------------------------------------- ternary ring-poly key


def native_encrypt_poly(params: RingParams, k_coeffs: list[int], m: int, rng,
                        plaintext_modulus: int, error_sigma: float = 0.0):
    """Plain-gadget GSW over R' = Z_Q[X']/(X'^ns + 1) with a RING-POLY key
    (-k, 1): C = [a ; k (x) a + e] + m*G, entries R' elements (coefficient
    lists). The Diamond unit-ciphertext channel with the reference's ternary
    poly payload (diamond_io.rs:278)."""
    from .packed_ring_gsw import ring_mul

    q = params.modulus
    n = len(k_coeffs)
    g = gadget_values(params)
    K = params.modulus_digits

    def rand_elem():
        return [rng.randrange(q) for _ in range(n)]

    def err_elem():
        if error_sigma <= 0:
            return [0] * n
        return [round(rng.gauss(0, error_sigma)) % q for _ in range(n)]

    a = [rand_elem() for _ in range(2 * K)]
    row0 = [list(v) for v in a]
    row1 = [
        [(x + e) % q for x, e in zip(ring_mul(k_coeffs, a[j], q), err_elem())]
        for j in range(2 * K)
    ]
    for j in range(K):
        row0[j] = [(v + (m * g[j] if i == 0 else 0)) % q for i, v in enumerate(row0[j])]
        row1[K + j] = [
            (v + (m * g[j] if i == 0 else 0)) % q for i, v in enumerate(row1[K + j])
        ]
    return [row0, row1]


def decrypt_constants_poly(params: RingParams, native_ct, plaintext_modulus: int
                           ) -> tuple[list[int], list[int]]:
    """(top, bottom) R' elements of the decrypt combination for a poly-key
    plain ciphertext: -k (x) top + bottom = (Q/t)*m + e.w over R'."""
    q = params.modulus
    scaled = q // plaintext_modulus
    d = gadget_decompose_value(params, scaled)
    K = params.modulus_digits
    n = len(native_ct[0][0])
    top = [0] * n
    bottom = [0] * n
    for t in range(K):
        top = [(x + native_ct[0][K + t][i] * d[t]) % q for i, x in enumerate(top)]
        bottom = [(x + native_ct[1][K + t][i] * d[t]) % q for i, x in enumerate(bottom)]
    return top, bottom


def native_decrypt_poly(params: RingParams, native_ct, k_coeffs: list[int],
                        plaintext_modulus: int) -> list[int]:
    from .packed_ring_gsw import ring_mul

    q = params.modulus
    top, bottom = decrypt_constants_poly(params, native_ct, plaintext_modulus)
    neg_k = [(-c) % q for c in k_coeffs]
    sd = ring_mul(neg_k, top, q)
    return [(s + b) % q for s, b in zip(sd, bottom)]
