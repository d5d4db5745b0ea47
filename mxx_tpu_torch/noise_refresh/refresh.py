"""BGG-encoding noise refresh: trait surface + rounding/recompose math +
error-growth simulation.

A copy of `mxx_tpu/noise_refresh/refresh.py` (reference: src/noise_refresh/{mod.rs,naive_vec.rs,
simulation.rs}, SURVEY.md A.5). The offline path evaluates a material circuit
(Goldreich CBD PRG over RingGSW, decrypt, merge) over pubkey wires and emits
decoder targets ordered slot_idx * crt_depth + crt_idx; the online path
evaluates over encoding wires, subtracts the decoder outputs per CRT level,
rounds keeping `v_bits` low bits, and CRT-recomposes.

Scope: the `NoiseRefresher` protocol, the exact rounding/recompose helpers,
the error-growth simulation, and the concrete `DiamondNoiseRefresher`
(mask-decode-round-rebuild). The material circuits live next door:
`circuit_prg.py` (Goldreich PRG expansion over RingGSW), `circuit_decrypt.py`
(batched polynomial GSW decryption with monomial packing + centered mask
decode), `circuit_merge.py` (error+mask merge). The CRT-level-split
orchestrator over per-level wires is `NoiseRefresherNaiveVec` below. A
refresher works on the device of the public matrix `b0` it was given.
"""

from __future__ import annotations

import math
from decimal import Decimal

from ..bgg import BggEncoding, BggPublicKey
from ..matrix import PolyMatrix
from ..ring.poly import Poly
from ..sampler import FinRingDist, HashSampler
from ..simulator import SimulatorContext
from ..utils.numth import crt_reconstruct, modinv
from ..utils.rng import Drbg


class NoiseRefresher:
    """Offline/online split for refreshing one slotwise encoding wire
    (reference noise_refresh/mod.rs:28-73)."""

    def preprocess(self, refresh_id: bytes, one, refreshed_input, enc_seeds,
                   decryption_key, plt_evaluator, slot_transfer_evaluator):
        raise NotImplementedError

    def online_eval(self, refresh_id: bytes, one, refreshed_input, enc_seeds,
                    decryption_key, decoders, plt_evaluator, slot_transfer_evaluator):
        raise NotImplementedError


def round_keep_low_bits(value: int, modulus: int, v_bits: int) -> int:
    """Round a masked CRT-level term keeping v_bits of precision:
    round(value * 2^v_bits / modulus) (naive_vec.rs online rounding)."""
    scale = 1 << v_bits
    return (value * scale + modulus // 2) // modulus % scale


def crt_recompose(level_values: list[int], moduli: list[int]) -> int:
    """Recompose per-CRT-level rounded values into the refreshed plaintext."""
    return crt_reconstruct(level_values, list(moduli))


def simulate_noise_refresh_error_growth(
    ctx: SimulatorContext,
    input_error_norm: Decimal,
    v_bits: int,
    crt_depth: int,
    cbd_n: int,
    q_bits: int,
) -> Decimal:
    """Post-refresh error bound: rounding error (q / 2^v_bits scale) plus the
    CBD mask noise, per CRT level, recomposed (reference simulation.rs:127+).

    The refreshed error no longer depends on `input_error_norm` (that is the
    point of the refresh); the input only needs to satisfy the pre-rounding
    correctness bound, which the caller checks separately.
    """
    rounding_err = Decimal(2) ** (q_bits - v_bits)
    cbd_err = Decimal(cbd_n) * ctx.ring_dim_sqrt
    per_level = rounding_err + cbd_err
    return per_level * Decimal(crt_depth)


def pre_rounding_bound_holds(input_error_norm: Decimal, q_bits: int, v_bits: int) -> bool:
    """Input error must be below q / 2^{v_bits+1} for the rounding to be
    correct (reference aky24 simulation
    `max_noise_refresh_v_bits_without_pre_rounding_error`)."""
    return input_error_norm < Decimal(2) ** (q_bits - v_bits - 1)


class DiamondNoiseRefresher(NoiseRefresher):
    """Concrete mask-decode-round-rebuild refresher for absolute-channel BGG
    wires inside a Diamond-style context (state0 ~ [sigma, k] B0).

    The reference pipeline (naive_vec.rs) masks each CRT level with PRG
    material, decodes, rounds keeping v_bits, and rebuilds; this refresher
    realizes the same offline/online split with a uniform additive mask:

    offline (preprocess): for wire pubkey A_c and plaintext alignment
    Delta = 2^{q_bits - v_bits}: sample a Delta-aligned mask m, derive A_m,
    A_j from the hash, and store preimages for (i) the abs-channel mask
    encoding of m, (ii) abs-channel digit encodings of Delta * base^j, and
    (iii) the decoder target [(A_c + A_m) G^{-1}(e_0); 0].

    online: decode y = x + m + e_in from the masked wire, round to the Delta
    grid (killing e_in), and rebuild c' = sum_j d_j E_j - E_m — a fresh
    encoding of x whose error comes only from the stored preimages.
    Requires the payload k in {-1, +1} (invertible) as in DiamondIO.
    """

    def __init__(self, params, trap_sampler, b0, td0, hash_key: bytes, k_int: int,
                 v_bits: int, base_bits: int = 8, value_bits: int | None = None):
        assert k_int in (-1, 1), "payload k must be invertible"
        self.params = params
        self.trap = trap_sampler
        self.b0 = b0
        self.td0 = td0
        self.device = b0.data.device
        self.hash_key = hash_key
        self.k_inv = modinv(k_int % params.modulus, params.modulus)
        self.v_bits = v_bits
        self.digit_base_bits = base_bits
        # value_bits < modulus_bits refreshes a sub-range value (e.g. one CRT
        # residue in the NaiveVec per-level pipeline): the rounding grid then
        # covers [0, 2^value_bits) with v_bits precision.
        q_bits = value_bits if value_bits is not None else params.modulus_bits
        assert q_bits > v_bits
        self.delta = 1 << (q_bits - v_bits)
        self.value_range = 1 << q_bits
        self.num_digits = -(-v_bits // base_bits) + 1

    def _hash_pk(self, tag: str):
        m_g = self.params.modulus_digits
        return HashSampler(self.device).sample_hash(
            self.params, self.hash_key, tag, 1, m_g, FinRingDist()
        )

    def _abs_encoding_preimage(self, a_matrix, value: int):
        """Preimage P with state0 @ P = sigma*A - value*G (absolute channel):
        target [A; -G * (value * k^{-1})]."""
        params = self.params
        g = PolyMatrix.gadget_matrix(params, 1, self.device)
        w = value * self.k_inv % params.modulus
        bottom = -g.mul_poly_scalar(Poly.const(params, w, self.device))
        return self.trap.preimage(params, self.td0, self.b0, a_matrix.concat_rows([bottom]))

    def preprocess(self, refresh_id: bytes, a_c, rng=None):
        """Returns the refresh material dict (preimages + mask pubkeys).
        The mask value is secret material: default rng is a per-refresh-id
        deterministic DRBG (CSPRNG-backed when callers pass Drbg(None))."""
        params = self.params
        rng = rng or Drbg(b"noise_refresh" + refresh_id)
        q = params.modulus
        m_val = self.delta * rng.randrange(self.value_range // self.delta)
        a_m = self._hash_pk(f"nr_mask_{refresh_id.hex()}")
        digit_pks = [
            self._hash_pk(f"nr_digit_{refresh_id.hex()}_{j}") for j in range(self.num_digits)
        ]
        sel = PolyMatrix.identity(params, 1, device=self.device).slice_columns(0, 1)
        dec_target_top = (a_c + a_m).mul_decompose(sel)
        dec_target = dec_target_top.concat_rows(
            [PolyMatrix.zero(params, 1, dec_target_top.ncol, device=self.device)]
        )
        material = {
            "mask_value": m_val,
            "a_m": a_m,
            "digit_pks": digit_pks,
            "p_mask": self._abs_encoding_preimage(a_m, m_val),
            "p_digits": [
                self._abs_encoding_preimage(
                    digit_pks[j], self.delta * (1 << (self.digit_base_bits * j)) % q
                )
                for j in range(self.num_digits)
            ],
            "p_decoder": self.trap.preimage(params, self.td0, self.b0, dec_target),
        }
        return material

    def online_decode_round(self, state0, c_enc, material) -> int:
        """Decode the masked wire and round to the Delta grid; returns the
        rounded digit integer w (split out so vector pipelines can reuse
        it)."""
        params = self.params
        q = params.modulus
        e_m = BggEncoding(
            state0 @ material["p_mask"], BggPublicKey(material["a_m"], False), None
        )
        c_masked = c_enc + e_m
        sel = PolyMatrix.identity(params, 1, device=self.device).slice_columns(0, 1)
        proj = state0 @ material["p_decoder"]
        noisy = proj - c_masked.vector.mul_decompose(sel)
        y = noisy.entry(0, 0).coeffs()[0]
        # value + mask may wrap mod q in either direction (positive overflow,
        # or a negative decode error pushing y to ~q): round against all three
        # wrap branches and take the branch whose grid point is nearest AND
        # lands inside the value range.
        best = None
        for t in (-1, 0, 1):
            v = y + t * q
            w_t = (v + self.delta // 2) // self.delta
            if not (0 <= w_t * self.delta <= 2 * self.value_range):
                continue
            err = abs(v - self.delta * w_t)
            if best is None or err < best[0]:
                best = (err, w_t)
        assert best is not None, "decode far outside the value range"
        return best[1]

    def rebuild_from_digits(self, state0, w: int, material):
        """Fresh encoding of Delta*w - m from the stored digit preimages."""
        params = self.params
        base = 1 << self.digit_base_bits
        assert 0 <= w < base ** self.num_digits, (
            f"rounded digit {w} outside the grid: the input error exceeded "
            "the pre-rounding bound (see pre_rounding_bound_holds)"
        )
        acc = None
        for j in range(self.num_digits):
            d_j = (w >> (self.digit_base_bits * j)) & (base - 1)
            e_j = BggEncoding(
                state0 @ material["p_digits"][j],
                BggPublicKey(material["digit_pks"][j], False),
                None,
            )
            term = e_j.small_scalar_mul(params, [d_j])
            acc = term if acc is None else acc + term
        e_m = BggEncoding(
            state0 @ material["p_mask"], BggPublicKey(material["a_m"], False), None
        )
        return acc - e_m

    def online_eval(self, refresh_id: bytes, state0, c_enc, material):
        """Refresh the absolute-channel encoding `c_enc` (pubkey A_c): decode
        the masked wire, round to the Delta grid (killing the input error),
        rebuild from the stored digit preimages."""
        w = self.online_decode_round(state0, c_enc, material)
        return self.rebuild_from_digits(state0, w, material)


def twisted_residues(x: int, moduli: list[int]) -> list[int]:
    """y_i = [x * (Q/q_i)^{-1}]_{q_i}: the CRT-twisted residues satisfying
    x == sum_i y_i * (Q/q_i)  (mod Q) exactly — the per-level values the
    NaiveVec refresher carries (reference naive_vec.rs decoded refresh term
    ordering + crt_recompose_rows with reconst_coeffs)."""
    q_full = math.prod(moduli)
    return [
        (x % q_i) * modinv((q_full // q_i) % q_i, q_i) % q_i for q_i in moduli
    ]


class NoiseRefresherNaiveVec(NoiseRefresher):
    """CRT-level-split refresher over vector wires (reference
    noise_refresh/naive_vec.rs:437+): slot i carries the absolute-channel
    encoding of the twisted residue y_i = [x (Q/q_i)^{-1}]_{q_i}; every level
    refreshes independently on its own 2^ceil(log2 q_i) / 2^v_bits rounding
    grid (decoder artifacts ordered slot_idx * crt_depth + crt_idx), and the
    refreshed wires recompose into ONE fresh encoding of
    x_hat = sum_i y_hat_i (Q/q_i) = x + sum_i r_i (Q/q_i) (mod Q), with the
    per-level rounding residuals |r_i| <= Delta_i/2 — the q/2^v relative
    error the reference's simulation bounds (simulation.rs:127+)."""

    def __init__(self, params, trap_sampler, b0, td0, hash_key: bytes, k_int: int,
                 v_bits: int, base_bits: int = 8):
        self.params = params
        self.moduli = list(params.moduli)
        self.levels = [
            DiamondNoiseRefresher(
                params, trap_sampler, b0, td0,
                hash_key + bytes([i]), k_int, v_bits, base_bits,
                value_bits=q_i.bit_length(),
            )
            for i, q_i in enumerate(self.moduli)
        ]

    def encode_values(self, x: int) -> list[int]:
        return twisted_residues(x, self.moduli)

    def preprocess(self, refresh_id: bytes, a_c_list, rng=None):
        assert len(a_c_list) == len(self.levels)
        return [
            lvl.preprocess(refresh_id + bytes([i]), a_c, rng)
            for i, (lvl, a_c) in enumerate(zip(self.levels, a_c_list))
        ]

    def online_eval(self, refresh_id: bytes, state0, enc_list, materials):
        """Refresh every level wire and recompose. Returns
        (refreshed_levels, recomposed_encoding, x_hat)."""
        q = self.params.modulus
        refreshed = []
        x_hat = 0
        acc = None
        for lvl, enc, material, q_i in zip(self.levels, enc_list, materials, self.moduli):
            w = lvl.online_decode_round(state0, enc, material)
            fresh = lvl.rebuild_from_digits(state0, w, material)
            refreshed.append(fresh)
            y_hat = lvl.delta * w - material["mask_value"]
            coeff = q // q_i  # integer: product of the other moduli
            x_hat = (x_hat + y_hat * coeff) % q
            term = fresh.large_scalar_mul(self.params, [coeff])
            acc = term if acc is None else acc + term
        return refreshed, acc, x_hat
