"""Reference-faithful BGG-wire noise refresh: subtract -> round -> recompose.

The port's counterpart of `mxx_tpu/noise_refresh/naive_vec.py` (reference:
src/noise_refresh/naive_vec.rs (preprocess_many
:840, online_eval_many :1077, preprocess_from_decoded :1539,
crt_recompose_rows :2086). The mechanism, per refreshed relative-channel wire
c = s A - x (s G) + e and per CRT level i with qhat_i = q / q_i:

    L_i = c . G^{-1}(qhat_i G) + M_i - c_one . G^{-1}(qhat_i A') - D_i

where M_i is the decoded refresh-material term (Ring-GSW mask + error
ciphertexts decrypted IN-CIRCUIT with the k wire; the error ciphertexts
decrypt with plaintext modulus q_i so their value rides the qhat_i scale and
SURVIVES the rounding as the fresh error, while the v_bits mask values sit
below the rounding threshold and flood the discarded bits), and D_i is the
stored decoder s T_i with

    T_i = A . G^{-1}(qhat_i G) + A_{M_i} - A_one . G^{-1}(qhat_i A').

Expanding, L_i = qhat_i * [ s(A' - xG) + eps*s ] + (mask + e_small), so
round(L_i * q_i / q) mod q_i recovers the SAME value s(A' - xG) + eps*s at
every level, and the reconst-coefficient CRT recomposition emits a fresh
encoding of x under the hash-derived pubkey A' whose error is exactly the
PRG-derived eps (input error e is rounded away).

Repo specialization (documented deviations from the reference):
- Wires are scalar BggPublicKey/BggEncoding (the reference's
  NaiveBGG*Vec with num_slots = ring_dim is a slotwise duplication of the
  same scalar pipeline; the vec wrappers in bgg/vec.py lift this refresher
  slot-by-slot).
- secret_size d = 1 (the reference's DIAMOND_SECRET_SIZE constant).
- Material ciphertexts come from a pluggable provider: the real mode
  evaluates the Goldreich CBD PRG over Ring-GSW in-circuit
  (circuit_prg.build_noise_refresh_prg_material); the replay mode lifts
  recorded native ciphertext values as constant wires (the reference's
  debug_encrypt_random_prg_wires / debug_reuse_single_material test modes,
  naive_vec.rs:903-977) — value-preservation then still holds because the
  replayed ciphertexts are valid encryptions.

The circuits are host code copied from the JAX package (constants are host
integers, `PolyCircuit.const_coeffs`). The refresher's matrices live on its
`device`; every circuit evaluation goes through the level-batched evaluator
(the JAX package evaluates the packed decrypt circuit gate by gate; the
results are the same bits), and the rounding of `online_eval_from_decoded`
is `PolyMatrix.modulus_switch` on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bgg import BggEncoding, BggPublicKey
from ..circuit import PolyCircuit
from ..bgg.lift import lift_constants_batched
from ..gadgets.arith.nested_rns import encode_nested_rns_value
from ..gadgets.fhe.ring_gsw import RingGswCiphertext
from ..matrix import PolyMatrix, rows
from ..ops.elementwise import ew_add, ew_sub
from ..ring.poly import COEFF
from ..sampler import FinRingDist, HashSampler
from ..utils.tracing import span
from .circuit_decrypt import (
    decrypt_centered_bit_decomposed_polynomial,
    decrypt_error_coefficients_as_polynomial,
)
from ..decoder.mask_circuit import mask_plaintext_moduli_from_full_modulus


def build_refreshed_wire_digit_all_crt_decrypt(ring_gsw_ctx, v_bits: int,
                                               n_coeffs: int | None = None,
                                               mask_levels: int | None = None
                                               ) -> PolyCircuit:
    """All-CRT decrypt circuit for one gadget digit of one refreshed wire
    (reference circuit_decrypt.rs build_refreshed_wire_digit_all_crt_decrypt).

    Inputs: n_coeffs error ciphertexts, then mask_levels * n_coeffs * v_bits
    mask ciphertexts, then the decryption-key wire. Outputs: per CRT level,
    ONE merged wire (decoded_error + decoded_mask) — the reference emits the
    pair and merges in circuit_merge; merging here inline saves wires.
    Error decryption uses plaintext modulus q_i, so the decoded error value
    is (q/q_i)-scaled — the property the rounding relies on.

    n_coeffs defaults to ring_dim (full coefficient masking); mask_levels
    defaults to crt_depth (independent masks per level). mask_levels=1 is the
    reference's debug_reuse_single_material shape: the same mask ciphertexts
    feed every level (hiding weakens, correctness unaffected)."""
    assert v_bits > 0
    circuit = ring_gsw_ctx.fresh_circuit()
    params = ring_gsw_ctx.params
    n_coeffs = params.n if n_coeffs is None else n_coeffs
    crt_depth = params.crt_depth
    mask_levels = crt_depth if mask_levels is None else mask_levels
    moduli = params.moduli
    mask_chunk = n_coeffs * v_bits
    mask_moduli = mask_plaintext_moduli_from_full_modulus(ring_gsw_ctx.q_big, v_bits)

    errors = [RingGswCiphertext.input(ring_gsw_ctx, circuit) for _ in range(n_coeffs)]
    masks = [
        RingGswCiphertext.input(ring_gsw_ctx, circuit)
        for _ in range(mask_levels * mask_chunk)
    ]
    key = circuit.input(1)[0]

    dec_masks: dict[int, int] = {}

    def mask_wire(mask_lvl: int) -> int:
        if mask_lvl not in dec_masks:
            chunk = masks[mask_lvl * mask_chunk : (mask_lvl + 1) * mask_chunk]
            dec_masks[mask_lvl] = decrypt_centered_bit_decomposed_polynomial(
                circuit, chunk, key, mask_moduli
            )
        return dec_masks[mask_lvl]

    outputs = []
    for crt_idx in range(crt_depth):
        dec_err = decrypt_error_coefficients_as_polynomial(
            circuit, errors, key, int(moduli[crt_idx])
        )
        outputs.append(
            circuit.add_gate(dec_err, mask_wire(min(crt_idx, mask_levels - 1)))
        )
    circuit.output(outputs)
    return circuit


@dataclass
class RefreshMaterialCts:
    """Native Ring-GSW material ciphertexts for one refreshed wire, per
    gadget digit: errors[digit][ring_dim], masks[digit][crt * ring_dim * v]."""

    errors: list[list]
    masks: list[list]


class NoiseRefresherNaiveVec:
    """Subtract-round-recompose refresher over scalar BGG wires."""

    def __init__(self, params, ring_gsw_ctx, v_bits: int, hash_key: bytes,
                 secret_size: int = 1, device="cuda"):
        self.params = params
        self.ring_gsw = ring_gsw_ctx
        self.v_bits = v_bits
        self.d = secret_size
        self.hash_key = hash_key
        self.device = torch.device(device)
        self._hash = HashSampler(self.device)
        self._decrypt_circuits: dict[tuple[int, int], PolyCircuit] = {}

    def _decrypt_circuit(self, n_errors: int, n_masks: int) -> PolyCircuit:
        """Decrypt circuit cached per material shape (n error cts, total mask
        cts for one digit)."""
        mask_chunk = n_errors * self.v_bits
        mask_levels = max(1, n_masks // mask_chunk)
        assert mask_levels * mask_chunk == n_masks, (n_errors, n_masks, self.v_bits)
        key = (n_errors, n_masks)
        if key not in self._decrypt_circuits:
            self._decrypt_circuits[key] = build_refreshed_wire_digit_all_crt_decrypt(
                self.ring_gsw, self.v_bits, n_coeffs=n_errors, mask_levels=mask_levels
            )
        return self._decrypt_circuits[key]

    # ------------------------------------------------------------- helpers

    def _a_prime(self, refresh_id: bytes) -> PolyMatrix:
        return rows.unstack(self.params, self.a_prime_rows([refresh_id]))[0]

    def material_wire_values(self, material: RefreshMaterialCts) -> list[list[int]]:
        """Flatten native material cts to per-digit constant wire values for
        the decrypt circuit (errors then masks, circuit input order)."""

        def ct_values(ct):
            vals = []
            for row in ct:
                for v in row:
                    for lvl in encode_nested_rns_value(
                        self.ring_gsw.nested, v % self.ring_gsw.q_big
                    ):
                        vals.extend(lvl)
            return vals

        out = []
        for digit_idx in range(len(material.errors)):
            vals: list[int] = []
            for ct in material.errors[digit_idx]:
                vals.extend(ct_values(ct))
            for ct in material.masks[digit_idx]:
                vals.extend(ct_values(ct))
            out.append(vals)
        return out

    def _lift(self, one_wire, values: list[int]):
        """Lift constant values onto BGG wires via the one wire, batched
        (the reference's ciphertext_inputs_from_native lift)."""
        return lift_constants_batched(self.params, one_wire, values)

    def _decoded_wires(self, one_wire, k_wire, material, material_values,
                       plt_evaluator, context: str = ""):
        """Evaluate the all-CRT decrypt circuit per digit; returns
        decoded[digit][crt] wires. Each digit's eval gets its own LUT
        namespace: the circuit is shape-cached (same gate ids) but the lifted
        material values — hence the input PUBKEYS — differ per digit, so a
        storage-backed evaluator must not collide their K_high records."""
        from ..lookup.lwe import set_plt_context

        decoded = []
        for digit_idx, vals in enumerate(material_values):
            circuit = self._decrypt_circuit(
                len(material.errors[digit_idx]), len(material.masks[digit_idx])
            )
            inputs = self._lift(one_wire, vals) + [k_wire]
            set_plt_context(plt_evaluator, f"{context}.dec_d{digit_idx}")
            outs = circuit.eval(
                self.params, one_wire, inputs, plt_evaluator=plt_evaluator,
                batched=True,
            )
            decoded.append(outs)
        set_plt_context(plt_evaluator, context)
        return decoded

    def _term_matrix(self, decoded_digit_crt, crt_idx: int, extract) -> PolyMatrix:
        """Refresh-term matrix for one CRT level: per gadget digit j, select
        the decoded wire's value column (unit-column matrix_mul) and embed it
        at column j (reference embed_projected_digit_matrix)."""
        params = self.params
        m_g = self.d * params.modulus_digits
        # value-channel selector: G^{-1}(e_1 column) extracts the payload that
        # rides the first coordinate (k*e_1 semantics at d > 1)
        unit = PolyMatrix.identity(params, self.d, device=self.device).slice_columns(0, 1)
        cols = [None] * m_g
        zero = None
        for digit_idx, per_crt in enumerate(decoded_digit_crt):
            wire = per_crt[crt_idx]
            sel = extract(wire.matrix_mul(params, unit))  # (d or 1) x 1
            cols[digit_idx] = sel
            if zero is None:
                zero = PolyMatrix.zero(params, sel.nrow, 1, device=self.device)
        if zero is None:
            zero = PolyMatrix.zero(params, 1, 1, device=self.device)
        cols = [c if c is not None else zero for c in cols]
        return cols[0].concat_columns(cols[1:])

    # ------------------------------------------- shared decoded refresh terms

    def decoded_terms(self, one_wire, k_wire, material: RefreshMaterialCts,
                      plt_evaluator, extract, context: str = "") -> list[PolyMatrix]:
        """Per-CRT refresh-term matrices from replayed native material cts,
        computed ONCE and shared by every wire refreshed in the same batch
        (reference preprocess_many/decoded_refresh_terms_public,
        naive_vec.rs:1041-1075 — round 2 recomputed these per wire)."""
        vals = self.material_wire_values(material)
        decoded = self._decoded_wires(
            one_wire, k_wire, material, vals, plt_evaluator, context
        )
        return [
            self._term_matrix(decoded, crt_idx, extract)
            for crt_idx in range(self.params.crt_depth)
        ]

    def decoded_terms_prg(self, one_wire, k_wire, seed_ct_wires: list,
                          graph_seed: bytes, cbd_n: int, plt_evaluator,
                          extract, slot_transfer_evaluator=None,
                          context: str = "") -> list[PolyMatrix]:
        """REAL-mode refresh terms: ONE circuit expands the encrypted PRG seed
        into per-digit CBD error + mask ciphertexts (ranged Goldreich streams,
        circuit_prg.build_ranged_prg_material_digit), decrypts them with the
        key wire, and outputs decoded[digit][crt] — evaluated over the caller's
        BGG wires with NO host randomness (reference material_circuit,
        naive_vec.rs:1780-1936 + preprocess_many:1009-1040)."""
        params = self.params
        ctx = self.ring_gsw
        probe = RingGswCiphertext.input(ctx, ctx.fresh_circuit())
        wpc = len(probe.flatten())
        assert len(seed_ct_wires) % wpc == 0, (len(seed_ct_wires), wpc)
        seed_bits = len(seed_ct_wires) // wpc
        with span("noise_refresh.prg_material_build"):
            circuit = self._prg_material_circuit(graph_seed, seed_bits, cbd_n)
        crt_depth = params.crt_depth
        digits = params.modulus_digits
        from ..lookup.lwe import set_plt_context

        set_plt_context(plt_evaluator, f"{context}.prg_material")
        with span("noise_refresh.prg_material_circuit", gates=circuit.num_gates()):
            results = circuit.eval(
                params, one_wire, list(seed_ct_wires) + [k_wire],
                plt_evaluator=plt_evaluator,
                slot_transfer_evaluator=slot_transfer_evaluator,
                batched=True,
            )
        set_plt_context(plt_evaluator, context)
        decoded = [
            results[d * crt_depth : (d + 1) * crt_depth] for d in range(digits)
        ]
        return [
            self._term_matrix(decoded, crt_idx, extract)
            for crt_idx in range(crt_depth)
        ]

    def _prg_material_circuit(self, graph_seed: bytes, seed_bits: int, cbd_n: int
                              ) -> PolyCircuit:
        """The real-mode material circuit of `decoded_terms_prg`: inputs the
        seed ciphertexts' wires and the key wire, outputs decoded[digit][crt]."""
        from .circuit_prg import build_ranged_prg_material_digit
        from .circuit_decrypt import (
            decrypt_centered_bit_decomposed_polynomial as _dec_mask,
            decrypt_error_coefficients_as_polynomial as _dec_err,
        )

        params = self.params
        ctx = self.ring_gsw
        circuit = ctx.fresh_circuit()
        # canonical=False: the seed wires are round outputs / refreshed wires
        seeds = [
            RingGswCiphertext.input(ctx, circuit, canonical=False)
            for _ in range(seed_bits)
        ]
        key = circuit.input(1)[0]
        digits = params.modulus_digits
        crt_depth = params.crt_depth
        mask_moduli = mask_plaintext_moduli_from_full_modulus(ctx.q_big, self.v_bits)
        outputs = []
        for digit_idx in range(digits):
            errors, masks_by_crt = build_ranged_prg_material_digit(
                circuit, seeds, graph_seed, digit_idx, params.n, digits,
                crt_depth, self.v_bits, cbd_n,
            )
            for crt_idx, q_i in enumerate(params.moduli):
                dec_err = _dec_err(circuit, errors, key, int(q_i))
                dec_mask = _dec_mask(circuit, masks_by_crt[crt_idx], key, mask_moduli)
                outputs.append(circuit.add_gate(dec_err, dec_mask))
        circuit.output(outputs)
        return circuit

    # ---------------------------------------- packed-payload refresh terms

    def _packed_decrypt_circuit(self, n_digits: int, masks_per_digit: int,
                                num_slots: int) -> PolyCircuit:
        """All-digit all-CRT decrypt circuit for PACKED refresh material: per
        gadget digit, ONE packed error ciphertext (its R' message carries one
        CBD value per payload coefficient) and `mask_levels * v_bits` packed
        mask ciphertexts (one bit PER COEFFICIENT each). Decryption rides the
        subring embedding phi (decrypt_embedded): the output wire directly
        carries the phi-embedded material polynomial — the reference's
        `collapse_slot_matrices` rotation sum (naive_vec.rs:1983) is exactly
        what phi-embedding already produces, so no collapse step exists here.

        Inputs: per digit [error ct, mask cts...], then the phi(-k) key wire.
        Outputs: per (digit, crt) one merged wire (decoded_error carries the
        (q/q_i) scale; decoded+recentered mask floods the v_bits below the
        rounding threshold at the embedded coefficients)."""
        from ..gadgets.fhe.packed_ring_gsw import (
            PackedRingGswCiphertext,
            subring_stride,
        )

        ctx = self.ring_gsw
        params = self.params
        v = self.v_bits
        crt_depth = params.crt_depth
        mask_levels = max(1, masks_per_digit // v)
        assert mask_levels * v == masks_per_digit, (masks_per_digit, v)
        mask_moduli = mask_plaintext_moduli_from_full_modulus(ctx.q_big, v)
        circuit = ctx.fresh_circuit()
        digit_cts = []
        for _ in range(n_digits):
            err = PackedRingGswCiphertext.input(ctx, circuit, num_slots)
            masks = [
                PackedRingGswCiphertext.input(ctx, circuit, num_slots)
                for _ in range(masks_per_digit)
            ]
            digit_cts.append((err, masks))
        negk = circuit.input(1)[0]

        stride = subring_stride(params, num_slots)
        midpoint = 1 << (v - 1)
        mid_coeffs = [0] * params.n
        for s in range(num_slots):
            mid_coeffs[s * stride] = midpoint
        mid_wire = circuit.const_coeffs(mid_coeffs)

        outputs = []
        for err, masks in digit_cts:
            dec_masks: dict[int, int] = {}

            def mask_wire(lvl, masks=masks, dec_masks=dec_masks):
                if lvl not in dec_masks:
                    acc = None
                    for bit_idx, t in enumerate(mask_moduli):
                        sd, pb = masks[lvl * v + bit_idx].decrypt_embedded(
                            circuit, params, negk, t
                        )
                        term = circuit.add_gate(sd, pb)
                        acc = term if acc is None else circuit.add_gate(acc, term)
                    dec_masks[lvl] = circuit.add_gate(acc, mid_wire)
                return dec_masks[lvl]

            for crt_idx in range(crt_depth):
                sd, pb = err.decrypt_embedded(
                    circuit, params, negk, int(params.moduli[crt_idx])
                )
                dec_err = circuit.add_gate(sd, pb)
                outputs.append(
                    circuit.add_gate(
                        dec_err, mask_wire(min(crt_idx, mask_levels - 1))
                    )
                )
        circuit.output(outputs)
        return circuit

    def decoded_terms_packed(self, one_vec, negk_vec, material: RefreshMaterialCts,
                             plt_evaluator, extract, num_slots: int,
                             context: str = "") -> list[PolyMatrix]:
        """Per-CRT refresh-term matrices from PACKED native material cts,
        computed ONCE per (round, branch) and shared by every refreshed wire
        and every slot. `extract` maps a slot-uniform VEC wire to its scalar
        matrix/vector (e.g. lambda w: w.keys[0].matrix). Deviation from the
        reference (documented): the reference gives each refreshed slot an
        independent decoded material set (naive_vec.rs decoded idx includes
        slot_idx, ns x more material); here one phi-embedded polynomial per
        (digit, crt) is shared across slots — correctness is unaffected (any
        small fresh polynomial refreshes), hiding is the packed-material
        analog of the shared-material choice the scalar path already makes
        per (round, branch)."""
        from ..gadgets.fhe.packed_ring_gsw import packed_input_values
        from ..lookup.vec_eval import SlotwisePltEvaluator
        from ..slot_transfer import BGGVecSlotTransferEvaluator
        from ..bgg.vec import BGGEncodingVec, BGGPublicKeyVec

        params = self.params
        ctx = self.ring_gsw
        n_digits = len(material.errors)
        masks_per_digit = len(material.masks[0])
        ckey = ("packed", n_digits, masks_per_digit, num_slots)
        if ckey not in self._decrypt_circuits:
            self._decrypt_circuits[ckey] = self._packed_decrypt_circuit(
                n_digits, masks_per_digit, num_slots
            )
        circuit = self._decrypt_circuits[ckey]

        # lift packed ct values onto vec wires (slot s = R' coefficient s)
        cts = []
        for digit_idx in range(n_digits):
            assert len(material.errors[digit_idx]) == 1, (
                "packed material carries ONE error ct per digit"
            )
            cts.append(material.errors[digit_idx][0])
            cts.extend(material.masks[digit_idx])
        slot_values: list[list[int]] = []
        for ct in cts:
            slot_values.extend(packed_input_values(ctx, ct))
        one_scalar = (
            one_vec.keys[0] if isinstance(one_vec, BGGPublicKeyVec) else one_vec.encodings[0]
        )
        from ..bgg.lift import lift_constants_batched

        ns = num_slots
        # only the inputs the circuit reads are lifted (the decrypt reads the
        # halves it combines); the others stay None, as nothing derives from them
        uses = circuit.use_counts()
        read = [w for w in range(len(slot_values)) if uses[1 + w]]
        flat = [v for w in read for v in slot_values[w]]
        lifted = lift_constants_batched(params, one_scalar, flat)
        ctor = (
            BGGPublicKeyVec.new if isinstance(one_vec, BGGPublicKeyVec) else BGGEncodingVec.new
        )
        wires = [None] * len(slot_values)
        for i, w in enumerate(read):
            wires[w] = ctor(lifted[i * ns : (i + 1) * ns])

        from ..lookup.lwe import set_plt_context

        set_plt_context(plt_evaluator, f"{context}.packed_dec")
        with span("noise_refresh.packed_material_decrypt", gates=circuit.num_gates()):
            results = circuit.eval(
                params, one_vec, wires + [negk_vec],
                plt_evaluator=SlotwisePltEvaluator(plt_evaluator),
                slot_transfer_evaluator=BGGVecSlotTransferEvaluator(),
                batched=True,
            )
        set_plt_context(plt_evaluator, context)
        crt_depth = params.crt_depth
        decoded = [
            results[d * crt_depth : (d + 1) * crt_depth] for d in range(n_digits)
        ]
        return [
            self._term_matrix(decoded, crt_idx, extract)
            for crt_idx in range(crt_depth)
        ]

    # ------------------------------------------------------------ offline

    def preprocess_from_decoded(self, refresh_id: bytes, one_pk: BggPublicKey,
                                input_pk: BggPublicKey,
                                terms: list[PolyMatrix]):
        """Per-wire pubkey combine over SHARED decoded terms (reference
        preprocess_from_decoded, naive_vec.rs:1539): the stack of one of
        `preprocess_from_decoded_rows`."""
        params = self.params
        a_prime, keys = self.preprocess_from_decoded_rows(
            [refresh_id], one_pk, rows.stack(params, [input_pk.matrix]), terms)
        return (BggPublicKey(rows.unstack(params, a_prime)[0], True),
                [rows.unstack(params, k)[0] for k in keys])

    def a_prime_rows(self, refresh_ids: list[bytes]) -> torch.Tensor:
        """The hash-derived A' of many refresh ids as one EVAL stack
        [L, W, d, m, n] (`_a_prime` of each)."""
        m_g = self.d * self.params.modulus_digits
        return self._hash.sample_hash_stacked(
            self.params, self.hash_key, [b"nr_a_prime:" + r for r in refresh_ids],
            self.d, m_g, FinRingDist(), eval_form=True,
        )

    def preprocess_from_decoded_rows(self, refresh_ids: list[bytes], one_pk: BggPublicKey,
                                     input_rows: torch.Tensor, terms: list[PolyMatrix]):
        """`preprocess_from_decoded` of W wires at once: the input public keys
        as an EVAL stack [L, W, d, m, n]. Returns (the A' stack, per CRT level
        the stack of refresh-key matrices T_i)."""
        params = self.params
        q = params.tables(self.device).moduli
        a_prime = self.a_prime_rows(refresh_ids)
        gadget = PolyMatrix.gadget_matrix(params, self.d, self.device)
        refresh_keys = []
        for crt_idx, q_i in enumerate(params.moduli):
            qhat = params.modulus // int(q_i)
            input_term = rows.mul_decompose_const(params, input_rows, gadget.mul_int_scalar(qhat))
            one_term = rows.left_mul_decompose(params, one_pk.matrix,
                                               rows.mul_int(params, a_prime, qhat))
            term = terms[crt_idx].to_eval().data[:, None]
            refresh_keys.append(ew_sub(ew_add(input_term, term, q), one_term, q))
        return a_prime, refresh_keys

    def preprocess(self, refresh_id: bytes, one_pk: BggPublicKey,
                   input_pk: BggPublicKey, k_pk: BggPublicKey,
                   material: RefreshMaterialCts, plt_evaluator):
        """Pubkey path: returns (a_prime pubkey, refresh-key matrices T_i).
        The caller persists trapdoor preimages of [T_i; 0] as decoders
        (reference preprocess_from_decoded + DiamondIO refresh preimages)."""
        with span("noise_refresh.preprocess", refresh_id=refresh_id.hex()[:12]):
            terms = self.decoded_terms(
                one_pk, k_pk, material, plt_evaluator, lambda w: w.matrix
            )
            return self.preprocess_from_decoded(refresh_id, one_pk, input_pk, terms)

    # ------------------------------------------------------------- online

    def online_eval_from_decoded(self, refresh_id: bytes, one_enc: BggEncoding,
                                 input_enc: BggEncoding, terms: list[PolyMatrix],
                                 decoders: list[PolyMatrix]) -> BggEncoding:
        """Per-wire encoding combine over SHARED decoded terms;
        decoders[crt_idx] = state0 @ stored_preimage(T_i). The stack of one
        of `online_eval_from_decoded_rows`."""
        params = self.params
        a_prime, vec = self.online_eval_from_decoded_rows(
            [refresh_id], one_enc, rows.stack(params, [input_enc.vector]), terms,
            [rows.stack(params, [d]) for d in decoders])
        return BggEncoding(rows.unstack(params, vec, COEFF)[0],
                           BggPublicKey(rows.unstack(params, a_prime)[0], True),
                           input_enc.plaintext)

    def online_eval_from_decoded_rows(self, refresh_ids: list[bytes], one_enc: BggEncoding,
                                      input_rows: torch.Tensor, terms: list[PolyMatrix],
                                      decoder_rows: list[torch.Tensor]):
        """`online_eval_from_decoded` of W wires at once: the input encoding
        vectors and each level's decoders as EVAL stacks. Returns (the A'
        stack, the refreshed vectors as a COEFF stack)."""
        params = self.params
        q = params.tables(self.device).moduli
        a_prime = self.a_prime_rows(refresh_ids)
        gadget = PolyMatrix.gadget_matrix(params, self.d, self.device)
        acc = None
        for crt_idx, q_i in enumerate(params.moduli):
            qhat = params.modulus // int(q_i)
            input_term = rows.mul_decompose_const(params, input_rows, gadget.mul_int_scalar(qhat))
            one_term = rows.left_mul_decompose(params, one_enc.vector,
                                               rows.mul_int(params, a_prime, qhat))
            term = terms[crt_idx].to_eval().data[:, None]
            level = ew_sub(ew_sub(ew_add(input_term, term, q), one_term, q),
                           decoder_rows[crt_idx], q)
            rounded = rows.modulus_switch(params, level, int(q_i))
            reconst = qhat * pow(qhat, -1, int(q_i)) % params.modulus
            out = rows.mul_int(params, rounded, reconst)
            acc = out if acc is None else ew_add(acc, out, q)
        return a_prime, acc

    def online_eval(self, refresh_id: bytes, one_enc: BggEncoding,
                    input_enc: BggEncoding, k_enc: BggEncoding,
                    material: RefreshMaterialCts, decoders: list[PolyMatrix],
                    plt_evaluator) -> BggEncoding:
        """Encoding path: decoders[crt_idx] = state0 @ stored_preimage(T_i)."""
        with span("noise_refresh.online_eval", refresh_id=refresh_id.hex()[:12]):
            terms = self.decoded_terms(
                one_enc, k_enc, material, plt_evaluator, lambda w: w.vector
            )
            return self.online_eval_from_decoded(
                refresh_id, one_enc, input_enc, terms, decoders
            )
