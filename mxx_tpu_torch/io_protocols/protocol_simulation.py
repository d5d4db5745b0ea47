"""Composed protocol error budget for the PRF-mask protocols (Diamond iO /
AKY24 iO / AKY24 FE), a copy of `mxx_tpu/io_protocols/protocol_simulation.py`.

Host arithmetic only: the circuits it walks are built by the port's gadget
modules and evaluated over `ErrorNorm` wires, so nothing here touches a
tensor. ONE simulation chains

  input errors (injector transition bounds composed with the output
  projection, or fresh Gaussian encodings)
  -> per-round PRF evolution: the ACTUAL per-round Goldreich-PRG-over-GSW
     circuit evaluated over ErrorNorm wires, then the branch-rebase preimage
     term, then the noise-refresh rounding bound (with the pre-rounding
     correctness check) - first round + steady state, like the reference's
     two representative refresh rounds
  -> final mask PRG + in-circuit mask decrypt over the wrapped circuit
  -> function-circuit output error
  -> masked-decode projection term (state error x decoder preimage norm)

and compares the total against the q/4 decode threshold. The same budget
drives `find_crt_depth` (smallest depth with positive margin) and
`max_safe_prf_mask_output_coeff_bits` (widest mask).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal

from ..noise_refresh.refresh import (
    pre_rounding_bound_holds,
    simulate_noise_refresh_error_growth,
)
from ..simulator import (
    NormPltLWEEvaluator,
    SimulatorContext,
    bits_ceil,
    compute_preimage_norm,
    simulate_max_error_norm,
)

GAUSS_TAIL = Decimal("6.5")


@dataclass
class PrfProtocolErrorSimulation:
    """Per-phase error bounds (bit widths of the norm bounds) and the final
    decode margin."""

    ctx: SimulatorContext
    input_error_bits: int = 0
    prg_round_error_bits: list = field(default_factory=list)
    rebased_error_bits: list = field(default_factory=list)
    refreshed_error_bits: list = field(default_factory=list)
    function_error_bits: int = 0
    mask_error_bits: int = 0
    decoder_error_bits: int = 0
    total_error_bits: int = 0
    margin_bits: int = 0
    ok: bool = False
    pre_rounding_ok: bool = True


def _max_norm(outs) -> Decimal:
    return max(o.matrix_norm.poly_norm.norm for o in outs)


def simulate_prf_protocol_error(
    params,
    prf,  # PrfMaskPipeline (provides the per-round PRG + wrapped circuits)
    function_circuit,
    *,
    input_error_norm: Decimal,
    state_error_norm: Decimal | None = None,
    error_sigma: float = 4.0,
    trapdoor_sigma: float = 4.578,
    secret_size: int = 1,
    rounds: int | None = None,
    num_outputs: int = 1,
    plt_norm_factory=None,
    replay_mode: bool = False,
    use_affine: bool = False,
) -> PrfProtocolErrorSimulation:
    """Compose the full per-phase error budget for one PRF-mask protocol run.

    `input_error_norm` bounds the BGG encoding error entering the pipeline
    (Diamond: injector state error composed with the output projection;
    AKY24: fresh Gaussian sigma * tail). `state_error_norm` bounds the
    evaluation state row used for stored-preimage products (defaults to
    `input_error_norm`)."""
    cfg = prf.cfg
    ctx = SimulatorContext.for_params(params, secret_size)
    if state_error_norm is None:
        state_error_norm = input_error_norm
    if plt_norm_factory is None:
        plt_norm = NormPltLWEEvaluator(ctx, Decimal(error_sigma))
    else:
        plt_norm = plt_norm_factory(ctx)
    # use_affine: evaluate the norm circuits through the affine eval_error
    # engine (cached affine sub-circuit summaries; identical bounds) - the
    # direct walk over the production-depth PRG circuits (gadget_len ~370 at
    # n=65536/L=53) takes hours, the affine engine minutes
    if use_affine:
        from ..simulator import AffineLWEWrapper, simulate_max_error_norm_affine

        def _sim(circuit, ctx_, one, ninp, inp_norm, plt_evaluator=None):
            pe = AffineLWEWrapper(plt_evaluator) if plt_evaluator is not None else None
            return simulate_max_error_norm_affine(
                circuit, ctx_, one, ninp, inp_norm, pe
            )
    else:
        _sim = simulate_max_error_norm
    sim = PrfProtocolErrorSimulation(ctx)
    sim.input_error_bits = bits_ceil(Decimal(input_error_norm))

    q_bits = params.modulus_bits
    preimage_norm = compute_preimage_norm(
        ctx.ring_dim_sqrt, ctx.m_g, Decimal(1 << params.base_bits),
        b_nrow=secret_size, sigma=trapdoor_sigma,
    )
    # stored-preimage product term: state row (1 x m_b) times preimage
    decoder_term = (
        Decimal(state_error_norm) * preimage_norm * Decimal(ctx.m_b).sqrt()
    )

    # --- per-round PRF evolution: first round + steady state -------------
    # replay_mode prices the DEBUG-REPLAY pipeline (the e2e test mode): PRG round outputs and mask
    # ciphertexts are FRESH valid encryptions recorded in the obfuscation,
    # so no PRG rounds evolve the seed error and the mask-ct error is the
    # fresh encryption bound. This is the bound a CI-scale e2e run can be
    # compared against (the full real-mode bound only turns positive at
    # production depths).
    total_rounds = (
        0 if replay_mode else (prf.input_count if rounds is None else rounds)
    )
    reps = min(2, total_rounds)
    seed_error = Decimal(input_error_norm)
    for rep in range(reps):
        # representative single PRG edge: every edge of the round graph has
        # the same norm structure
        circuit = prf.build_prg_round_circuit(rep, representative=True)
        outs = _sim(
            circuit, ctx, Decimal(1), circuit.num_input, seed_error,
            plt_evaluator=plt_norm,
        )
        prg_error = _max_norm(outs)
        sim.prg_round_error_bits.append(bits_ceil(prg_error))
        # branch rebase: c' = state0 @ pre + masked.vector; the mask term is
        # plaintext-weighted hash material (selector - b) * mask with
        # selector plaintexts <= branch_count
        rebase_error = prg_error + decoder_term
        sim.rebased_error_bits.append(bits_ceil(rebase_error))
        # noise refresh: pre-rounding bound, then the refreshed error no
        # longer depends on the input (that is the point)
        if not pre_rounding_bound_holds(
            rebase_error, q_bits, cfg.noise_refresh_v_bits
        ):
            sim.pre_rounding_ok = False
        refreshed = simulate_noise_refresh_error_growth(
            ctx, rebase_error, cfg.noise_refresh_v_bits, params.crt_depth,
            cfg.noise_refresh_cbd_n, q_bits,
        ) + decoder_term * Decimal(params.crt_depth)
        sim.refreshed_error_bits.append(bits_ceil(refreshed))
        seed_error = refreshed

    # --- final mask PRG + decrypt (representative units) ------------------
    # mask ciphertexts come from the final-round PRG over the (refreshed)
    # seed wires; one representative edge bounds every mask ct's error, and
    # the per-output decrypt circuit is then evaluated over ct-error inputs
    bits_per_output = (
        prf.num_slots if prf.num_slots > 1 else params.n
    ) * cfg.prf_mask_output_coeff_bits
    from ..gadgets.fhe.ring_gsw import RingGswCiphertext
    from ..noise_refresh.circuit_decrypt import (
        decrypt_bit_decomposed_polynomial_parts,
    )
    from ..decoder.mask_circuit import mask_plaintext_moduli_from_full_modulus

    if replay_mode:
        # fresh valid encryption: coefficient error ~ N(0, sigma), bounded
        # by the Gaussian tail over the ring dimension
        mask_ct_error = GAUSS_TAIL * Decimal(error_sigma) * ctx.ring_dim_sqrt
    else:
        edge = prf.build_prg_round_circuit(total_rounds, representative=True)
        outs = _sim(
            edge, ctx, Decimal(1), edge.num_input, seed_error,
            plt_evaluator=plt_norm,
        )
        mask_ct_error = _max_norm(outs)

    # representative ONE-ciphertext decrypt, scaled by bits_per_output (the
    # per-bit decrypts SUM into the output wire)
    dec_circuit = prf.ctx.fresh_circuit()
    ct = RingGswCiphertext.input(prf.ctx, dec_circuit)
    key = dec_circuit.input(1)[0]
    moduli = mask_plaintext_moduli_from_full_modulus(
        prf.ctx.q_big, cfg.prf_mask_output_coeff_bits
    )
    sd, pb = decrypt_bit_decomposed_polynomial_parts(
        dec_circuit, [ct] * len(moduli), key, moduli
    )
    dec_circuit.output([sd, pb])
    outs = _sim(
        dec_circuit, ctx, Decimal(1), dec_circuit.num_input, mask_ct_error,
        plt_evaluator=plt_norm,
    )
    per_bit_error = _max_norm(outs)
    mask_error = (
        per_bit_error
        * Decimal(max(1, bits_per_output // max(1, len(moduli))))
        * Decimal(ctx.m_g).sqrt()  # final G^{-1} fold
    )
    sim.mask_error_bits = bits_ceil(mask_error)

    # --- user function circuit -------------------------------------------
    outs = _sim(
        function_circuit, ctx, Decimal(1), function_circuit.num_input,
        Decimal(input_error_norm), plt_evaluator=plt_norm,
    )
    function_error = _max_norm(outs) * Decimal(ctx.m_g).sqrt()
    sim.function_error_bits = bits_ceil(function_error)

    # --- masked-decode projection ----------------------------------------
    sim.decoder_error_bits = bits_ceil(decoder_term)

    total = function_error + mask_error + decoder_term
    sim.total_error_bits = bits_ceil(total)
    q_quarter_bits = (params.modulus // 4).bit_length()
    sim.margin_bits = q_quarter_bits - sim.total_error_bits
    sim.ok = sim.pre_rounding_ok and sim.margin_bits > 0
    return sim


def max_safe_prf_mask_output_coeff_bits(
    params, make_prf, function_circuit, max_bits: int, **sim_kwargs
) -> tuple[int, PrfProtocolErrorSimulation] | None:
    """Largest prf_mask_output_coeff_bits with a positive margin; each
    candidate re-runs the full composed simulation."""
    best = None
    for candidate in range(1, max_bits + 1):
        prf = make_prf(candidate)
        sim = simulate_prf_protocol_error(
            params, prf, function_circuit, **sim_kwargs
        )
        # the mask VALUE range itself must also clear the threshold
        if sim.ok and candidate < sim.margin_bits + 1:
            best = (candidate, sim)
        else:
            break
    return best


def diamond_compose_input_error(params, injector, trapdoor_sigma: float
                                ) -> tuple[Decimal, Decimal]:
    """(encoding_error, state_error) for DiamondIO: the injector chain bound
    composed with the stored output-projection preimage."""
    from ..input_injector.simulation import simulate_output_error_bounds

    inj_sim = simulate_output_error_bounds(injector)
    worst_state = max(e.poly_norm.norm for e in inj_sim.state_errors)
    e_enc = (
        worst_state
        * inj_sim.output_preimage.poly_norm.norm
        * Decimal(inj_sim.output_preimage.nrow).sqrt()
    )
    return e_enc, worst_state
