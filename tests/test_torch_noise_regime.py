"""Diamond iO of the port with real noise, in the JAX package's configs
(`slow` there as here; the port's runs only, on the CPU):

- packed payload at n=256 (`tests/test_noise_regime.py`
  `test_diamond_io_packed_noise_n256`): `RingParams.new(256, 3, 24, 5)`, 4
  payload slots, error sigma 4.0 everywhere, trapdoor sigma 4.578, seed
  6042, XOR of two bits; both inputs decode, every decode margin is under
  (q // 4) >> 4, and the worst observed error in bits lies within the
  composed simulated bound (`simulate_prf_protocol_error` over
  `diamond_compose_input_error`, replay mode) and at most 80 bits under
  it;
- scalar payload at n=16 (`test_diamond_io_noise`):
  `RingParams.new(16, 3, 24, 5)`, sigma 4.0, seed 5042, XOR; decodes and
  margins;
- d=2 over 4-slot vec wires (`tests/test_diamond_io.py`
  `test_diamond_io_d2_vec_slots_e2e`): `RingParams.new(4, 3, 10, 10)`,
  secret_size 2, num_slots 4, seed 77, XOR and AND; decodes.

LUT gates use the debug evaluators, as in the JAX tests.
"""

import pytest

from mxx_tpu_torch.circuit import PolyCircuit
from mxx_tpu_torch.io_protocols import DiamondIO
from mxx_tpu_torch.io_protocols.prf_mask import PrfConfig
from mxx_tpu_torch.io_protocols.protocol_simulation import (
    diamond_compose_input_error,
    simulate_prf_protocol_error,
)
from mxx_tpu_torch.lookup.debug import (
    DebugBGGEncodingPltEvaluator,
    DebugBGGPubKeyPltEvaluator,
)
from mxx_tpu_torch.ring.params import RingParams

pytestmark = pytest.mark.slow

ERROR_SIGMA = 4.0
TRAPDOOR_SIGMA = 4.578
SLACK_BITS = 80


def ci_config():
    return PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                     max_unreduced_muls=1, noise_refresh_v_bits=1,
                     debug_encrypt_random_prg_wires=True, debug_reuse_single_material=True,
                     refresh_wire_limit=1)


def make_dio(ring, seed, **kw):
    return DiamondIO(
        RingParams.new(*ring), input_count=2, batch_bits=1, seed=seed, prf_config=ci_config(),
        device="cpu",
        pk_plt_evaluator_factory=lambda s, d, hk, pre: DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            DebugBGGEncodingPltEvaluator(obf.hash_key,
                                         s.injector.debug_final_secret_matrix(d, digits)),
        **kw)


def xor_builder(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1])]


def xor_and_builder(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1]), circuit.and_gate(bits[0], bits[1])]


def eval_with_margins(dio, d, obf, inputs) -> int:
    """Evaluate each input, check the XOR decodes with every margin under
    (q // 4) >> 4; returns the worst error seen."""
    worst = 0
    for bits in inputs:
        assert dio.eval(d, obf, xor_builder, bits) == [bits[0] ^ bits[1]], bits
        for coeff, err, q in dio.last_decode_margins:
            assert err < (q // 4) >> 4, (coeff, err, q)
            worst = max(worst, int(err))
    return worst


def test_diamond_io_packed_noise_n256(tmp_path):
    dio = make_dio((256, 3, 24, 5), 6042, error_sigma=ERROR_SIGMA, payload_slots=4)
    obf = dio.obfuscate(tmp_path, xor_builder)
    # the per-R'-coeff mask channel: 4 mask ciphertexts per output, not n
    assert dio._mask_bits_per_output() == 4
    observed_bits = eval_with_margins(dio, tmp_path, obf, ([0, 1], [1, 1])).bit_length()

    params = dio.params
    fn_circuit = PolyCircuit()
    ins = fn_circuit.input(2)
    fn_circuit.output([fn_circuit.xor_gate(ins[0], ins[1])])
    e_enc, worst_state = diamond_compose_input_error(params, dio.injector, TRAPDOOR_SIGMA)
    sim = simulate_prf_protocol_error(
        params, dio._prf_pipeline(), fn_circuit, input_error_norm=e_enc,
        state_error_norm=worst_state, error_sigma=ERROR_SIGMA, trapdoor_sigma=TRAPDOOR_SIGMA,
        secret_size=dio.secret_size, replay_mode=True)
    assert observed_bits <= sim.total_error_bits, (observed_bits, sim.total_error_bits)
    assert sim.total_error_bits <= observed_bits + SLACK_BITS, (observed_bits,
                                                                sim.total_error_bits)


def test_diamond_io_noise(tmp_path):
    dio = make_dio((16, 3, 24, 5), 5042, error_sigma=ERROR_SIGMA)
    obf = dio.obfuscate(tmp_path, xor_builder)
    eval_with_margins(dio, tmp_path, obf, ([0, 1], [1, 1]))


def test_diamond_io_d2_vec_slots_e2e(tmp_path):
    dio = make_dio((4, 3, 10, 10), 77, secret_size=2, num_slots=4)
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    for bits in ([0, 1], [1, 0]):
        out = dio.eval(tmp_path, obf, xor_and_builder, bits)
        assert out == [bits[0] ^ bits[1], bits[0] & bits[1]], (bits, out)
