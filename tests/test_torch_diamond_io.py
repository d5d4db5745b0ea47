"""Diamond iO (`io_protocols/diamond_io.py`) of the port against the JAX
package (mirrors `tests/test_diamond_io.py`).

- The wrapped circuit (user circuit, k-channel masked outputs, in-circuit
  PRF mask decrypts) gate for gate in scalar debug replay, packed debug
  replay and real mode.
- The port's own e2e on the CPU, in the configs of
  `test_diamond_io_prf_pipeline_e2e` (scalar payload, n=4; ~17 s) and
  `test_diamond_io_packed_payload_e2e` (packed payload, 4 slots, n=8; ~50 s
  alone, so `slow` like its JAX counterpart): both inputs decode to
  [a ^ b, a & b] and c_one == sigma (A_one - G) exactly.
- `slow`: an obfuscation the JAX package made, carried over by
  `convert.diamond_io_obf_from_numpy` with its artifact directory, is
  evaluated by the port; and the hash key, unit-ciphertext constants, seed
  ciphertexts and output count of both packages' obfuscations are equal.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_structure import assert_circuits_equal

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))


def load(pkg):
    mods = {"params": "ring.params", "dio": "io_protocols.diamond_io",
            "prf": "io_protocols.prf_mask", "debug": "lookup.debug", "bgg": "bgg",
            "matrix": "matrix", "rng": "utils.rng"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


BOTH = [load("mxx_tpu"), load("mxx_tpu_torch")]


def ci_config(ns):
    return ns.prf.PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                            max_unreduced_muls=1, noise_refresh_v_bits=1,
                            debug_encrypt_random_prg_wires=True,
                            debug_reuse_single_material=True, refresh_wire_limit=1)


def real_config(ns):
    return ns.prf.PrfConfig(seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=8,
                            max_unreduced_muls=2, noise_refresh_v_bits=1, p_basis="wide",
                            debug_encrypt_random_prg_wires=False,
                            debug_reuse_single_material=False, refresh_wire_limit=None)


def production_config(ns):
    # tests/test_production_lwe_diamond.py
    return ns.prf.PrfConfig(seed_bits=2, prf_mask_output_coeff_bits=1, p_moduli_bits=5,
                            max_unreduced_muls=1, noise_refresh_v_bits=1, nested_rns_scale=64,
                            debug_encrypt_random_prg_wires=True,
                            debug_reuse_single_material=True, refresh_wire_limit=1)


def make_dio(ns, ring, seed, cfg, input_count=2, payload_slots=1, **extra):
    return ns.dio.DiamondIO(
        ns.params.RingParams.new(*ring), input_count=input_count, batch_bits=1, seed=seed,
        prf_config=cfg, payload_slots=payload_slots, **ns.kw, **extra,
        pk_plt_evaluator_factory=lambda s, d, hk, pre: ns.debug.DebugBGGPubKeyPltEvaluator(hk),
        enc_plt_evaluator_factory=lambda s, d, obf, states, digits:
            ns.debug.DebugBGGEncodingPltEvaluator(
                obf.hash_key, s.injector.debug_final_secret_matrix(d, digits)),
    )


def xor_and_builder(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1]), circuit.and_gate(bits[0], bits[1])]


def first_bit_builder(circuit, bits):
    return [bits[0]]


MODES = {
    "scalar_debug": ((4, 3, 10, 10), ci_config, 1, 2, xor_and_builder, {}),
    "packed_debug": ((8, 3, 10, 10), ci_config, 4, 2, xor_and_builder, {}),
    "real": ((2, 2, 9, 9), real_config, 1, 1, first_bit_builder, {}),
    # tests/test_production_lwe_diamond.py (21,039 gates)
    "production_lwe": ((4, 3, 10, 10), production_config, 1, 1, first_bit_builder, {}),
    # tests/test_diamond_io.py `test_diamond_io_d2_vec_slots_e2e` (42,080 gates)
    "d2_vec": ((4, 3, 10, 10), ci_config, 1, 2, xor_and_builder,
               {"secret_size": 2, "num_slots": 4}),
}


def _wrapped(ns, mode):
    ring, cfg, slots, inputs, builder, extra = MODES[mode]
    dio = make_dio(ns, ring, 42, cfg(ns), inputs, slots, **extra)
    dio._hash_key = KEY
    prf = dio._prf_pipeline()
    params = dio.params
    rng = ns.rng.Drbg(5)
    if slots > 1:
        unit = (tuple(range(1, params.n + 1)), tuple(range(2, params.n + 2)))
    else:
        unit = (params.modulus // 3, params.modulus // 5)
    debug = ns.prf.PrfDebugArtifacts()
    n_out = dio._probe_num_outputs(builder)
    if slots == 1 and dio.prf_config.debug_encrypt_random_prg_wires:
        debug.final_mask_cts = [prf._sample_debug_prg_cts(-1, dio._mask_bits_per_output(), rng,
                                                          0.0) for _ in range(n_out)]
    return params, dio._build_wrapped_circuit(prf, builder, unit, n_out, debug)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wrapped_circuit_matches_jax(mode):
    (pj, cj), (pt, ct) = (_wrapped(ns, mode) for ns in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)


def check_e2e(ns, dio, tmp_path, obf, builder=xor_and_builder):
    for bits in ([0, 1], [1, 1]):
        out = dio.eval(tmp_path, obf, builder, bits)
        assert out == [bits[0] ^ bits[1], bits[0] & bits[1]], (bits, out)
    params = dio.params
    digits = [1, 0]
    states = dio.injector.online_eval(tmp_path, obf.preprocess_out, digits)
    sigma = dio.injector.debug_final_secret_matrix(tmp_path, digits)
    one_pk = ns.bgg.BGGPublicKeySampler(obf.hash_key, 1, **ns.kw).sample(
        params, b"diamond_bgg", [True] * 2)[0]
    one_vec = states[0] @ dio._read(tmp_path, "one_preimage")
    gadget = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    assert one_vec == sigma @ (one_pk.matrix - gadget), "c_one == sigma (A_one - G)"


def test_diamond_io_prf_pipeline_e2e(tmp_path):
    ns = BOTH[1]
    dio = make_dio(ns, (4, 3, 10, 10), 42, ci_config(ns))
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    assert obf.num_outputs == 2
    assert len(obf.prf_debug.final_mask_cts) == 2
    assert len(obf.prf_debug.prg_cts) == dio.input_count
    assert len(obf.seed_cts) == dio.prf_config.seed_bits
    check_e2e(ns, dio, tmp_path, obf)


@pytest.mark.slow
def test_diamond_io_packed_payload_e2e(tmp_path):
    ns = BOTH[1]
    dio = make_dio(ns, (8, 3, 10, 10), 91, ci_config(ns), payload_slots=4)
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    assert obf.num_outputs == 2
    assert len(obf.unit_ct_consts[0]) == dio.params.n
    assert len(obf.seed_cts[0][0][0]) == 4
    check_e2e(ns, dio, tmp_path, obf)


class _Stop(Exception):
    pass


def test_mesh_is_handed_to_every_preimage_user(tmp_path, monkeypatch):
    """A DiamondIO built with a mesh hands that mesh object to its injector,
    its PRF pipeline and the production LUT evaluator (the obfuscation is
    stopped where that evaluator is built; the injector's transitions have
    run over the mesh by then)."""
    from mxx_tpu_torch.parallel import Mesh

    ns = BOTH[1]
    mesh = Mesh([["cpu", "cpu"]])
    handed = []

    def lut_evaluator(*args, mesh=None, **kwargs):
        handed.append(mesh)
        raise _Stop

    monkeypatch.setattr(ns.dio, "LWEBGGPubKeyPltEvaluator", lut_evaluator)
    dio = ns.dio.DiamondIO(ns.params.RingParams.new(4, 3, 10, 10), 1, 1, seed=11,
                           prf_config=production_config(ns), mesh=mesh, device="cpu")
    assert dio.injector.mesh is mesh
    with pytest.raises(_Stop):
        dio.obfuscate(tmp_path, first_bit_builder)
    assert handed == [mesh] and handed[0] is mesh
    assert dio._prf_pipeline().mesh is mesh


@pytest.mark.slow
def test_diamond_io_over_a_mesh_e2e(tmp_path):
    """`test_diamond_io_prf_pipeline_e2e` with every preimage batch split
    over a logical 2-shard CPU mesh (the JAX package marks its Diamond iO
    e2e tests slow)."""
    from mxx_tpu_torch.parallel import Mesh

    ns = BOTH[1]
    dio = make_dio(ns, (4, 3, 10, 10), 42, ci_config(ns), mesh=Mesh([["cpu", "cpu"]]))
    obf = dio.obfuscate(tmp_path, xor_and_builder)
    assert obf.num_outputs == 2
    check_e2e(ns, dio, tmp_path, obf)


@pytest.mark.slow
@pytest.mark.parametrize("slots", [1, 4])
def test_port_evaluates_a_jax_obfuscation(tmp_path, slots):
    from mxx_tpu_torch import convert

    jns, ns = BOTH
    ring, seed = ((4, 3, 10, 10), 42) if slots == 1 else ((8, 3, 10, 10), 91)
    jdio = make_dio(jns, ring, seed, ci_config(jns), payload_slots=slots)
    jobf = jdio.obfuscate(tmp_path / "j", xor_and_builder)
    dbg = jobf.prf_debug
    pre = jobf.preprocess_out
    obf = convert.diamond_io_obf_from_numpy(
        ns.params.RingParams.new(*ring), jobf.hash_key,
        [(np.asarray(t.r.data), np.asarray(t.e.data), t.r.fmt) for t in pre.final_trapdoors],
        [(np.asarray(b.data), b.fmt) for b in pre.final_pub_matrices],
        jobf.num_outputs, jobf.unit_ct_consts, jobf.seed_cts,
        {"prg_cts": dbg.prg_cts,
         "refresh_material": [[(m.errors, m.masks) for m in r] for r in dbg.refresh_material],
         "final_mask_cts": dbg.final_mask_cts, "original_seed_bits": dbg.original_seed_bits},
        device="cpu")
    dio = make_dio(ns, ring, seed, ci_config(ns), payload_slots=slots)
    check_e2e(ns, dio, tmp_path / "j", obf)
    mine = dio.obfuscate(tmp_path / "t", xor_and_builder)
    assert mine.hash_key == jobf.hash_key
    assert mine.unit_ct_consts == jobf.unit_ct_consts
    assert mine.seed_cts == jobf.seed_cts
    assert mine.num_outputs == jobf.num_outputs
