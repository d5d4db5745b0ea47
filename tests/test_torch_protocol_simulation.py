"""The port's composed protocol error budget, AKY24 iO simulation and CRT-depth
searches against the JAX package's: the same inputs give EQUAL bits, margins,
`ok` flags and depths (the inputs of tests/test_protocol_simulation.py,
tests/test_aky24_io.py and tests/test_debug_and_simulation.py).

A composed budget that evolves the PRF walks the Goldreich-PRG-over-GSW round
circuit over norms: 4.8 million gates at the smallest test ring, minutes per
package. Those comparisons are `slow`, where the JAX package marks its own;
their fast twins price the debug-replay pipeline (`replay_mode=True`: no PRG
round circuit), which walks the mask decrypt and the function circuit."""

import importlib
from decimal import Decimal
from types import SimpleNamespace

import pytest

BOTH = ("mxx_tpu", "mxx_tpu_torch")


def load(pkg: str) -> SimpleNamespace:
    mods = {"params": "ring.params", "circuit": "circuit", "lookup": "lookup",
            "prf_mask": "io_protocols.prf_mask", "psim": "io_protocols.protocol_simulation",
            "aky24_io": "io_protocols.aky24_io", "io": "io_protocols",
            "diamond_io": "io_protocols.diamond_io", "injector": "input_injector",
            "sampler": "sampler", "fe_bench": "func_enc.bench"}
    ns = SimpleNamespace(pkg=pkg, **{k: importlib.import_module(f"{pkg}.{m}")
                                     for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def xor_circuit(ns):
    c = ns.circuit.PolyCircuit()
    bits = c.input(2)
    c.output([c.xor_gate(bits[0], bits[1])])
    return c


def make_prf(ns, params, mask_bits: int = 1):
    """tests/test_protocol_simulation.py `_make_prf`."""
    cfg = ns.prf_mask.PrfConfig(
        seed_bits=5, prf_mask_output_coeff_bits=mask_bits, p_moduli_bits=8,
        max_unreduced_muls=2, p_basis="wide", noise_refresh_v_bits=1,
    )
    return ns.prf_mask.PrfMaskPipeline(
        params, cfg, b"\0" * 32, ns.sampler.TrapdoorSampler(params, 4.578, seed=0, **ns.kw),
        input_count=2, batch_bits=1,
    )


def sim_fields(sim) -> tuple:
    """Every field of a PrfProtocolErrorSimulation but its context."""
    return (sim.input_error_bits, sim.prg_round_error_bits, sim.rebased_error_bits,
            sim.refreshed_error_bits, sim.function_error_bits, sim.mask_error_bits,
            sim.decoder_error_bits, sim.total_error_bits, sim.margin_bits, sim.ok,
            sim.pre_rounding_ok)


def params_fields(p) -> tuple:
    return (p.n, p.crt_depth, p.crt_bits, p.base_bits, p.modulus)


@pytest.mark.parametrize("shape,seed", [((4, 3, 24, 12), 9), ((16, 4, 28, 7), 3)])
def test_diamond_compose_input_error_equal(shape, seed):
    def run(ns):
        params = ns.params.RingParams.new(*shape)
        inj = ns.injector.DiamondInjector(params, 2, 2, 1, 4.578, 4.0, seed=seed, **ns.kw)
        return ns.psim.diamond_compose_input_error(params, inj, 4.578)

    e_enc, state = run(load("mxx_tpu_torch"))
    assert (e_enc, state) == run(load("mxx_tpu"))
    assert e_enc > state > 0


IO_KW = dict(  # tests/test_aky24_io.py
    bgg_tag=b"aky24", input_size=2, output_size=1, seed_bits=32, prf_batch_bits=1,
    prf_mask_output_coeff_bits=4, noise_refresh_v_bits=8, noise_refresh_cbd_n=4,
)


def lut_circuit(ns):
    """tests/test_aky24_io.py `make_circuit`: Mul -> LUT (x mod 3)."""
    def make(params):
        c = ns.circuit.PolyCircuit()
        w = c.input(2)
        lid = c.register_public_lut(
            ns.lookup.PublicLut.from_dict(params, {x: (x, x % 3) for x in range(9)}))
        c.output([c.public_lookup_gate(c.mul_gate(w[0], w[1]), lid)])
        return c
    return make


def aky24_fields(sim) -> tuple:
    return (sim.encoding_error_bits, sim.circuit_error_bits, sim.decode_margin_bits, sim.ok)


@pytest.mark.parametrize("shape", [(16, 4, 28, 7), (16, 2, 28, 7), (8192, 3, 28, 14)])
def test_simulate_aky24_io_equal(shape):
    def run(ns):
        params = ns.params.RingParams.new(*shape)
        io = ns.io.Aky24IO(params=params, **IO_KW)
        sim = ns.io.simulate_aky24_io(io, lut_circuit(ns)(params))
        return aky24_fields(sim), io.prf_rounds, io.minimum_seed_bits()

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    if shape == (16, 4, 28, 7):  # tests/test_aky24_io.py test_simulation_margin
        assert got[0][3] and got[0][2] > 0 and got[1] == 2 and got[2] >= 5


@pytest.mark.parametrize("search", [(16, 28, 7, 6), (8192, 28, 14, 8), (16, 28, 7, 1)])
def test_aky24_io_find_crt_depth_equal(search):
    def run(ns):
        found = ns.io.aky24_io_find_crt_depth(lut_circuit(ns), *search, IO_KW)
        if found is None:
            return None
        depth, params = found
        sim = ns.io.simulate_aky24_io(ns.io.Aky24IO(params=params, **IO_KW),
                                      lut_circuit(ns)(params))
        return depth, params_fields(params), aky24_fields(sim)

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    if search[3] > 1:  # the found depth satisfies the margin, the one below it does not
        depth, _, fields = got
        assert 1 <= depth <= search[3] and fields[3]
        if depth > 1:
            assert run_below(search, depth) is False


def run_below(search, depth) -> bool:
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.new(search[0], depth - 1, search[1], search[2])
    return ns.io.simulate_aky24_io(ns.io.Aky24IO(params=params, **IO_KW),
                                   lut_circuit(ns)(params)).ok


@pytest.mark.parametrize("shape,use_affine,input_error", [
    ((4, 3, 24, 12), False, 26), ((4, 3, 24, 12), True, 26), ((16, 3, 28, 7), False, 100),
])
def test_replay_mode_budget_equal(shape, use_affine, input_error):
    """Fast twin of the composed-budget comparisons: the debug-replay
    pipeline's budget (fresh mask ciphertexts, no PRG rounds)."""
    def run(ns):
        params = ns.params.RingParams.new(*shape)
        sim = ns.psim.simulate_prf_protocol_error(
            params, make_prf(ns, params), xor_circuit(ns),
            input_error_norm=Decimal(input_error), error_sigma=4.0,
            replay_mode=True, use_affine=use_affine,
        )
        return sim_fields(sim), (params.modulus // 4).bit_length()

    got, q4 = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))[0]
    assert got[1] == [] and got[8] == q4 - got[7]  # no rounds; margin = q/4 bits - total


@pytest.mark.parametrize("wrapper,input_error", [("prf", 26), ("prf", 2 ** 130), ("aky24", None)])
def test_max_safe_prf_mask_output_coeff_bits_equal(wrapper, input_error):
    """The widest mask of the replay-mode budget (and of its AKY24 wrapper) at
    a depth whose replay budget has a few bits of margin."""
    def run(ns):
        params = ns.params.RingParams.new(4, 5, 28, 14)
        if wrapper == "prf":
            best = ns.psim.max_safe_prf_mask_output_coeff_bits(
                params, lambda b: make_prf(ns, params, b), xor_circuit(ns), 2,
                input_error_norm=Decimal(input_error), replay_mode=True,
            )
        else:
            best = ns.fe_bench.max_safe_aky24_prf_mask_output_coeff_bits(
                params, xor_circuit(ns), lambda b: make_prf(ns, params, b), 2,
                replay_mode=True,
            )
        return None if best is None else (best[0], sim_fields(best[1]))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert (got is None) == (input_error == 2 ** 130)
    if got is not None:
        assert got[0] == 2 and got[1][9]


# ---------------------------------------------------------------- slow tier

def _composed(ns, depth, **kw):
    params = ns.params.RingParams.new(4, depth, 24, 12)
    return sim_fields(ns.psim.simulate_prf_protocol_error(
        params, make_prf(ns, params), xor_circuit(ns),
        input_error_norm=Decimal(26), error_sigma=4.0, **kw))


@pytest.mark.slow
def test_composed_budget_equal():
    """tests/test_protocol_simulation.py test_composed_budget_phases_and_margin
    (slow there): every phase's bits, the margin and `ok` equal."""
    got = _composed(load("mxx_tpu_torch"), 3)
    assert got == _composed(load("mxx_tpu"), 3)
    assert len(got[1]) == 2 and len(got[3]) == 2 and not got[9]


@pytest.mark.slow
def test_composed_budget_depth_4_equal():
    """The shallower point of test_composed_budget_monotone_in_depth (slow
    there). Its depth-8 point is left out: one walk at depth 8 holds over
    30 GB of norm wires in either package."""
    ns = load("mxx_tpu_torch")
    got = _composed(ns, 4)
    assert got == _composed(load("mxx_tpu"), 4)
    q4_bits = (ns.params.RingParams.new(4, 4, 24, 12).modulus // 4).bit_length()
    assert len(got[1]) == 2 and got[8] == q4_bits - got[7]


@pytest.mark.slow
def test_aky24_dec_error_equal():
    """tests/test_protocol_simulation.py test_aky24_fe_bench_and_simulation
    (slow there): the composed AKY24 decryption budget."""
    def run(ns):
        params = ns.params.RingParams.new(4, 3, 24, 12)
        return sim_fields(ns.fe_bench.simulate_aky24_dec_error(
            params, xor_circuit(ns), make_prf(ns, params)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert got[7] > 0 and len(got[3]) == 2


@pytest.mark.slow
def test_diamond_io_find_crt_depth_equal():
    """tests/test_debug_and_simulation.py test_diamond_io_find_crt_depth (slow
    there): the search rejects every depth up to 3 in both packages, and the
    composed budget at depth 3 is equal."""
    def lut_add(ns):
        def make(params):
            c = ns.circuit.PolyCircuit()
            bits = c.input(2)
            lid = c.register_public_lut(
                ns.lookup.PublicLut.from_dict(params, {x: (x, x % 2) for x in range(4)}))
            c.output([c.public_lookup_gate(c.add_gate(bits[0], bits[1]), lid)])
            return c
        return make

    def run(ns):
        found = ns.diamond_io.diamond_io_find_crt_depth(
            16, 28, 7, max_depth=3, input_count=2, batch_bits=1,
            make_circuit=lut_add(ns), **ns.kw)
        params = ns.params.RingParams.new(16, 3, 28, 7)
        cfg = ns.prf_mask.PrfConfig(max_unreduced_muls=2, p_moduli_bits=16, p_basis="wide")
        prf = ns.prf_mask.PrfMaskPipeline(
            params, cfg, b"\0" * 32,
            ns.sampler.TrapdoorSampler(params, 4.578, seed=0, **ns.kw), 2, 1)
        sim = ns.psim.simulate_prf_protocol_error(
            params, prf, lut_add(ns)(params), input_error_norm=Decimal(100), error_sigma=4.0)
        return found, sim_fields(sim)

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert got[0] is None and len(got[1][1]) == 2
