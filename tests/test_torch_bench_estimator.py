"""The port's bench estimators against the JAX package's.

With the costs fixed (the same `GateCostModel` and preimage cost handed to
both packages) every estimate is equal field for field, counts and artifact
bytes included (the shapes of tests/test_bench_estimator.py and
tests/test_protocol_simulation.py). The port's measurers run on the CPU here
at tiny rings and give finite positive seconds under the JAX cost model's
keys; the timing closure synchronizes a CUDA device around the op (checked
with a stand-in here and on the card by the `cuda` test)."""

import dataclasses
import importlib
import math
from types import SimpleNamespace

import pytest
import torch

BOTH = ("mxx_tpu", "mxx_tpu_torch")


def load(pkg: str) -> SimpleNamespace:
    mods = {"params": "ring.params", "circuit": "circuit", "analysis": "circuit.analysis",
            "gate": "circuit.gate", "est": "bench_estimator",
            "estimator": "bench_estimator.estimator", "io": "io_protocols",
            "io_bench": "io_protocols.bench_estimator", "prf_mask": "io_protocols.prf_mask",
            "aky24_io": "io_protocols.aky24_io", "we_bench": "we.bench_estimator",
            "dec_bench": "decoder.bench", "fe_bench": "func_enc.bench",
            "injector": "input_injector"}
    ns = SimpleNamespace(pkg=pkg, **{k: importlib.import_module(f"{pkg}.{m}")
                                     for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def costs(ns):
    """One fixed cost model, with every kind priced differently."""
    return ns.est.GateCostModel(
        {"Add": 0.001, "Sub": 0.002, "Mul": 0.01, "SmallScalarMul": 0.003,
         "LargeScalarMul": 0.02, "PubLut": 0.05}, default_cost=0.007)


PREIMAGE_COST = 0.25


def fields(est) -> tuple:
    return dataclasses.astuple(est)


def build_circuit(ns):
    """tests/test_bench_estimator.py `build_circuit`."""
    c = ns.circuit.PolyCircuit()
    w = c.input(3)
    a = c.add_gate(w[0], w[1])
    b = c.mul_gate(a, w[2])
    d = c.mul_gate(a, w[0])
    c.output([b, d])
    return c, (a, b, d)


def mixed_circuit(ns, params):
    """Every priced kind, a LUT and a few levels."""
    c = ns.circuit.PolyCircuit()
    w = c.input(4)
    lid = c.register_public_lut(
        importlib.import_module(f"{ns.pkg}.lookup").PublicLut.from_dict(
            params, {x: (x, x % 3) for x in range(9)}))
    m = c.mul_gate(c.add_gate(w[0], w[1]), c.sub_gate(w[2], w[3]))
    s = c.large_scalar_mul(c.small_scalar_mul(m, [3]), [12345])
    c.output([c.public_lookup_gate(s, lid), c.xor_gate(w[0], w[3]), c.or_gate(w[1], w[2])])
    return c


def xor_circuit(ns):
    c = ns.circuit.PolyCircuit()
    bits = c.input(2)
    c.output([c.xor_gate(bits[0], bits[1])])
    return c


@pytest.mark.parametrize("parallelism", [1, 2, 3])
def test_plan_and_estimate_circuit_equal(parallelism):
    def run(ns):
        c, gids = build_circuit(ns)
        plan = ns.analysis.GroupedExecutionPlan.from_circuit(c)
        levels = [dict(lvl.groups) for lvl in plan.levels]
        two_kinds = ns.est.GateCostModel({"Add": 1.0, "Mul": 10.0})
        p = ns.params.RingParams.new(16, 2, 28, 14)
        return (levels, plan.max_parallelism, plan.total_gates(), gids,
                fields(ns.est.estimate_circuit(c, two_kinds, parallelism)),
                fields(ns.est.estimate_circuit(mixed_circuit(ns, p), costs(ns), parallelism)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    if parallelism == 1:  # tests/test_bench_estimator.py test_estimate_circuit_latency_model
        assert got[4] == (21.0, 21.0, 2)


@pytest.mark.parametrize("shape,inputs,num_outputs,parallelism", [
    ((4, 2, 24, 12), (2, 2, 1), 1, 1),   # tests/test_protocol_simulation.py
    ((16, 8, 28, 14), (2, 2, 1), 1, 1),  # chip_smoke's Diamond WE injector, cut in n
    ((16, 2, 28, 14), (3, 4, 2), 2, 2),
])
def test_estimate_diamond_we_equal(shape, inputs, num_outputs, parallelism):
    def run(ns):
        params = ns.params.RingParams.new(*shape)
        inj = ns.injector.DiamondInjector(params, *inputs, 4.578, 0.0, seed=4, **ns.kw)
        circuit = ns.circuit.PolyCircuit()
        w = circuit.input(3)
        circuit.output([circuit.or_gate(w[0], w[1])] * num_outputs)
        return fields(ns.we_bench.estimate_diamond_we(
            inj, circuit, num_outputs, parallelism, PREIMAGE_COST, costs(ns)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    if inputs == (2, 2, 1):  # levels 1, 2: base 2 x (2 + 3) states
        assert got[2] == 10


IO_KW = dict(  # tests/test_aky24_io.py
    bgg_tag=b"aky24", input_size=2, output_size=1, seed_bits=32, prf_batch_bits=1,
    prf_mask_output_coeff_bits=4, noise_refresh_v_bits=8, noise_refresh_cbd_n=4,
)
SMALL_IO_KW = dict(  # tests/test_protocol_simulation.py
    bgg_tag=b"t", input_size=2, output_size=1, seed_bits=5, prf_batch_bits=1,
    prf_mask_output_coeff_bits=1, noise_refresh_v_bits=1, noise_refresh_cbd_n=1,
)


@pytest.mark.parametrize("shape,kw,parallelism", [
    ((4, 2, 24, 12), SMALL_IO_KW, 1), ((16, 4, 28, 7), IO_KW, 1), ((8192, 8, 28, 14), IO_KW, 4),
])
def test_estimate_aky24_io_equal(shape, kw, parallelism):
    def run(ns):
        params = ns.params.RingParams.new(*shape)
        io = ns.io.Aky24IO(params=params, **kw)
        return fields(ns.aky24_io.estimate_aky24_io(
            io, mixed_circuit(ns, params), parallelism, PREIMAGE_COST, costs(ns)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    if kw is SMALL_IO_KW:  # rounds x branches x seed bits x (1 rebase + L refresh)
        assert got[2] == 2 * 2 * 5 * (1 + shape[1])


@pytest.mark.parametrize("parallelism", [1, 2])
def test_estimate_aky24_keygen_dec_equal(parallelism):
    def run(ns):
        params = ns.params.RingParams.new(8192, 8, 28, 14)
        c = mixed_circuit(ns, params)
        kg = ns.fe_bench.estimate_aky24_keygen(params, c, parallelism, PREIMAGE_COST, costs(ns))
        dec = ns.fe_bench.estimate_aky24_dec(params, c, parallelism, costs(ns))
        return fields(kg), fields(dec)

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    kg, dec = got
    assert kg[2] > kg[0] > 0 and dec[2] > dec[0] > 0 and dec[1] == 2 * 0.01


@pytest.mark.parametrize("parallelism", [1, 3])
def test_estimate_decoder_scaling_equal(parallelism):
    def run(ns):
        params = ns.params.RingParams.new(4, 2, 24, 12)
        return fields(ns.dec_bench.estimate_decoder_scaling(
            params, [1, 4, 16], parallelism=parallelism, per_output_cost=0.0625))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert got[2][1] == 4 * 0.0625 / parallelism


def ci_prf_config(ns):
    """chip_smoke's Diamond iO PRF config (tests/test_diamond_io.py `_ci_prf_config`)."""
    return ns.prf_mask.PrfConfig(
        seed_bits=5, prf_mask_output_coeff_bits=1, p_moduli_bits=5, max_unreduced_muls=1,
        noise_refresh_v_bits=1, debug_encrypt_random_prg_wires=True,
        debug_reuse_single_material=True, refresh_wire_limit=1)


def xor_and(circuit, bits):
    return [circuit.xor_gate(bits[0], bits[1]), circuit.and_gate(bits[0], bits[1])]


@pytest.mark.parametrize("n,parallelism", [(16, 1), (4, 2)])
def test_estimate_diamond_io_debug_replay_equal(n, parallelism):
    """Fast twin of the real-PRF comparison below: chip_smoke's Diamond iO
    shape (packed, 4 slots, debug replay, XOR/AND) at a toy ring."""
    def run(ns):
        params = ns.params.RingParams.new(n, 2, 28, 14)
        dio = ns.io.DiamondIO(params, 2, 1, seed=1, prf_config=ci_prf_config(ns),
                              payload_slots=4, **ns.kw)
        return fields(ns.io_bench.estimate_diamond_io(
            dio, xor_and, parallelism, PREIMAGE_COST, costs(ns)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert got[4:6] == (10, 2) and got[6] > 0


@pytest.mark.slow
def test_estimate_diamond_io_real_prf_shape_equal():
    """tests/test_bench_estimator.py test_estimate_diamond_io_real_prf_shape
    (slow there): the real-mode wrapped circuit, priced field for field."""
    def run(ns):
        params = ns.params.RingParams.new(4, 3, 10, 10)
        dio = ns.io.DiamondIO(params, 2, 1, seed=1, prf_config=ns.prf_mask.PrfConfig(
            seed_bits=5, p_moduli_bits=5, max_unreduced_muls=2), **ns.kw)
        return fields(ns.io_bench.estimate_diamond_io(
            dio, lambda c, bits: [c.and_gate(bits[0], bits[1])], 1, PREIMAGE_COST, costs(ns)))

    got = run(load("mxx_tpu_torch"))
    assert got == run(load("mxx_tpu"))
    assert got[0] > 0 and got[1] > 0 and got[6] > 0


# ------------------------------------------------------------- measurements

@pytest.fixture(scope="module")
def jax_keys():
    """The JAX cost model's keys: its measured poly model (tests/test_bench_
    estimator.py's shape) and, for the encoding models, that plus PubLut."""
    jx = load("mxx_tpu")
    poly = set(jx.est.measure_poly_costs(jx.params.RingParams.default(), iterations=1).costs)
    return {"poly": poly, "bgg": poly | {jx.gate.PUB_LUT}}


def test_measured_model_costs_on_cpu(jax_keys):
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.new(16, 2, 20, 5)
    models = {
        "poly": ns.est.measure_poly_costs(params, iterations=2, device="cpu"),
        "bgg": ns.est.measure_bgg_encoding_costs(params, iterations=2, device="cpu"),
        "bgg d=2": ns.est.measure_bgg_encoding_costs(params, 2, iterations=2, lut_cost=0.5,
                                                     device="cpu"),
        "packed": ns.est.measure_bgg_poly_encoding_costs(params, num_slots=2, iterations=2,
                                                         device="cpu"),
        "naive vec": ns.est.measure_naive_vec_costs(params, num_slots=3, iterations=2,
                                                    lut_cost=0.5, device="cpu"),
    }
    for name, model in models.items():
        assert set(model.costs) == jax_keys["poly" if name == "poly" else "bgg"], name
        values = list(model.costs.values()) + [model.default_cost]
        assert all(math.isfinite(v) and v > 0 for v in values), (name, model)
    assert models["bgg d=2"].cost("PubLut") == 0.5
    assert models["naive vec"].cost("PubLut") == 1.5
    s = ns.est.estimate_circuit(build_circuit(ns)[0], models["poly"])
    assert s.total_time_secs > 0 and s.latency_secs > 0


@pytest.mark.parametrize("what", ["lwe lut", "preimage d=1", "preimage d=2",
                                  "preimage cols=1", "masked decode d=1", "masked decode d=2"])
def test_measured_op_cost_on_cpu(what):
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.new(16, 2, 20, 5)
    cost = {
        "lwe lut": lambda: ns.estimator.measure_lwe_lut_online_cost(params, 1, 2, device="cpu"),
        "preimage d=1": lambda: ns.io_bench.measure_preimage_cost(params, d=1, device="cpu"),
        "preimage d=2": lambda: ns.io_bench.measure_preimage_cost(params, device="cpu"),
        "preimage cols=1": lambda: ns.io_bench.measure_preimage_cost(
            params, d=2, cols=1, device="cpu"),
        "masked decode d=1": lambda: ns.dec_bench.measure_masked_decode_cost(
            params, iterations=2, device="cpu"),
        "masked decode d=2": lambda: ns.dec_bench.measure_masked_decode_cost(
            params, 2, iterations=2, device="cpu"),
    }[what]()
    assert math.isfinite(cost) and cost > 0


def test_measured_costs_feed_the_estimators_on_cpu():
    """Estimates with the costs left None measure them on the device asked for."""
    ns = load("mxx_tpu_torch")
    params = ns.params.RingParams.new(16, 2, 20, 5)
    c = xor_circuit(ns)
    kg = ns.fe_bench.estimate_aky24_keygen(params, c, device="cpu")
    dec = ns.fe_bench.estimate_aky24_dec(params, c, device="cpu")
    scaling = ns.dec_bench.estimate_decoder_scaling(params, [1, 4], device="cpu")
    io = ns.aky24_io.estimate_aky24_io(ns.io.Aky24IO(params=params, **SMALL_IO_KW), c,
                                       device="cpu")
    inj = ns.injector.DiamondInjector(params, 2, 2, 1, 4.578, 0.0, seed=4, device="cpu")
    we = ns.we_bench.estimate_diamond_we(inj, c)
    assert kg.total_secs > kg.circuit_latency_secs > 0
    assert dec.total_secs > dec.circuit_latency_secs > 0
    assert scaling.latency_secs[1] == 4 * scaling.per_output_secs > 0
    assert io.obfuscate_latency_secs > io.eval_latency_secs > 0
    assert we.enc_latency_secs > 0 and we.dec_latency_secs > 0


def test_timing_closure_synchronizes_cuda_around_each_run(monkeypatch):
    """On a CUDA device the closure waits for the device before the clock
    starts and after the op, on every timed run (a stand-in records the
    calls here); on the CPU it calls no synchronize."""
    est = load("mxx_tpu_torch").est
    events = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: events.append(
        ("sync", torch.device(device).type)))
    est.benchmark_gate_operation(3, lambda: events.append("op"), device="cuda")
    # warm-up op, then per timed run: sync, op, sync
    assert events == ["op"] + [("sync", "cuda"), "op", ("sync", "cuda")] * 3
    events.clear()
    t = est.benchmark_gate_operation(3, lambda: events.append("op"), device="cpu")
    assert events == ["op"] * 4 and t >= 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timing_closure_waits_for_the_card(cuda_device):
    """An op that only enqueues device work (a ~50 ms spin kernel) is timed
    at its device time, not at its enqueue time."""
    est = load("mxx_tpu_torch").est
    cycles = int(1e8)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    t = est.benchmark_gate_operation(3, lambda: torch.cuda._sleep(cycles), cuda_device)
    assert device_s > 0.005
    assert t >= 0.9 * device_s, (t, device_s)
