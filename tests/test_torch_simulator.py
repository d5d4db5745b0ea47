"""The port's error simulator against the JAX package's: the same circuits and
norms in both packages give EQUAL results (Decimals at the same precision,
ints, flags), on the inputs of tests/test_simulator.py and
tests/test_eval_error_affine.py. Host arithmetic only: no tensor is made."""

import importlib
from decimal import Decimal
from types import SimpleNamespace

import pytest

BOTH = ("mxx_tpu", "mxx_tpu_torch")


def load(pkg: str) -> SimpleNamespace:
    mods = {"params": "ring.params", "circuit": "circuit", "lookup": "lookup",
            "sim": "simulator", "plt_norms": "simulator.plt_norms",
            "estimator": "simulator.lattice_estimator"}
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})


def ctx_of(ns, params=None):
    params = params or ns.params.RingParams.new(16, 4, 28, 7)
    return params, ns.sim.SimulatorContext.for_params(params, secret_size=1)


def poly(n) -> tuple:
    return (n.norm, n.is_constant)


def mat(m) -> tuple:
    return (m.nrow, m.ncol, poly(m.poly_norm), m.zero_rows)


def err(e) -> tuple:
    return (poly(e.plaintext_norm), mat(e.matrix_norm))


def test_bits_ceil_equal():
    values = [Decimal(0), Decimal(-3), Decimal(1), Decimal("1.5"), Decimal(2), Decimal(1023),
              Decimal(1024), Decimal(2) ** 200 + 1, Decimal("6.5") * Decimal(4)]
    got = {pkg: [load(pkg).sim.bits_ceil(v) for v in values] for pkg in BOTH}
    assert got["mxx_tpu"] == got["mxx_tpu_torch"]
    assert got["mxx_tpu_torch"][:5] == [0, 0, 0, 1, 1]


@pytest.mark.parametrize("shape", [(16, 4, 28, 7), (4, 3, 24, 12), (8192, 8, 28, 14)])
def test_context_and_norm_helpers_equal(shape):
    def run(pkg):
        ns = load(pkg)
        params, ctx = ctx_of(ns, ns.params.RingParams.new(*shape))
        PN, PMN = ns.sim.PolyNorm, ns.sim.PolyMatrixNorm
        a, b, g = PN.constant(ctx, 3), PN.constant(ctx, 5), PN(ctx, Decimal(5))
        gd = PMN.gadget_decomposed(ctx, 3)
        top, bottom = PMN.new(ctx, 5, 7, 2).split_rows(2)
        left, right = PMN.new(ctx, 5, 7, 2, zero_rows=1).split_cols(3)
        m = PMN.new(ctx, 1, ctx.m_g, 2) * PMN(ctx.m_g, 4, PN(ctx, Decimal(3)), 2)
        return (
            (ctx.ring_dim_sqrt, ctx.base, ctx.secret_size, ctx.log_base_q,
             ctx.log_base_q_small, ctx.m_g, ctx.m_b),
            [poly(x) for x in (PN.one(ctx), a, a * b, a * g, g * g, g * 7, g.into_constant(),
                               PN.sample_gauss(ctx, 4.0), a + g)],
            [mat(x) for x in (gd, PMN.gadget_decomposed_with_secret_size(ctx, 2, 5), top,
                              bottom, left, right, m, PMN.new(ctx, 1, 4, 2) * PMN.new(ctx, 4, 8, 3),
                              PMN.sample_gauss(ctx, 2, 3, 4.0) * a, gd * 3)],
            ns.sim.compute_preimage_norm(ctx.ring_dim_sqrt, ctx.m_g, ctx.base, b_nrow=2,
                                         sigma=6.0),
        )

    assert run("mxx_tpu") == run("mxx_tpu_torch")


def test_error_norm_algebra_equal():
    def run(pkg):
        ns = load(pkg)
        _, ctx = ctx_of(ns)
        PN, PMN, EN = ns.sim.PolyNorm, ns.sim.PolyMatrixNorm, ns.sim.ErrorNorm
        x = EN(PN.constant(ctx, 6), PMN.new(ctx, 1, ctx.m_g, 26))
        y = EN(PN.constant(ctx, 2), PMN.new(ctx, 1, ctx.m_g, 40))
        return [err(e) for e in (x + y, x - y, x * y, y * x, x.small_scalar_mul(None, [5, 3]),
                                 x.large_scalar_mul(None, [12345, 7]))]

    assert run("mxx_tpu") == run("mxx_tpu_torch")


def _modp_chain(ns, params, p_mod=7):
    """The circuit of test_simulator.py's bound test: Mul -> LUT -> Mul -> LUT."""
    circuit = ns.circuit.PolyCircuit()
    inputs = circuit.input(3)
    lut = ns.lookup.PublicLut.from_dict(params, {x: (x, x % p_mod) for x in range(p_mod * p_mod)})
    lut_id = circuit.register_public_lut(lut)
    t1m = circuit.public_lookup_gate(circuit.mul_gate(inputs[0], inputs[1]), lut_id)
    circuit.output([circuit.public_lookup_gate(circuit.mul_gate(t1m, inputs[2]), lut_id)])
    return circuit


def test_simulate_max_error_norm_lwe_equal():
    p_mod = 7

    def run(pkg):
        ns = load(pkg)
        params, ctx = ctx_of(ns)
        plt = ns.sim.NormPltLWEEvaluator(ctx, Decimal(4))
        outs = ns.sim.simulate_max_error_norm(
            _modp_chain(ns, params, p_mod), ctx, Decimal(p_mod - 1), 3, Decimal(4) * Decimal("6.5"),
            plt_evaluator=plt)
        q_over_2p_bits = (params.modulus // (2 * p_mod)).bit_length()
        return ([err(o) for o in outs], mat(plt.k_low), mat(plt.e_b_times_k_high),
                ns.sim.bits_ceil(outs[0].matrix_norm.poly_norm.norm), q_over_2p_bits)

    want, got = run("mxx_tpu"), run("mxx_tpu_torch")
    assert got == want
    assert len(got[0]) == 1 and got[3] < got[4]  # the crt-depth search's decodability test


@pytest.mark.parametrize("flavor", ["ggh15", "ggh15_secret", "commit", "commit_deep"])
def test_plt_norm_evaluators_equal(flavor):
    p_mod = 7

    def run(pkg):
        ns = load(pkg)
        params, ctx = ctx_of(ns)
        circuit = ns.circuit.PolyCircuit()
        inputs = circuit.input(1)
        lut = ns.lookup.PublicLut.from_dict(params, {x: (x, x % p_mod) for x in range(p_mod)})
        lid = circuit.register_public_lut(lut)
        circuit.output([circuit.public_lookup_gate(inputs[0], lid)])
        ev = {
            "ggh15": lambda: ns.plt_norms.NormPltGGH15Evaluator(ctx, Decimal(4), Decimal(4)),
            "ggh15_secret": lambda: ns.plt_norms.NormPltGGH15Evaluator(
                ctx, Decimal(4), Decimal(3), Decimal(2)),
            "commit": lambda: ns.plt_norms.NormPltCommitEvaluator(ctx, Decimal(4), 2, len(lut)),
            "commit_deep": lambda: ns.plt_norms.NormPltCommitEvaluator(ctx, Decimal(4), 3, 100),
        }[flavor]()
        outs = ns.sim.simulate_max_error_norm(
            circuit, ctx, Decimal(p_mod - 1), 1, Decimal(4) * Decimal("6.5"), ev)
        return [err(o) for o in outs]

    got = run("mxx_tpu_torch")
    assert got == run("mxx_tpu")
    assert got[0][1][2][0] > 0 and got[0][0][0] == Decimal(p_mod - 1)


@pytest.mark.parametrize("args", [(1024, 13.6, 2.83), (1024, 29.0), (1024, 26.0), (2048, 26.0),
                                  (8192, 224.0)])
def test_core_svp_security_bits_equal(args):
    got = [load(pkg).estimator.core_svp_security_bits(*args) for pkg in BOTH]
    assert got[0] == got[1]
    if args == (1024, 13.6, 2.83):  # NewHope1024's published primal core-SVP: ~255-282 bits
        assert 240 <= got[1] <= 300


def test_lattice_estimator_cli_absent():
    ns = load("mxx_tpu_torch")
    est = ns.estimator
    assert not est.estimator_cli_available()
    assert est.run_lattice_estimator_cli(
        1024, 60, est.LweDistSpec("ternary"), est.LweDistSpec("gaussian", sigma=4.0),
        timeout_secs=5) is None
    assert est.LweDistSpec("gaussian", sigma=4.0).to_json() == {"kind": "gaussian", "sigma": 4.0}
    assert est.heuristic_security_bits(65536, 1484) == load(
        "mxx_tpu").estimator.heuristic_security_bits(65536, 1484) > 100


def _plain_circuit(ns, params, ctx):
    c = ns.circuit.PolyCircuit()
    w = c.input(3)
    a = c.add_gate(w[0], w[1])
    m = c.mul_gate(a, w[2])
    s = c.small_scalar_mul(m, [5])
    ls = c.large_scalar_mul(s, [12345])
    c.output([ls, a])
    return c, 3, None


def _sub_circuit_lut(ns, params, ctx):
    main = ns.circuit.PolyCircuit()
    w = main.input(2)
    lut = ns.lookup.PublicLut.from_dict(params, {x: (x, x % 7) for x in range(49)})
    lid = main.register_public_lut(lut)
    sub = main.fresh_sub_circuit()
    sw = sub.input(2)
    sub.output([sub.mul_gate(sub.add_gate(sw[0], sw[1]), sw[0])])
    cid = main.register_sub_circuit(sub)
    o1 = main.call_sub_circuit(cid, [w[0], w[1]])
    o2 = main.call_sub_circuit_sum_many(cid, [[w[0], w[1]], [w[1], w[0]]])
    main.output([main.public_lookup_gate(o1[0], lid), o2[0]])
    return main, 2, ns.sim.NormPltLWEEvaluator(ctx, Decimal(4))


@pytest.mark.parametrize("build", [_plain_circuit, _sub_circuit_lut])
def test_affine_engine_equals_generic_and_jax(build):
    def run(pkg):
        ns = load(pkg)
        params, ctx = ctx_of(ns)
        circuit, ninp, plt = build(ns, params, ctx)
        generic = ns.sim.simulate_max_error_norm(
            circuit, ctx, Decimal(6), ninp, Decimal(26), plt)
        affine = ns.sim.simulate_max_error_norm_affine(
            circuit, ctx, Decimal(6), ninp, Decimal(26),
            ns.sim.AffineLWEWrapper(plt) if plt is not None else None)
        return [err(o) for o in generic], [err(o) for o in affine]

    generic, affine = run("mxx_tpu_torch")
    assert affine == generic
    assert affine == run("mxx_tpu")[1]
