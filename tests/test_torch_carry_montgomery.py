"""`mxx_tpu_torch.gadgets.arith.carry_montgomery` against the JAX package:
the contexts' integers, the serde JSON of each circuit (equal string for
string) and its gates and LUTs, and the cases of
`tests/test_carry_montgomery.py` evaluated over `Poly` wires on the CPU to
the same integers, which decode to the sum, the product and the Montgomery
product. Integer work, tolerance 0."""

import random

import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load

LIMB_BITS = 4
NUM_LIMBS = 4
N_MOD = 64513  # odd modulus below 2^16


def _run(ns, params, circuit, values, wires):
    circuit.output(wires)
    res = circuit.eval(params, ns.one(params), [ns.const(params, v) for v in values],
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    return [r.const_coeff() for r in res]


def _add_mul(pkg):
    ns = load(pkg)
    params = ns.params.RingParams.default()
    circuit = ns.circuit.PolyCircuit()
    cm = ns.carry
    ctx = cm.CarryArithContext(circuit, params, LIMB_BITS, NUM_LIMBS)
    a, b = cm.CarryArithPoly.input(ctx, circuit), cm.CarryArithPoly.input(ctx, circuit)
    s = a.add(b, circuit).normalize(circuit)
    p = a.mul(b, circuit)
    x, y = 30000, 25000
    vals = _run(ns, params, circuit, cm.CarryArithPoly.encode(ctx, x)
                + cm.CarryArithPoly.encode(ctx, y), s.limbs + p.limbs)
    base_k = ctx.base**NUM_LIMBS
    assert cm.CarryArithPoly.decode(ctx, vals[:NUM_LIMBS]) == (x + y) % base_k
    assert cm.CarryArithPoly.decode(ctx, vals[NUM_LIMBS:]) == (x * y) % base_k
    return circuit, params, vals, (ctx.base, ctx.domain, ctx.lut_lo, ctx.lut_hi)


def _mont(pkg):
    ns = load(pkg)
    params = ns.params.RingParams.default()
    circuit = ns.circuit.PolyCircuit()
    cm = ns.carry
    ctx = cm.CarryArithContext(circuit, params, LIMB_BITS, NUM_LIMBS)
    mont = cm.MontgomeryContext(ctx, N_MOD)
    rng = random.Random(13)
    x, y = rng.randrange(N_MOD), rng.randrange(N_MOD)
    a, b = cm.CarryArithPoly.input(ctx, circuit), cm.CarryArithPoly.input(ctx, circuit)
    prod = mont.mont_mul(a, b, circuit)
    vals = _run(ns, params, circuit, cm.CarryArithPoly.encode(ctx, mont.to_mont_value(x))
                + cm.CarryArithPoly.encode(ctx, mont.to_mont_value(y)), prod.limbs)
    got = cm.CarryArithPoly.decode(ctx, vals) % N_MOD  # REDC leaves a value below 2N
    assert mont.from_mont_value(got) == x * y % N_MOD
    return circuit, params, vals, (mont.r, mont.n_prime, mont.r2)


@pytest.mark.parametrize("case", [_add_mul, _mont])
def test_circuits_and_outputs_equal(case):
    (cj, pj, vj, ij), (ct, pt, vt, it) = (case(pkg) for pkg in BOTH)
    assert load("mxx_tpu_torch").serde.circuit_to_json(ct) == load(
        "mxx_tpu").serde.circuit_to_json(cj)
    assert_circuits_equal(cj, ct, pj, pt)
    assert vt == vj
    assert it == ij
