"""The port's Goldreich PRG (`gadgets/fhe_prg/goldreich.py`), the PRG range
plans of `decoder/prg.py` and the material functions of
`noise_refresh/circuit_prg.py` against the JAX package: the same graph from
the same seed, the same plaintext PRG and CBD outputs, the same circuit gate
for gate, and one tiny PRG evaluation over RingGSW ciphertexts equal (the
graph and circuits are integer work, tolerance 0).
"""

import random

import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load

SEED = bytes(range(32))


def _edges(g):
    return [(e.xor_inputs, e.and_inputs) for e in g.edges]


@pytest.mark.parametrize("reject", [False, True])
def test_graphs_equal(reject):
    gj, gt = (load(p).goldreich for p in BOTH)
    full_j = gj.GoldreichGraph.generate(32, 64, SEED, reject)
    full_t = gt.GoldreichGraph.generate(32, 64, SEED, reject)
    assert _edges(full_j) == _edges(full_t) and full_t.output_size == 64
    assert len({e.role_aware_key() for e in full_t.edges}) == 64
    part_t = gt.GoldreichGraph.generate_range(32, 64, 10, 20, SEED, reject)
    assert _edges(part_t) == _edges(full_t)[10:30]
    assert _edges(part_t) == _edges(gj.GoldreichGraph.generate_range(32, 64, 10, 20, SEED, reject))
    for m in (1, 100, 1000, 12345):
        assert gj.minimum_goldreich_input_size(m) == gt.minimum_goldreich_input_size(m)
        assert gt.goldreich_output_bound_holds(gt.minimum_goldreich_input_size(m), m)
    with pytest.raises(AssertionError):
        gt.GoldreichEdge((0, 1, 2), (2, 3))


def test_plaintext_prg_and_cbd_equal():
    gj, gt = (load(p).goldreich for p in BOTH)
    rng = random.Random(4)
    bits = [rng.randrange(2) for _ in range(16)]
    out_t = gt.GoldreichFhePrg.setup(16, 32, SEED).evaluate_uniform(bits)
    assert out_t == gj.GoldreichFhePrg.setup(16, 32, SEED).evaluate_uniform(bits)
    assert 0 < sum(out_t) < len(out_t)
    ranged = gt.GoldreichFhePrg.setup_range(16, 32, 8, 8, SEED).evaluate_uniform(bits)
    assert ranged == out_t[8:16]
    cbd_t = gt.GoldreichFheCbdPrg(16, 6, 3, SEED).evaluate_uniform(bits)
    assert cbd_t == gj.GoldreichFheCbdPrg(16, 6, 3, SEED).evaluate_uniform(bits)
    assert all(-3 <= v <= 3 for v in cbd_t)


def test_prg_range_plans_equal():
    plans = []
    for pkg in BOTH:
        plan = load(pkg).prg.PrgRangePlan()
        got = [plan.allocate("seed", 9), plan.allocate("mask", 384), plan.allocate("cbd", 96)]
        with pytest.raises(AssertionError):
            plan.allocate("mask", 1)
        plans.append((got, plan.total, plan.range_of("mask"), dict(plan.ranges)))
    assert plans[0] == plans[1]
    assert plans[1][1] == 489 and plans[1][2] == (9, 384)


def test_output_sizes_equal():
    for pkg in BOTH:
        cp = load(pkg).circuit_prg
        sizes = cp.goldreich_noise_refresh_output_sizes(16, 3, 2, 4)
        assert (sizes.cbd_values, sizes.mask_bits, sizes.total) == (48, 384, 432)
        assert cp.goldreich_noise_refresh_uniform_output_bits(16, 3, 2, 4, cbd_n=2) == 576
    sj, st = (load(p).circuit_prg.derive_noise_refresh_graph_seed(SEED, b"NoiseRefreshCBD/v1", 3)
              for p in BOTH)
    assert sj == st


class _Symbolic:
    """A ciphertext stand-in that records the xor/and_/add/sub calls made on
    it, so the PRG's composition order compares without any GSW circuit."""

    def __init__(self, expr):
        self.expr = expr

    def xor(self, other, circuit):
        return _Symbolic(("xor", self.expr, other.expr))

    def and_(self, other, circuit):
        return _Symbolic(("and", self.expr, other.expr))

    def add(self, other, circuit):
        return _Symbolic(("add", self.expr, other.expr))

    def sub(self, other, circuit):
        return _Symbolic(("sub", self.expr, other.expr))


def _exprs(x):
    if isinstance(x, _Symbolic):
        return x.expr
    return [_exprs(v) for v in x]


def test_material_functions_compose_equally():
    """Full and ranged refresh material at a size no GSW circuit could take:
    the composition over symbolic ciphertexts is the whole of what these
    functions decide."""
    outs = []
    for pkg in BOTH:
        cp = load(pkg).circuit_prg
        seeds = [_Symbolic(i) for i in range(12)]
        mat = cp.build_noise_refresh_prg_material(None, seeds, SEED, 2, 2, 2, 2, 2)
        errs, masks = cp.build_ranged_prg_material_digit(None, seeds, SEED, 1, 2, 2, 2, 2, 2)
        cbd = load(pkg).goldreich.GoldreichFheCbdPrg(12, 3, 2, SEED).evaluate(seeds, None)
        outs.append((_exprs(mat.errors), _exprs(mat.masks), _exprs(errs), _exprs(masks),
                     _exprs(cbd)))
        assert len(mat.errors) == 4 and len(mat.masks) == 16 and len(errs) == 2
        assert [len(m) for m in masks] == [4, 4]
    assert outs[0] == outs[1]


def _prg_structure(ns):
    params = ns.params.RingParams.new(4, 1, 14, 1)
    circuit = ns.circuit.PolyCircuit()
    ctx = ns.ring_gsw.RingGswContext(circuit, params, 7)
    seeds = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in range(9)]
    mat = ns.circuit_prg.build_noise_refresh_prg_material(
        circuit, seeds, b"seed", ring_dim=1, log_base_q=1, crt_depth=1, v_bits=2, cbd_n=1)
    sizes = ns.circuit_prg.goldreich_noise_refresh_output_sizes(1, 1, 1, 2)
    assert len(mat.errors) == sizes.cbd_values and len(mat.masks) == sizes.mask_bits
    return params, circuit, mat


def test_prg_material_circuit_structurally_equal():
    """Four Goldreich bits over RingGSW ciphertexts (the case of
    `tests/test_noise_refresh_circuits.py`): 1,890,617 gates, built and
    compared, not evaluated."""
    (pj, cj, _), (pt, ct, _) = (_prg_structure(load(p)) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert ct.num_gates() == 1890617


class _PlainBit:
    """Boolean-ciphertext adapter over plain ints."""

    def __init__(self, b):
        self.b = b

    def xor(self, other, circuit):
        return _PlainBit(self.b ^ other.b)

    def and_(self, other, circuit):
        return _PlainBit(self.b & other.b)


def test_tiny_prg_evaluation_equal():
    rng = random.Random(6)
    bits = [rng.randrange(2) for _ in range(10)]
    outs = []
    for pkg in BOTH:
        prg = load(pkg).goldreich.GoldreichFhePrg.setup(10, 12, SEED)
        got = [o.b for o in prg.evaluate([_PlainBit(b) for b in bits], None)]
        assert got == prg.evaluate_uniform(bits)
        outs.append(got)
    assert outs[0] == outs[1]
