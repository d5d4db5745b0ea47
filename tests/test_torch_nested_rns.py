"""`mxx_tpu_torch.gadgets.arith.nested_rns` (and `gadgets.conv_mul`) against
the JAX package: the contexts' integers, every circuit gate for gate, and the
values the circuits evaluate to over `Poly` wires on the CPU. Integer work
throughout, tolerance 0. The integers checked are those of
`tests/test_nested_rns.py`. Circuits with slot-transfer gates (the packed
negacyclic convolution) are held by structure only: the port has no vector
wires to evaluate them over yet.
"""

import math
import random

import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load

# (ring, p_moduli_bits, p_basis, max_unreduced_muls): the JAX tests' own
# choices, and the wide basis where the ring modulus has room for its LUTs
CONTEXTS = [
    ((4, 1, 14, 1), 7, "small", 2),
    ((4, 2, 17, 17), 8, "small", 2),
    ((16, 4, 28, 7), 8, "small", 2),
    ((16, 4, 28, 7), 8, "wide", 2),
    ((16, 4, 28, 7), 7, "wide", 2),
    ((4, 3, 10, 10), 5, "small", 2),
    ((4, 3, 10, 10), 6, "wide", 2),
    ((16, 4, 28, 7), 8, "small", 3),
]
CTX_ATTRS = [
    "p_moduli", "k", "scale", "p_full", "p_half", "p_over_pis", "p_max", "sum_p",
    "full_reduce_max_plaintexts", "lut_mod_p_domain", "scalars_y", "scalars_v",
    "gadget_values", "lut_mod_p_ids", "lut_x_to_y_ids", "lut_x_to_real_ids",
    "lut_real_to_v_id", "q_moduli", "q_moduli_depth", "max_unreduced_muls", "p_basis",
]


def _ctx(ns, ring, p_bits, basis="small", muls=2, scale=None):
    params = ns.params.RingParams.new(*ring)
    circuit = ns.circuit.PolyCircuit()
    ctx = ns.nested.NestedRnsPolyContext(circuit, params, p_bits, muls, scale=scale,
                                         p_basis=basis)
    return params, circuit, ctx


@pytest.mark.parametrize("ring, p_bits, basis, muls", CONTEXTS)
def test_contexts_equal(ring, p_bits, basis, muls):
    (pj, cj, xj), (pt, ct, xt) = (_ctx(load(p), ring, p_bits, basis, muls) for p in BOTH)
    for attr in CTX_ATTRS:
        assert getattr(xj, attr) == getattr(xt, attr), attr
    assert xj.decomposition_len() == xt.decomposition_len()
    for off, lv in [(0, None), (0, 1), (len(xj.q_moduli) - 1, 1)]:
        assert xj.active_q(off, lv) == xt.active_q(off, lv)
        assert xj.reconstruction_coeffs(off, lv) == xt.reconstruction_coeffs(off, lv)
    assert_circuits_equal(cj, ct, pj, pt)
    fj, ft = xj.fresh_circuit(), xt.fresh_circuit()
    assert fj.luts is xj.luts and ft.luts is xt.luts


def test_an_explicit_scale_and_the_basis_samplers():
    (_, _, xj), (_, _, xt) = (_ctx(load(p), (16, 4, 28, 7), 8, "wide", 2, scale=4096)
                              for p in BOTH)
    assert xj.scale == xt.scale == 4096
    nj, nt = (load(p).nested for p in BOTH)
    for args in [(8, 131071, 2), (7, (1 << 28) - 57, 2), (6, 1021, 3)]:
        assert nj.sample_crt_primes(*args) == nt.sample_crt_primes(*args)
    for args in [(8, (1 << 28) - 57, 2), (9, 131071, 2)]:
        assert nj.sample_crt_primes_wide(*args) == nt.sample_crt_primes_wide(*args)
    with pytest.raises(ValueError):
        nt.sample_crt_primes(3, 1 << 28, 2)


def test_encode_decode_equal():
    (_, _, xj), (_, _, xt) = (_ctx(load(p), (16, 4, 28, 7), 8) for p in BOTH)
    nj, nt = (load(p).nested for p in BOTH)
    rng = random.Random(3)
    q = math.prod(xj.q_moduli)
    for _ in range(5):
        v = rng.randrange(q)
        for off, lv in [(0, None), (1, 2)]:
            ej = nj.encode_nested_rns_value(xj, v, off, lv)
            assert ej == nt.encode_nested_rns_value(xt, v, off, lv)
            got = nt.decode_nested_rns_outputs(xt, ej, off, lv)
            assert got == nj.decode_nested_rns_outputs(xj, ej, off, lv)
            assert got == v % math.prod(xt.active_q(off, lv))


# --------------------------------------------------- circuits, gate for gate


def _b_add_mul(c, w, nested):
    return [w[0].add(w[1], c).mul(w[0], c).full_reduce(c)]


def _b_sub(c, w, nested):
    return [w[0].sub(w[1], c).full_reduce(c)]


def _b_chain(c, w, nested):
    acc = w[0]
    for x in w[1:]:
        acc = acc.mul(x, c)
    return [acc]


def _b_const_mul(c, w, nested):
    return [w[0].const_mul(0, c), w[0].const_mul(12345, c), w[0].lazy_reduce(c),
            w[0].const_mul_per_level([3] * w[0].levels, c)]


def _b_decompose(c, w, nested):
    return w[0].gadget_decompose(c)


CIRCUITS = {
    "add_mul_full_reduce": (_b_add_mul, 2, (4, 2, 17, 17), 8),
    "sub": (_b_sub, 2, (4, 2, 17, 17), 8),
    "deep_chain": (_b_chain, 4, (4, 2, 17, 17), 8),
    "const_mul": (_b_const_mul, 1, (4, 2, 17, 17), 8),
    "gadget_decompose": (_b_decompose, 1, (4, 2, 17, 17), 8),
    "mul_wide": (_b_add_mul, 2, (16, 4, 28, 7), 8),
}
VALUES = {
    "add_mul_full_reduce": lambda q, a, b: [(a + b) * a % q],
    "sub": lambda q, a, b: [(a - b) % q],
    "deep_chain": lambda q, *v: [math.prod(v) % q],
}
VALUES["mul_wide"] = VALUES["add_mul_full_reduce"]


def _build_and_eval(ns, name, values):
    build, n_in, ring, p_bits = CIRCUITS[name]
    basis = "wide" if name.endswith("wide") else "small"
    params, circuit, ctx = _ctx(ns, ring, p_bits, basis)
    wires = [ns.nested.NestedRnsPoly.input(ctx, circuit) for _ in range(n_in)]
    outs = build(circuit, wires, ns.nested)
    circuit.output([w for o in outs for w in o.flatten()])
    inputs = [ns.const(params, r) for v in values
              for row in ns.nested.encode_nested_rns_value(ctx, v) for r in row]
    res = circuit.eval(params, ns.one(params), inputs,
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    raw = [r.const_coeff() for r in res]
    decoded, pos = [], 0
    for o in outs:
        rows = [raw[pos + l * ctx.k: pos + (l + 1) * ctx.k] for l in range(o.levels)]
        pos += o.levels * ctx.k
        decoded.append(ns.nested.decode_nested_rns_outputs(ctx, rows))
    bounds = [(o.value_bounds, o.trace_bounds, o.level_offset, o.enable_levels) for o in outs]
    return params, circuit, ctx, raw, decoded, bounds


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_circuits_and_values_equal(name):
    rng = random.Random(7)
    n_in = CIRCUITS[name][1]
    nsj, nst = (load(p) for p in BOTH)
    q = nsj.params.RingParams.new(*CIRCUITS[name][2]).modulus
    values = [rng.randrange(q) for _ in range(n_in)]
    pj, cj, xj, raw_j, dec_j, bounds_j = _build_and_eval(nsj, name, values)
    pt, ct, xt, raw_t, dec_t, bounds_t = _build_and_eval(nst, name, values)
    assert_circuits_equal(cj, ct, pj, pt)
    assert bounds_j == bounds_t
    assert raw_j == raw_t and dec_j == dec_t
    if name in VALUES:
        assert [d % q for d in dec_t] == VALUES[name](q, *values)
    if name == "gadget_decompose":
        probe = nst.nested.NestedRnsPoly(xt, [[0] * xt.k] * xt.q_moduli_depth, 0, None,
                                         [0] * xt.q_moduli_depth, [0] * xt.q_moduli_depth)
        scalars = probe.gadget_scalars()
        assert scalars == nsj.nested.NestedRnsPoly(
            xj, [[0] * xj.k] * xj.q_moduli_depth, 0, None,
            [0] * xj.q_moduli_depth, [0] * xj.q_moduli_depth).gadget_scalars()
        assert len(scalars) == len(dec_t) == xt.q_moduli_depth * (xt.k + 1)
        assert sum(t * g for t, g in zip(dec_t, scalars)) % q == values[0] % q


def _reconstruct(ns, a, b):
    params, circuit, ctx = _ctx(ns, (4, 2, 17, 17), 8)
    w0 = ns.nested.NestedRnsPoly.input(ctx, circuit)
    w1 = ns.nested.NestedRnsPoly.input(ctx, circuit)
    circuit.output([w0.mul(w1, circuit).reconstruct(circuit)])
    inputs = [ns.const(params, r) for v in (a, b)
              for row in ns.nested.encode_nested_rns_value(ctx, v) for r in row]
    res = circuit.eval(params, ns.one(params), inputs,
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    return params, circuit, res[0].const_coeff()


def test_reconstruct_wire():
    a, b = 31337, 271828
    (pj, cj, vj), (pt, ct, vt) = (_reconstruct(load(p), a, b) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert vj == vt == a * b % pt.modulus


def _window(ns, value, offset, levels, build):
    params, circuit, ctx = _ctx(ns, (16, 4, 28, 7), 8)
    wire = ns.nested.NestedRnsPoly.input(ctx, circuit, offset, levels)
    out = build(circuit, wire)
    circuit.output(out.flatten())
    inputs = [ns.const(params, r)
              for row in ns.nested.encode_nested_rns_value(ctx, value, offset, levels)
              for r in row]
    res = circuit.eval(params, ns.one(params), inputs,
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    raw = [r.const_coeff() for r in res]
    rows = [raw[l * ctx.k:(l + 1) * ctx.k] for l in range(out.levels)]
    got = ns.nested.decode_nested_rns_outputs(ctx, rows, out.level_offset, out.levels)
    return params, circuit, ctx, raw, got


WINDOWS = {
    "mod_down_last": (123456789, 0, 3, lambda c, w: w.mod_down_one_level(c)),
    "mod_down_first": (987654321, 0, 2, lambda c, w: w.mod_down_one_level(c, drop_first=True)),
    "mod_up_front": (55555555, 1, 2, lambda c, w: w.mod_up_front(c, 1)),
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_mod_switch_circuits_and_values_equal(name):
    value, off, lv, build = WINDOWS[name]
    (pj, cj, xj, raw_j, got_j), (pt, ct, xt, raw_t, got_t) = (
        _window(load(p), value, off, lv, build) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert raw_j == raw_t and got_j == got_t
    qs = xt.q_moduli
    if name == "mod_up_front":
        window = qs[1] * qs[2]
        assert got_t % window == value % window
    else:
        drop = 2 if name == "mod_down_last" else 0
        keep = qs[0] * qs[1] if drop == 2 else qs[1]
        x = value % (qs[0] * qs[1] * qs[2]) if drop == 2 else value % (qs[0] * qs[1])
        want = (x - x % qs[drop]) // qs[drop]
        slack = xt.full_reduce_max_plaintexts[drop] // qs[drop] + 1
        diff = (got_t - want) % keep
        assert min(diff, keep - diff) <= slack


def _conv(ns):
    params, circuit, ctx = _ctx(ns, (4, 3, 10, 10), 5)
    a = ns.nested.NestedRnsPoly.input(ctx, circuit)
    b = ns.nested.NestedRnsPoly.input(ctx, circuit)
    out = ns.nested.nested_rns_negacyclic_conv(a, b, circuit, 4).full_reduce(circuit)
    circuit.output(out.flatten())
    plain = ns.circuit.PolyCircuit()
    x, y = plain.input(2)
    lut = plain.register_public_lut(ns.lookup.PublicLut.from_dict(
        params, {t: (t, t % 5) for t in range(25)}))
    plain.output([
        ns.conv_mul.negacyclic_conv_mul(plain, x, y, 4),
        ns.conv_mul.negacyclic_conv_mul_plaintext(plain, x, [1, 0, 7, 3], 4, 5, lut),
        ns.conv_mul.negacyclic_conv_mul_plaintext(plain, x, [0, 5, 0, 0], 4, 5),
    ])
    ntt = ns.circuit.PolyCircuit()
    c2 = ns.nested.NestedRnsPolyContext(ntt, params, 5, 2)
    w = ns.nested.NestedRnsPoly.input(c2, ntt)
    fwd = ns.nested.nested_level_ntt(w, ntt, 4)
    ntt.output(ns.nested.nested_level_ntt(fwd, ntt, 4, inverse=True).flatten())
    return params, circuit, plain, ntt


def test_slot_packed_circuits_structurally_equal():
    (pj, cj, plain_j, ntt_j), (pt, ct, plain_t, ntt_t) = (_conv(load(p)) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert_circuits_equal(plain_j, plain_t, pj, pt)
    assert_circuits_equal(ntt_j, ntt_t, pj, pt)
    assert ct.gate_counts().get("SlotTransfer", 0) > 0
