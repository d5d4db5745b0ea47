"""`mxx_tpu_torch.gadgets.fhe.ckks` and `gadgets.mod_switch` against the JAX
package: the host helpers (encrypt, decrypt, relinearization keys, packed
encrypt) under the same `random.Random`, the serde JSON of each CKKS circuit
(equal string for string) and its gates and LUTs, and the outputs of the
cases of `tests/test_ckks.py` evaluated over `Poly` wires on the CPU (equal
integers; the decrypts within 0.1 of the product, as there), and the
port's rescale error inside its bookkeeping bound at 28-bit moduli. Each
package's mul case runs once per module, in a fixture. The slot-packed case
is `slow`, as the JAX package's own."""

import random
from decimal import Decimal

import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load

P_BITS = 8
SCALE = 1 << 17
RING = (16, 3, 20, 5)


def _ctx(ns, ring=RING, **kw):
    params = ns.params.RingParams.new(*ring)
    circuit = ns.circuit.PolyCircuit()
    ctx = ns.ckks.CKKSContext(circuit, params, kw.pop("p_bits", P_BITS), max_unreduced_muls=2,
                              scale=kw.pop("scale", SCALE), relinearization_extra_levels=1, **kw)
    return params, circuit, ctx


def _inputs(ns, ctx, params, cts, eval_keys=None):
    """Constant polys of the nested-RNS residues: each ciphertext at offset
    1 over 2 levels, then the eval keys over the full window."""
    out = []
    for c0, c1 in cts:
        for v in (c0, c1):
            for row in ns.nested.encode_nested_rns_value(ctx.nested, v, 1, 2):
                out.extend(ns.const(params, r) for r in row)
    for v in eval_keys or ():
        for row in ns.nested.encode_nested_rns_value(ctx.nested, v, 0, 3):
            out.extend(ns.const(params, r) for r in row)
    return out


def _decode(ns, ctx, values, pos, offset, levels):
    k = ctx.nested.k
    out = []
    for _ in range(2):
        rows = []
        for _ in range(levels):
            rows.append(values[pos:pos + k])
            pos += k
        out.append(ns.nested.decode_nested_rns_outputs(ctx.nested, rows, offset, levels))
    return out[0], out[1], pos


def _mul_case(pkg):
    """tests/test_ckks.py::test_ckks_mul_relinearize_rescale in `pkg`:
    (circuit, params, JSON, output integers, decrypted product, rescaled)."""
    ns = load(pkg)
    params, circuit, ctx = _ctx(ns)
    rng = random.Random(71)
    s, m1, m2 = 2, 3, 5
    cts = [ns.ckks.encrypt(ctx, s, m, rng) for m in (m1, m2)]
    ek = ns.ckks.sample_relinearization_eval_keys(ctx, s, rng)
    w1 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
    w2 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
    ekw = ns.ckks.CKKSCiphertext.alloc_eval_keys(ctx, circuit)
    prod = w1.mul(w2, ekw, circuit)
    scaled = prod.rescale(circuit)
    circuit.output(prod.flatten() + scaled.flatten())
    raw = ns.serde.circuit_to_json(circuit)
    outs = circuit.eval(params, ns.one(params), _inputs(ns, ctx, params, cts, ek),
                        plt_evaluator=ns.lookup.PolyPltEvaluator())
    values = [o.const_coeff() for o in outs]
    c0p, c1p, pos = _decode(ns, ctx, values, 0, 1, 2)
    c0r, c1r, _ = _decode(ns, ctx, values, pos, 1, 1)
    removed = ctx.nested.q_moduli[2]
    return dict(circuit=circuit, params=params, json=raw, values=values,
                bounds=(prod.error_bounds, scaled.error_bounds),
                prod=ns.ckks.decrypt(ctx, s, c0p, c1p, 2, scale=SCALE * SCALE),
                rescaled=ns.ckks.decrypt(ctx, s, c0r, c1r, 1, scale=SCALE * SCALE / removed))


@pytest.fixture(scope="module")
def jax_mul():
    return _mul_case("mxx_tpu")


@pytest.fixture(scope="module")
def port_mul():
    return _mul_case("mxx_tpu_torch")


def test_host_helpers_equal():
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        _, _, ctx = _ctx(ns)
        rng = random.Random(5)
        outs.append((ns.ckks.encrypt(ctx, 3, 7, rng, error_sigma=3.2),
                     ns.ckks.encrypt(ctx, 1, -2, rng, levels=1),
                     ns.ckks.sample_relinearization_eval_keys(ctx, 3, rng, error_sigma=3.2),
                     ctx.level_offset, ctx.max_active_levels, ctx.p_factor(),
                     [ctx.mod_down_slack(i) for i in range(ctx.nested.q_moduli_depth)],
                     ns.ckks.decrypt(ctx, 3, 12345, 678, 2)))
        _, _, pctx = _ctx(ns, (4, 3, 16, 8), scale=1 << 13, num_slots=4)
        c0, c1 = ns.ckks.encrypt_packed(pctx, 2, [1, 2, 0, 1], rng, error_sigma=1.0)
        outs[-1] += (c0, c1, ns.ckks.decrypt_packed(pctx, 2, c0, c1, 2))
    assert outs[0] == outs[1]


def test_mul_circuit_json_and_structure_equal(jax_mul, port_mul):
    mine = port_mul
    assert mine["json"] == jax_mul["json"]
    assert_circuits_equal(jax_mul["circuit"], mine["circuit"], jax_mul["params"], mine["params"])
    assert mine["bounds"] == jax_mul["bounds"]


def test_mul_outputs_equal(jax_mul, port_mul):
    mine = port_mul
    assert mine["values"] == jax_mul["values"]
    assert abs(mine["prod"] - 15) < 0.1 and abs(mine["rescaled"] - 15) < 0.1
    assert (mine["prod"], mine["rescaled"]) == (jax_mul["prod"], jax_mul["rescaled"])


@pytest.mark.parametrize("scale_bits", [17, 24])
def test_rescale_error_within_its_bound(scale_bits):
    """At 28-bit moduli the rescaled product's decrypt error stays inside the
    circuit's error bookkeeping, and that bound over scale^2 / q_dropped is
    what decides the decode: the JAX tests' scale 2^17 leaves 2^6 and
    misses 15 by more than 1, 2^24 decodes within 0.1 (chip_smoke's `ckks`
    phase runs at 2^24)."""
    ns = load("mxx_tpu_torch")
    scale = 1 << scale_bits
    params, circuit, ctx = _ctx(ns, (16, 3, 28, 14), scale=scale)
    rng = random.Random(71)
    s = 2
    cts = [ns.ckks.encrypt(ctx, s, m, rng) for m in (3, 5)]
    ek = ns.ckks.sample_relinearization_eval_keys(ctx, s, rng)
    w1 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
    w2 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
    ekw = ns.ckks.CKKSCiphertext.alloc_eval_keys(ctx, circuit)
    scaled = w1.mul(w2, ekw, circuit).rescale(circuit)
    circuit.output(scaled.flatten())
    outs = circuit.eval(params, ns.one(params), _inputs(ns, ctx, params, cts, ek),
                        plt_evaluator=ns.lookup.PolyPltEvaluator())
    c0, c1, _ = _decode(ns, ctx, [o.const_coeff() for o in outs], 0, 1, 1)
    rescaled = scale * scale / ctx.nested.q_moduli[2]
    err = abs(ns.ckks.decrypt(ctx, s, c0, c1, 1, scale=rescaled) - 15)
    bound = (scaled.error_bounds[0] + s * scaled.error_bounds[1]) / rescaled
    assert err <= bound
    if scale_bits == 24:
        assert bound < 0.1
    else:
        assert err > 1 and bound > 1


def test_add_equal():
    """tests/test_ckks.py::test_ckks_add in both packages."""
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx = _ctx(ns)
        rng = random.Random(72)
        cts = [ns.ckks.encrypt(ctx, 1, m, rng) for m in (4, 7)]
        w1 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
        w2 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
        circuit.output(w1.add(w2, circuit).flatten())
        res = circuit.eval(params, ns.one(params), _inputs(ns, ctx, params, cts),
                           plt_evaluator=ns.lookup.PolyPltEvaluator())
        values = [o.const_coeff() for o in res]
        c0, c1, _ = _decode(ns, ctx, values, 0, 1, 2)
        got = ns.ckks.decrypt(ctx, 1, c0, c1, 2)
        assert abs(got - 11) < 1e-9
        outs.append((ns.serde.circuit_to_json(circuit), values, got))
    assert outs[0] == outs[1]


def test_mod_switch_equal():
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx = _ctx(ns)
        x = ns.nested.NestedRnsPoly.input(ctx.nested, circuit, 0, 3)
        dropped = ns.mod_switch.drop_levels(x, 2)
        circuit.output(dropped.flatten())
        qs = list(ctx.nested.q_moduli)
        v = 2**50 + 12345
        outs.append((ns.serde.circuit_to_json(circuit), dropped.levels,
                     list(dropped.value_bounds), list(dropped.trace_bounds),
                     ns.mod_switch.rescale_value(v, qs, qs[:2]),
                     ns.mod_switch.rescale_error_bound(2, Decimal(4))))
        with pytest.raises(AssertionError):
            ns.mod_switch.drop_levels(x, 4)
    assert outs[0] == outs[1]


@pytest.mark.slow
def test_packed_slots_mul_rescale_equal():
    """tests/test_ckks.py::test_ckks_packed_slots_mul_rescale in both
    packages, over PolyVec wires: equal circuits, equal slot integers."""
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx = _ctx(ns, (4, 3, 16, 8), scale=1 << 13, num_slots=4)
        rng = random.Random(73)
        s, ns_, k = 2, 4, ctx.nested.k
        ct1 = ns.ckks.encrypt_packed(ctx, s, [1, 2, 0, 1], rng)
        ct2 = ns.ckks.encrypt_packed(ctx, s, [2, 0, 1, 1], rng)
        ek = ns.ckks.sample_relinearization_eval_keys(ctx, s, rng)
        w1 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
        w2 = ns.ckks.CKKSCiphertext.input(ctx, circuit)
        ekw = ns.ckks.CKKSCiphertext.alloc_eval_keys(ctx, circuit)
        prod = w1.to_eval_domain(circuit).mul(w2.to_eval_domain(circuit), ekw, circuit)
        out = prod.rescale(circuit).to_coeff_domain(circuit)
        circuit.output(out.flatten())
        rows = []
        for ct in (ct1, ct2):
            for comp in ct:
                enc = [ns.nested.encode_nested_rns_value(ctx.nested, v, 1, 2) for v in comp]
                rows += [[enc[c][lvl][i] for c in range(ns_)] for lvl in range(2)
                         for i in range(k)]
        for v in ek:
            for row in ns.nested.encode_nested_rns_value(ctx.nested, v, 0, 3):
                rows.extend([[r] * ns_ for r in row])
        vec = ns.poly_vec.PolyVec
        res = circuit.eval(params, vec.const(params, [1] * ns_, **ns.kw),
                           [vec.const(params, r, **ns.kw) for r in rows],
                           plt_evaluator=ns.vec_eval.PolyVecPltEvaluator(),
                           slot_transfer_evaluator=ns.slot_transfer.PolyVecSlotTransferEvaluator())
        values = [[p.const_coeff() for p in o.slots] for o in res]
        comps = []
        for base in (0, k):
            comps.append([ns.nested.decode_nested_rns_outputs(
                ctx.nested, [[values[base + i][slot] for i in range(k)]], 1, 1)
                for slot in range(ns_)])
        got = ns.ckks.decrypt_packed(ctx, s, comps[0], comps[1], 1,
                                     scale=(1 << 26) / ctx.nested.q_moduli[2])
        # m1 * m2 in Z[x]/(x^4 + 1): [1, 2, 0, 1] * [2, 0, 1, 1]
        assert all(abs(g - w) < 0.5 for g, w in zip(got, [0, 3, 0, 5])), got
        outs.append((ns.serde.circuit_to_json(circuit), values))
    assert outs[0] == outs[1]
