"""The port's GSW gadgets (`ring_gsw`, `plain_gsw`, `packed_ring_gsw`, the
mask circuits of `decoder/mask_circuit.py`) against the JAX package: native
encryption under the same `Drbg`, every circuit gate for gate, and the
decrypt, mask and error-decrypt cases of `tests/test_gsw_decrypt.py`
evaluated to the same integers over `Poly` wires on the CPU, and one ring
AND, every gate's wire, over BGG+ encodings. Integer work, tolerance 0. The packed circuits need vector wires and slot-transfer
evaluators, which the port does not have yet: they are held by structure and
by their native (host) functions.
"""

import importlib
import random

import numpy as np
import pytest

from test_torch_structure import BOTH, assert_circuits_equal, load

P_BITS = 7
RING = (4, 1, 14, 1)


def _setup(ns, ring=RING, p_bits=P_BITS, muls=2, basis="small"):
    params = ns.params.RingParams.new(*ring)
    circuit = ns.circuit.PolyCircuit()
    ctx = ns.ring_gsw.RingGswContext(circuit, params, p_bits, muls, p_basis=basis)
    return params, circuit, ctx


def _relation_holds(ns, ctx, native_ct, s, m):
    """(-s, 1).C == m * ((-s, 1).G) exactly (zero error)."""
    q, g, L = ctx.q_big, ns.ring_gsw.native_gadget_row(ctx), ctx.gadget_len
    for col in range(2 * L):
        got = ns.ring_gsw.native_decrypt_value(ctx, native_ct, s, col)
        want_g = (-s * g[col]) % q if col < L else g[col - L]
        if got != (m * want_g) % q:
            return False
    return True


@pytest.mark.parametrize("ring, p_bits, basis", [
    (RING, 7, "small"), ((16, 4, 28, 7), 8, "wide"), ((4, 1, 10, 10), 5, "small")])
def test_ring_native_encrypt_equal(ring, p_bits, basis):
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx = _setup(ns, ring, p_bits, 2, basis)
        rng = ns.rng.Drbg(b"gsw-native")
        s = ns.ring_gsw.sample_secret_key(rng)
        cts = [ns.ring_gsw.native_encrypt(ctx, s, m, rng, sigma)
               for m, sigma in [(0, 0.0), (1, 0.0), (1, 3.2)]]
        assert _relation_holds(ns, ctx, cts[0], s, 0) and _relation_holds(ns, ctx, cts[1], s, 1)
        probe = ns.ring_gsw.RingGswCiphertext(ctx, ([], []), 1)
        d = probe.gadget_decompose_value_consts(ctx.q_big // 4)
        assert sum(a * b for a, b in zip(d, ctx.gadget_row())) % ctx.q_big == ctx.q_big // 4
        outs.append((s, cts, ctx.gadget_row(), ctx.gadget_len, ctx.width, ctx.q_big, d))
    assert outs[0] == outs[1]


def test_plain_native_equal():
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params = ns.params.RingParams.new(16, 4, 28, 7)
        pg = ns.plain_gsw
        rng = ns.rng.Drbg(17)
        q = params.modulus
        ct = pg.native_encrypt(params, -1, 1, rng, 4, 0.0)
        noisy = pg.native_encrypt(params, 1, 3, rng, 4, 2.5)
        assert pg.native_decrypt(params, ct, -1, 4) == q // 4
        g, d = pg.gadget_values(params), pg.gadget_decompose_value(params, q // 4)
        assert sum(a * b for a, b in zip(g, d)) % q == q // 4
        k_poly, = [[1, q - 1, 0, 1]]
        ctp = pg.native_encrypt_poly(params, k_poly, 1, rng, 4, 0.0)
        assert pg.native_decrypt_poly(params, ctp, k_poly, 4) == [q // 4, 0, 0, 0]
        outs.append((ct, noisy, g, d, pg.decrypt_constants(params, noisy, 4), ctp,
                     pg.decrypt_constants_poly(params, ctp, 4),
                     pg.native_encrypt_poly(params, k_poly, 2, rng, 4, 1.5)))
    assert outs[0] == outs[1]


def test_packed_native_equal():
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx = _setup(ns, (4, 1, 10, 10), 5)
        pk, q = ns.packed, ctx.q_big
        rng = ns.rng.Drbg(11)
        k_poly, m_poly = [1, q - 1, 0, 1], [1, 0, 1, 0]
        ct = pk.native_encrypt_poly(ctx, k_poly, m_poly, rng)
        want = pk.native_decrypt_poly(ctx, ct, k_poly, 4)
        assert want == [m * (q // 4) % q for m in m_poly]
        noisy = pk.native_encrypt_poly(ctx, k_poly, m_poly, rng, 2.0)
        outs.append((ct, noisy, want, pk.native_combined_halves_poly(ctx, ct, 4),
                     pk.packed_input_values(ctx, ct), pk.ring_mul(k_poly, m_poly, q),
                     pk.embed_coeffs(params, [1, 2], 2), pk.subring_stride(params, 2)))
    assert outs[0] == outs[1]


# --------------------------------------------------- circuits, gate for gate


def _c_decrypt(ns, params, circuit, ctx):
    w = ns.ring_gsw.RingGswCiphertext.input(ctx, circuit)
    key = circuit.input(1)[0]
    sd, pb = w.decrypt(circuit, key, 2)
    circuit.output([circuit.add_gate(sd, pb)])
    return 1, [1], 1, lambda q: [q // 2 % q]


def _c_mask(ns, params, circuit, ctx):
    bits = [1, 0, 1]
    moduli = ns.mask_circuit.mask_plaintext_moduli_from_full_modulus(ctx.q_big, len(bits))
    ws = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in bits]
    key = circuit.input(1)[0]
    sd, pb = ns.mask_circuit.decrypt_bit_decomposed_parts(circuit, ws, key, moduli)
    total = circuit.add_gate(sd, pb)
    centered = ns.mask_circuit.decrypt_centered_bit_decomposed(circuit, params, ws, key, moduli)
    circuit.output([total, centered,
                    ns.mask_circuit.center_public_bottom(circuit, params, pb, len(bits))])
    def want(q):
        v = sum(b * (q // (q >> j)) for j, b in enumerate(bits)) % q
        return [v, (v + 4) % q, None]
    return -1, bits, 22, want


def _c_error(ns, params, circuit, ctx):
    w = ns.ring_gsw.RingGswCiphertext.input(ctx, circuit)
    key = circuit.input(1)[0]
    circuit.output([ns.mask_circuit.decrypt_error_as_value(circuit, w, key, ctx.q_big)])
    return 0, [1], 23, lambda q: [1]


def _c_batch(ns, params, circuit, ctx):
    msgs = [1, 0, 1, 1]
    ws = [ns.ring_gsw.RingGswCiphertext.input(ctx, circuit) for _ in msgs]
    key = circuit.input(1)[0]
    sd, pb = ns.ring_gsw.RingGswCiphertext.decrypt_batch(ws, circuit, key, ctx.q_big)
    circuit.output([circuit.add_gate(sd, pb)] + ws[0].add(ws[1], circuit).reduced(circuit)
                   .reconstruct(circuit)[:2])
    return 1, msgs, 31, lambda q: None


CASES = {"decrypt": _c_decrypt, "mask": _c_mask, "error_decrypt": _c_error,
         "decrypt_batch": _c_batch}


def _run_case(ns, name):
    params, circuit, ctx = _setup(ns)
    s, msgs, seed, want = CASES[name](ns, params, circuit, ctx)
    rng = random.Random(seed)
    inputs = []
    for m in msgs:
        native = ns.ring_gsw.native_encrypt(ctx, s, m, rng)
        inputs.extend(ns.ring_gsw.encode_ciphertext_inputs(ctx, native, **ns.kw))
    inputs.append(ns.const(params, -s))
    res = circuit.eval(params, ns.one(params), inputs,
                       plt_evaluator=ns.lookup.PolyPltEvaluator())
    return params, circuit, [r.coeffs() for r in res], want(ctx.q_big)


@pytest.mark.parametrize("name", list(CASES))
def test_decrypt_circuits_and_values_equal(name):
    (pj, cj, got_j, _), (pt, ct, got_t, want) = (_run_case(load(p), name) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert got_j == got_t
    if name == "decrypt_batch":
        assert got_t[0] == [1, 0, 1, 1]
    else:
        for got, w in zip(got_t, want):
            assert w is None or got == [w] + [0] * (pt.n - 1)


def _mul_xor(ns, op):
    params, circuit, ctx = _setup(ns)
    w1 = ns.ring_gsw.RingGswCiphertext.input(ctx, circuit)
    w2 = ns.ring_gsw.RingGswCiphertext.input(ctx, circuit, canonical=False)
    out = getattr(w1, op)(w2, circuit)
    circuit.output(out.flatten())
    rt = ns.ring_gsw.RingGswCiphertext.from_wires(ctx, out.flatten(), out.max_plaintext, False)
    assert rt.flatten() == out.flatten()
    return params, circuit, ctx, out


@pytest.mark.parametrize("op", ["mul", "xor", "and_", "sub"])
def test_homomorphic_circuits_structurally_equal(op):
    """109,201 gates for one external product at (4, 1, 14, 1); built, not
    evaluated (the evaluation is the slow test below)."""
    (pj, cj, _, oj), (pt, ct, _, ot) = (_mul_xor(load(p), op) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert oj.max_plaintext == ot.max_plaintext
    if op == "mul":
        assert ct.num_gates() == 109201


@pytest.mark.slow
def test_external_product_evaluates_equal():
    outs = []
    for pkg in BOTH:
        ns = load(pkg)
        params, circuit, ctx, prod = _mul_xor(ns, "mul")
        rng = random.Random(5)
        ct1 = ns.ring_gsw.native_encrypt(ctx, 1, 1, rng)
        ct2 = ns.ring_gsw.native_encrypt(ctx, 1, 1, rng)
        inputs = (ns.ring_gsw.encode_ciphertext_inputs(ctx, ct1, **ns.kw)
                  + ns.ring_gsw.encode_ciphertext_inputs(ctx, ct2, **ns.kw))
        res = circuit.eval(params, ns.one(params), inputs,
                           plt_evaluator=ns.lookup.PolyPltEvaluator())
        native, _ = ns.ring_gsw.decode_ciphertext_outputs(ctx, prod, res)
        assert _relation_holds(ns, ctx, native, 1, 1)
        outs.append(native)
    assert outs[0] == outs[1]


def test_ring_and_over_bgg_encodings_equal():
    """The Goldreich predicate's GSW product as real-mode Diamond iO runs it:
    one Ring-GSW AND of two ciphertexts' wires (nested-RNS Mul,
    SmallScalarMul and PubLut gates), reduced at the circuit boundary, over
    BGG+ encodings of the ciphertexts' wire values (in the port through the
    arena evaluator) at the smallest real-mode config, (2, 1, 12, 12) with a
    wide p-basis below 2^6: every output's vector, public key and plaintext
    equal to the JAX package's, bit for bit, from the same input encodings,
    and so is every other gate's wire."""
    from mxx_tpu_torch import convert
    from mxx_tpu_torch.bgg.lift import lift_constants_batched
    from mxx_tpu_torch.circuit.arena_eval import eval_arena
    from mxx_tpu_torch.matrix import rows

    key = bytes(range(32))
    port, jax = load("mxx_tpu_torch"), load("mxx_tpu")
    pbgg, jbgg = (importlib.import_module(f"{p}.bgg") for p in BOTH[::-1])
    pdebug, jdebug = (importlib.import_module(f"{p}.lookup.debug") for p in BOTH[::-1])
    sampler = importlib.import_module("mxx_tpu_torch.sampler")
    circuits = []
    for ns in (port, jax):
        params, _, ctx = _setup(ns, (2, 1, 12, 12), 6, 2, "wide")
        circuit = ctx.fresh_circuit()
        a, b = (ns.ring_gsw.RingGswCiphertext.input(ctx, circuit, canonical=False)
                for _ in range(2))
        out = a.and_(b, circuit).reduced(circuit).flatten()
        # every gate's wire is an output: the debug LUT evaluator's outputs
        # depend only on their inputs' plaintexts, so a vector or public key
        # is held where its gate computes it
        circuit.output(out + [g.gate_id for g in circuit.gates if g.kind != "Input"])
        circuits.append((params, ctx, circuit))
    (params, ctx, circuit), (jp, _, jcircuit) = circuits

    # the port's input encodings of two encryptions of 1, each carried over
    rng = random.Random(5)
    cts = [port.ring_gsw.native_encrypt(ctx, 1, 1, rng) for _ in range(2)]
    values = [x for ct in cts for row in ct for v in row
              for lvl in port.nested.encode_nested_rns_value(ctx.nested, v % ctx.q_big)
              for x in lvl]
    one = pbgg.BGGPublicKeySampler(key, 1, device="cpu").sample(params, b"gsw_and", [])[0]
    # a uniform secret: a ternary one at n=2 is zero one time in nine
    s = sampler.UniformSampler(seed=3, device="cpu").sample_uniform(
        params, 1, 1, sampler.FinRingDist())
    assert s.to_coeff().data.any()
    gadget = port.matrix.PolyMatrix.gadget_matrix(params, 1, "cpu")
    one_enc = pbgg.BggEncoding(s @ (one.matrix - gadget), one, port.one(params))
    ins = lift_constants_batched(params, one_enc, values)

    def to_jax(e):
        pk = jbgg.BggPublicKey(jax.matrix.PolyMatrix(convert.to_numpy(e.pubkey.matrix),
                                                     e.pubkey.matrix.fmt, jp),
                               e.pubkey.reveal_plaintext)
        return jbgg.BggEncoding(
            jax.matrix.PolyMatrix(convert.to_numpy(e.vector), e.vector.fmt, jp), pk,
            jax.poly.Poly(convert.to_numpy(e.plaintext), e.plaintext.fmt, jp))

    ev = pdebug.DebugBGGEncodingPltEvaluator(key, s)
    assert eval_arena(circuit, params, one_enc, ins, ev) is not None
    mine = circuit.eval(params, one_enc, ins, plt_evaluator=ev, batched=True)
    js = jax.matrix.PolyMatrix(convert.to_numpy(s), s.fmt, jp)
    theirs = jcircuit.eval(jp, to_jax(one_enc), [to_jax(e) for e in ins],
                           plt_evaluator=jdebug.DebugBGGEncodingPltEvaluator(key, js),
                           batched=True)
    assert len(mine) == len(theirs) == len(a.flatten()) + circuit.num_gates() - len(ins) - 1

    def planes(mats, jax_side):
        """[W, L, ...] EVAL residues of a side's matrices or polys."""
        if jax_side:
            return np.stack([np.asarray(m.to_eval().data) for m in mats]).astype(np.int64)
        return rows.stack(params, mats).transpose(0, 1).numpy()

    for part in (lambda w: w.vector, lambda w: w.pubkey.matrix, lambda w: w.plaintext):
        np.testing.assert_array_equal(planes([part(w) for w in mine], False),
                                      planes([part(w) for w in theirs], True))


def _packed(ns):
    params, circuit, ctx = _setup(ns, (4, 1, 10, 10), 5)
    pk = ns.packed
    w = pk.PackedRingGswCiphertext.input(ctx, circuit, 4)
    w2 = pk.PackedRingGswCiphertext.input(ctx, circuit, 4)
    key = circuit.input(1)[0]
    sd, pb = w.decrypt(circuit, key, 4)
    sd2, pb2 = w.add(w2, circuit).reduced(circuit).decrypt_embedded(circuit, params, key, 4)
    sd3, pb3 = pk.packed_decrypt_bit_decomposed_parts(circuit, params, [w, w2], key, [4], 4)
    circuit.output([sd, pb, sd2, pb2, sd3, pb3] + w.sub(w2, circuit).flatten()[:3])
    assert pk.PackedRingGswCiphertext.from_wires(ctx, w.flatten(), 4).flatten() == w.flatten()
    mul = ctx.fresh_circuit()
    a = pk.PackedRingGswCiphertext.input(ctx, mul, 2)
    b = pk.PackedRingGswCiphertext.input(ctx, mul, 2)
    mul.output(a.and_(b, mul).flatten())
    return params, circuit, mul


def test_packed_circuits_structurally_equal():
    (pj, cj, mj), (pt, ct, mt) = (_packed(load(p)) for p in BOTH)
    assert_circuits_equal(cj, ct, pj, pt)
    assert_circuits_equal(mj, mt, pj, pt)
    assert mt.gate_counts().get("SlotTransfer", 0) > 0
