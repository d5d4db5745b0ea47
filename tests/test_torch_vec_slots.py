"""Vector wires, slot transfer/reduce and the slotwise LUT of the port,
against the JAX package (mirrors `tests/test_vec_slots.py`).

Every test runs the same calls in `mxx_tpu` and `mxx_tpu_torch` (on the CPU)
and holds the port's wires to the JAX package's bit for bit, besides the
plaintext checks of the JAX test. It also holds the level-batched evaluator
over vec wires equal to the sequential one.
"""

import importlib
from types import SimpleNamespace

import numpy as np

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))
BOTH = ("mxx_tpu", "mxx_tpu_torch")


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "circuit": "circuit",
            "poly_vec": "circuit.poly_vec", "vec": "bgg.vec", "lookup": "lookup",
            "vec_eval": "lookup.vec_eval", "sampler": "sampler", "st": "slot_transfer",
            "debug": "lookup.debug"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    ns.torch = pkg == "mxx_tpu_torch"
    return ns


def _np(x):
    return x.data.cpu().numpy().astype(np.uint32) if hasattr(x.data, "cpu") else np.asarray(x.data)


def _same(a, b):
    """Equal residues in COEFF form (a Poly or PolyMatrix of either package)."""
    np.testing.assert_array_equal(_np(a.to_coeff() if hasattr(a, "to_coeff") else a),
                                  _np(b.to_coeff() if hasattr(b, "to_coeff") else b))


def _polyvec_transfer(ns):
    params = ns.params.RingParams.default()
    ev = ns.st.PolyVecSlotTransferEvaluator()
    v = ns.poly_vec.PolyVec.const(params, [5, 6, 7], **ns.kw)
    out = ev.slot_transfer(params, v, [(2, None), (0, 3), (1, None)], 0)
    rot = ev.slot_transfer(params, v, ns.circuit.SlotTransferSpec.rotation(1, 3).materialize(), 0)
    red = ev.slot_reduce(params, [v, v], 3, 0)
    return out, rot, red


def test_polyvec_slot_transfer_and_reduce():
    (out, rot, red), (jout, jrot, jred) = (_polyvec_transfer(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in out.slots] == [7, 15, 6]
    assert [p.const_coeff() for p in rot.slots] == [7, 5, 6]
    assert len(red.slots) == 2 and red.slots[0].coeffs()[:3] == [5, 6, 7]
    for a, b in zip(out.slots + rot.slots + red.slots, jout.slots + jrot.slots + jred.slots):
        _same(a, b)


def _polyvec_circuit(ns):
    params = ns.params.RingParams.default()
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(1)
    circuit.output([circuit.slot_transfer_gate(w[0], [(1, None), (0, None)])])
    v = ns.poly_vec.PolyVec.const(params, [10, 20], **ns.kw)
    one = ns.poly_vec.PolyVec.const(params, [1, 1], **ns.kw)
    return circuit.eval(params, one, [v],
                        slot_transfer_evaluator=ns.st.PolyVecSlotTransferEvaluator())[0]


def test_polyvec_circuit_slot_gates():
    out, jout = (_polyvec_circuit(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in out.slots] == [20, 10]
    for a, b in zip(out.slots, jout.slots):
        _same(a, b)


def _bgg_vec(ns):
    params = ns.params.RingParams.default()
    us = ns.sampler.UniformSampler(seed=21, **ns.kw)
    secrets = [us.sample_poly(params, ns.sampler.TernaryDist())]
    pubkeys = ns.vec.BGGPublicKeyVecSampler(KEY, 1, 2, **ns.kw).sample(
        params, b"vec_tag", [True, True])
    pts = [ns.poly_vec.PolyVec.const(params, [1, 0], **ns.kw),
           ns.poly_vec.PolyVec.const(params, [1, 1], **ns.kw)]
    encodings = ns.vec.BGGEncodingVecSampler(params, secrets, None, 2, seed=22).sample(
        params, pubkeys, pts)
    prod = encodings[1] * encodings[2]
    swapped = ns.st.BGGVecSlotTransferEvaluator().slot_transfer(
        params, encodings[1], [(1, None), (0, None)], 0)
    return pubkeys, encodings, prod, swapped


def test_bgg_vec_slotwise_homomorphism():
    (pks, encs, prod, swapped), (jpks, jencs, jprod, jswapped) = (
        _bgg_vec(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in prod.plaintexts().slots] == [1, 0]
    assert [e.plaintext.const_coeff() for e in swapped.encodings] == [0, 1]
    for a, b in zip(pks, jpks):
        for x, y in zip(a.keys, b.keys):
            _same(x.matrix, y.matrix)
    for a, b in zip(list(encs) + [prod, swapped], list(jencs) + [jprod, jswapped]):
        for x, y in zip(a.encodings, b.encodings):
            _same(x.vector, y.vector)
            _same(x.pubkey.matrix, y.pubkey.matrix)


def _polyvec_lut(ns):
    params = ns.params.RingParams.default()
    lut = ns.lookup.PublicLut.from_dict(params, {x: (x, x % 3) for x in range(9)})
    v = ns.poly_vec.PolyVec.const(params, [4, 8], **ns.kw)
    return ns.vec_eval.PolyVecPltEvaluator().public_lookup(params, lut, None, v, 0, 0)


def test_polyvec_lut():
    out, jout = (_polyvec_lut(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in out.slots] == [1, 2]
    for a, b in zip(out.slots, jout.slots):
        _same(a, b)


def _vec_circuit(ns, batched):
    """Mul, Add, scalar muls, a LUT and a slot transfer over 3-slot BGG vec
    encodings with the secret-oracle LUT evaluator, lifted slotwise."""
    params = ns.params.RingParams.new(16, 2, 20, 5)
    us = ns.sampler.UniformSampler(seed=5, **ns.kw)
    secret = us.sample_poly(params, ns.sampler.TernaryDist())
    pubkeys = ns.vec.BGGPublicKeyVecSampler(KEY, 1, 3, **ns.kw).sample(
        params, b"vc", [True, True])
    pts = [ns.poly_vec.PolyVec.const(params, v, **ns.kw) for v in ([1, 2, 3], [2, 0, 1])]
    sampler = ns.vec.BGGEncodingVecSampler(params, [secret], 3.0, 3, seed=6)
    encs = sampler.sample(params, pubkeys, pts)
    c = ns.circuit.PolyCircuit()
    w = c.input(2)
    lut = ns.lookup.PublicLut.from_dict(params, {x: (x, (3 * x + 1) % 5) for x in range(8)})
    lid = c.register_public_lut(lut)
    m = [c.mul_gate(w[0], w[1]), c.mul_gate(w[1], w[0]), c.add_gate(w[0], w[1])]
    s = [c.small_scalar_mul(x, [2, 1]) for x in m] + [c.large_scalar_mul(m[2], [3])]
    luts = [c.public_lookup_gate(m[0], lid), c.public_lookup_gate(m[2], lid)]
    t = c.slot_transfer_gate(luts[1], [(2, None), (0, 2), (1, None)])
    c.output(s + luts + [t, c.sub_gate(luts[0], w[0])])
    ev = ns.vec_eval.SlotwisePltEvaluator(
        ns.debug.DebugBGGEncodingPltEvaluator(KEY, sampler.secret_vec))
    return c.eval(params, encs[0], encs[1:], plt_evaluator=ev,
                  slot_transfer_evaluator=ns.st.BGGVecSlotTransferEvaluator(), batched=batched)


def test_vec_circuit_batched_equals_sequential_and_jax():
    port_b = _vec_circuit(load("mxx_tpu_torch"), True)
    port_s = _vec_circuit(load("mxx_tpu_torch"), False)
    jax_s = _vec_circuit(load("mxx_tpu"), False)
    for a, b, c in zip(port_b, port_s, jax_s):
        for x, y, z in zip(a.encodings, b.encodings, c.encodings):
            for part in (lambda e: e.vector, lambda e: e.pubkey.matrix, lambda e: e.plaintext):
                _same(part(x), part(y))
                _same(part(x), part(z))
