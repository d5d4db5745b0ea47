"""Packed slot-wise BGG encodings of the port against the JAX package
(mirrors `tests/test_poly_encoding.py`).

The samplers, the homomorphic ops and the circuit pass are integer work:
bit for bit against `mxx_tpu`, and every slot exact in its invariant
c_s = sigma_s A - x_s sigma_s G. The packed LWE lookup samples float-Gaussian
K_high preimages, and the packed GGH15 lookup float-Gaussian chain
preimages, so there the output public key is held to the JAX package's bit
for bit, and the output to its plaintexts and the exact slot invariant.
"""

import importlib
from types import SimpleNamespace

import numpy as np

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))
S = 3
BOTH = ("mxx_tpu", "mxx_tpu_torch")


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "sampler": "sampler", "bgg": "bgg", "pe": "bgg.poly_encoding",
            "circuit": "circuit", "lookup": "lookup", "storage": "storage",
            "ggh15": "lookup.ggh15"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def make_packed(ns, params, slot_values, seed=42):
    us = ns.sampler.UniformSampler(seed=seed, **ns.kw)
    secrets = [us.sample_poly(params, ns.sampler.TernaryDist())]
    pubkeys = ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(
        params, b"packed", [True] * len(slot_values))
    sampler = ns.pe.BGGPolyEncodingSampler(params, secrets, S, None, seed=seed + 1)
    slot_pts = [[ns.poly.Poly.const(params, v, **ns.kw) for v in vals] for vals in slot_values]
    return sampler, pubkeys, sampler.sample(params, pubkeys, slot_pts)


def check_slot_invariant(ns, params, enc, sampler):
    """Row s: c_s == sigma_s A - x_s sigma_s G (exact, zero error)."""
    g = ns.matrix.PolyMatrix.gadget_matrix(params, 1, **ns.kw)
    sg = sampler.secret_mat @ g
    sa = sampler.secret_mat @ enc.pubkey.matrix
    for s in range(enc.num_slots):
        want = sa.slice_rows(s, s + 1) - sg.slice_rows(s, s + 1).mul_poly_scalar(enc.plaintext(s))
        assert enc.vector(s) == want, f"slot {s}"


def _ops(ns):
    params = ns.params.RingParams.default()
    sampler, _, encs = make_packed(ns, params, [[1, 0, 1], [0, 1, 1]])
    one, e1, e2 = encs
    out = list(encs) + [e1 + e2, e1 * e2, e1 - e2, e2.small_scalar_mul(params, [2, 1]),
                        e1.large_scalar_mul(params, [5])]
    for e in out:
        check_slot_invariant(ns, params, e, sampler)
    return out


def test_packed_invariant_and_ops():
    mine, theirs = (_ops(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in mine[3].plaintexts] == [1, 1, 2]
    assert [p.const_coeff() for p in mine[4].plaintexts] == [0, 0, 1]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(_np(a.vectors), _np(b.vectors))
        np.testing.assert_array_equal(_np(a.pubkey.matrix), _np(b.pubkey.matrix))


def _circuit(ns):
    params = ns.params.RingParams.default()
    sampler, _, encs = make_packed(ns, params, [[1, 0, 1], [1, 1, 0]], seed=50)
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(2)
    circuit.output([circuit.add_gate(circuit.mul_gate(w[0], w[1]), w[0])])
    got = circuit.eval(params, encs[0], encs[1:])[0]
    check_slot_invariant(ns, params, got, sampler)
    return got


def test_packed_circuit_eval():
    got, jgot = (_circuit(load(p)) for p in BOTH[::-1])
    assert [p.const_coeff() for p in got.plaintexts] == [2, 0, 1]
    np.testing.assert_array_equal(_np(got.vectors), _np(jgot.vectors))
    np.testing.assert_array_equal(_np(got.pubkey.matrix), _np(jgot.pubkey.matrix))


def _lwe_lookup(ns, tmp_path):
    params = ns.params.RingParams.new(16, 4, 28, 7)
    p_mod = 5
    sampler, pubkeys, encs = make_packed(ns, params, [[1, 3, 4]], seed=60)
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(1)
    lut = ns.lookup.PublicLut.from_dict(params, {x: (x, (x * x) % p_mod) for x in range(p_mod)})
    lid = circuit.register_public_lut(lut)
    circuit.output([circuit.public_lookup_gate(w[0], lid)])
    ns.storage.init_storage_system(tmp_path)
    ts = ns.sampler.TrapdoorSampler(params, 4.578, seed=61, **ns.kw)
    td, b0 = ts.trapdoor(params, 1)
    pk_eval = ns.pe.LWEBGGPolyPubKeyPltEvaluator(KEY, ts, b0, td, tmp_path, S)
    result_pk = circuit.eval(params, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0]
    pk_eval.sample_aux_matrices(params)
    ns.storage.wait_for_all_writes()
    return params, sampler, encs, circuit, b0, result_pk


def test_packed_lwe_lookup(tmp_path):
    ns = load("mxx_tpu_torch")
    params, sampler, encs, circuit, b0, result_pk = _lwe_lookup(ns, tmp_path / "t")
    enc_eval = ns.pe.LWEBGGPolyEncodingPltEvaluator(KEY, tmp_path / "t", sampler.secret_mat @ b0)
    got = circuit.eval(params, encs[0], encs[1:], plt_evaluator=enc_eval)[0]
    assert got.pubkey == result_pk
    assert [p.const_coeff() for p in got.plaintexts] == [1, 4, 1]
    check_slot_invariant(ns, params, got, sampler)
    jresult_pk = _lwe_lookup(load("mxx_tpu"), tmp_path / "j")[5]
    np.testing.assert_array_equal(_np(result_pk.matrix), _np(jresult_pk.matrix))


def _ggh15_pubkey_pass(ns, tmp_path):
    params = ns.params.RingParams.default()
    sampler, pubkeys, encs = make_packed(ns, params, [[3, 5, 9]], seed=70)
    circuit = ns.circuit.PolyCircuit()
    w = circuit.input(1)
    lid = circuit.register_public_lut(
        ns.lookup.PublicLut.from_dict(params, {x: (x, x % 4) for x in range(16)}))
    circuit.output([circuit.public_lookup_gate(w[0], lid)])
    ns.storage.init_storage_system(tmp_path)
    pk_eval = ns.ggh15.GGH15BGGPubKeyPltEvaluator(KEY, 1, 4.578, 0.0, tmp_path, seed=71, **ns.kw)
    result_pk = circuit.eval(params, pubkeys[0], pubkeys[1:], plt_evaluator=pk_eval)[0]
    return params, sampler, encs, circuit, pk_eval, result_pk


def test_packed_ggh15_lookup(tmp_path):
    ns = load("mxx_tpu_torch")
    params, sampler, encs, circuit, pk_eval, result_pk = _ggh15_pubkey_pass(ns, tmp_path / "t")
    pk_eval.sample_aux_matrices(params)
    ns.storage.wait_for_all_writes()
    b0 = pk_eval.load_b0_matrix_checkpoint(params)
    enc_eval = ns.ggh15.GGH15BGGPolyEncodingPltEvaluator(
        KEY, tmp_path / "t", pk_eval.checkpoint_prefix(params), params, sampler.secret_mat @ b0)
    got = circuit.eval(params, encs[0], encs[1:], plt_evaluator=enc_eval)[0]
    assert got.pubkey == result_pk
    assert [p.const_coeff() for p in got.plaintexts] == [3, 1, 1]
    check_slot_invariant(ns, params, got, sampler)
    jresult_pk = _ggh15_pubkey_pass(load("mxx_tpu"), tmp_path / "j")[5]
    np.testing.assert_array_equal(_np(result_pk.matrix), _np(jresult_pk.matrix))
