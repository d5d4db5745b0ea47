"""The subtract-round-recompose refresher of `noise_refresh/naive_vec.py` in
the port against the JAX package.

- The all-CRT decrypt circuit of one refreshed digit (`_decrypt_circuit`,
  34k gates at `RingParams.new(4, 3, 10, 10)`) and the packed one
  (`_packed_decrypt_circuit`): gate for gate, LUTs included.
- `preprocess_from_decoded` and `online_eval_from_decoded` over the same
  decoded terms and decoders: the refresh keys and the refreshed encoding
  bit for bit (integer work, the modulus switch's float64 fractions
  included), and the refreshed encoding exact for s (A' - x G) when the
  terms and decoders are the ones a refresh would make.
- `decoded_terms` and `decoded_terms_packed` over replayed material: the
  JAX side evaluates the decrypt circuits gate by gate (minutes on the CPU),
  so the value comparison is `slow`.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_structure import assert_circuits_equal

import mxx_tpu  # noqa: F401

KEY = bytes(range(32))
RING = (4, 3, 10, 10)


def load(pkg):
    mods = {"params": "ring.params", "poly": "ring.poly", "matrix": "matrix",
            "circuit": "circuit", "fhe": "gadgets.fhe", "ring_gsw": "gadgets.fhe.ring_gsw",
            "packed": "gadgets.fhe.packed_ring_gsw", "bgg": "bgg", "vec": "bgg.vec",
            "sampler": "sampler", "nv": "noise_refresh.naive_vec", "debug": "lookup.debug",
            "rng": "utils.rng"}
    ns = SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}") for k, m in mods.items()})
    ns.kw = {"device": "cpu"} if pkg == "mxx_tpu_torch" else {}
    return ns


def _np(m):
    m = m.to_coeff()
    return m.data.cpu().numpy().astype(np.uint32) if hasattr(m.data, "cpu") else np.asarray(m.data)


def _refresher(ns, ring=RING):
    params = ns.params.RingParams.new(*ring)
    ctx = ns.fhe.RingGswContext(ns.circuit.PolyCircuit(), params, 5, max_unreduced_muls=1)
    return params, ctx, ns.nv.NoiseRefresherNaiveVec(params, ctx, 1, KEY, **ns.kw)


def test_decrypt_circuit_matches_jax():
    (pj, _, nj), (pt, _, nt) = (_refresher(load(p)) for p in ("mxx_tpu", "mxx_tpu_torch"))
    assert_circuits_equal(nj._decrypt_circuit(1, 1), nt._decrypt_circuit(1, 1), pj, pt)


@pytest.mark.parametrize("slots", [2, 4])
def test_packed_decrypt_circuit_matches_jax(slots):
    (pj, _, nj), (pt, _, nt) = (_refresher(load(p), (8, 3, 10, 10))
                                for p in ("mxx_tpu", "mxx_tpu_torch"))
    assert_circuits_equal(nj._packed_decrypt_circuit(1, 1, slots),
                          nt._packed_decrypt_circuit(1, 1, slots), pj, pt)


def _wires(ns, params):
    us = ns.sampler.UniformSampler(seed=72, **ns.kw)
    sec = us.sample_poly(params, ns.sampler.TernaryDist())
    pks = ns.bgg.BGGPublicKeySampler(KEY, 1, **ns.kw).sample(params, b"nrv", [True, True])
    es = ns.bgg.BGGEncodingSampler(params, [sec], gauss_sigma=None, seed=73)
    x_val = 123457 % params.modulus
    encs = es.sample(params, pks, [ns.poly.Poly.const(params, x_val, **ns.kw),
                                   ns.poly.Poly.const(params, 1, **ns.kw)])
    return pks, encs, es.secret_vec, x_val


def _from_decoded(ns, synthetic):
    """preprocess_from_decoded, then online_eval_from_decoded over terms and
    decoders that are uniform (synthetic) or the ones a refresh makes."""
    params, _, nr = _refresher(ns)
    pks, encs, s_row, x_val = _wires(ns, params)
    us = ns.sampler.UniformSampler(seed=74, **ns.kw)
    m = params.modulus_digits
    terms = [us.sample_uniform(params, 1, m, ns.sampler.FinRingDist())
             for _ in range(params.crt_depth)]
    a_prime_pk, keys = nr.preprocess_from_decoded(b"wire0", pks[0], pks[1], terms)
    if synthetic:
        decoders = [us.sample_uniform(params, 1, m, ns.sampler.FinRingDist())
                    for _ in range(params.crt_depth)]
        enc_terms = terms
    else:
        # zero decoded terms on both paths: the decoders are then s T_i
        zero = ns.matrix.PolyMatrix.zero(params, 1, m, **ns.kw)
        enc_terms = [zero] * params.crt_depth
        _, keys = nr.preprocess_from_decoded(b"wire0", pks[0], pks[1], enc_terms)
        decoders = [s_row @ t for t in keys]
    out = nr.online_eval_from_decoded(b"wire0", encs[0], encs[1], enc_terms, decoders)
    return params, a_prime_pk, keys, out, s_row, x_val


@pytest.mark.parametrize("synthetic", [True, False])
def test_from_decoded_matches_jax(synthetic):
    ns = load("mxx_tpu_torch")
    params, a_pk, keys, out, s_row, x_val = _from_decoded(ns, synthetic)
    _, ja_pk, jkeys, jout, _, _ = _from_decoded(load("mxx_tpu"), synthetic)
    np.testing.assert_array_equal(_np(a_pk.matrix), _np(ja_pk.matrix))
    for a, b in zip(keys, jkeys):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(out.vector), _np(jout.vector))
    assert out.pubkey.matrix == a_pk.matrix
    if not synthetic:
        g = ns.matrix.PolyMatrix.gadget_matrix(params, 1, "cpu")
        want = s_row @ (a_pk.matrix - g.mul_poly_scalar(ns.poly.Poly.const(params, x_val, "cpu")))
        assert out.vector == want, "an exact input refreshes to the exact fresh encoding"


def _material(ns, ctx, params, rng):
    n = params.n
    errors = [[ns.ring_gsw.native_encrypt(ctx, -1, rng.randrange(2), rng) for _ in range(n)]]
    masks = [[ns.ring_gsw.native_encrypt(ctx, -1, rng.randrange(2), rng)
              for _ in range(params.crt_depth * n)]]
    return ns.nv.RefreshMaterialCts(errors=errors, masks=masks)


def _decoded_terms(ns):
    params, ctx, nr = _refresher(ns)
    pks, encs, s_row, _ = _wires(ns, params)
    material = _material(ns, ctx, params, ns.rng.Drbg(71))
    negk = [pks[2], encs[2]]
    t_pk = nr.decoded_terms(pks[0], negk[0], material, ns.debug.DebugBGGPubKeyPltEvaluator(KEY),
                            lambda w: w.matrix)
    t_enc = nr.decoded_terms(encs[0], negk[1], material,
                             ns.debug.DebugBGGEncodingPltEvaluator(KEY, s_row),
                             lambda w: w.vector)
    return t_pk + t_enc


@pytest.mark.slow
def test_decoded_terms_match_jax():
    for a, b in zip(_decoded_terms(load("mxx_tpu_torch")), _decoded_terms(load("mxx_tpu"))):
        np.testing.assert_array_equal(_np(a), _np(b))


def _decoded_terms_packed(ns, slots=4):
    params, ctx, nr = _refresher(ns, (8, 3, 10, 10))
    pks, encs, s_row, _ = _wires(ns, params)
    rng = ns.rng.Drbg(81)
    q = ctx.q_big
    k = [c % q for c in (1, -1, 0, 1)[:slots]]
    errors = [[ns.packed.native_encrypt_poly(ctx, k, [rng.randrange(2) for _ in range(slots)],
                                             rng)]]
    masks = [[ns.packed.native_encrypt_poly(ctx, k, [rng.randrange(2) for _ in range(slots)],
                                            rng)]]
    material = ns.nv.RefreshMaterialCts(errors=errors, masks=masks)
    one_pk, negk_pk = (ns.vec.BGGPublicKeyVec.new([w] * slots) for w in (pks[0], pks[2]))
    one_enc, negk_enc = (ns.vec.BGGEncodingVec.new([w] * slots) for w in (encs[0], encs[2]))
    t_pk = nr.decoded_terms_packed(one_pk, negk_pk, material,
                                   ns.debug.DebugBGGPubKeyPltEvaluator(KEY),
                                   lambda w: w.keys[0].matrix, slots)
    t_enc = nr.decoded_terms_packed(one_enc, negk_enc, material,
                                    ns.debug.DebugBGGEncodingPltEvaluator(KEY, s_row),
                                    lambda w: w.encodings[0].vector, slots)
    return t_pk + t_enc


@pytest.mark.slow
def test_decoded_terms_packed_match_jax():
    for a, b in zip(_decoded_terms_packed(load("mxx_tpu_torch")),
                    _decoded_terms_packed(load("mxx_tpu"))):
        np.testing.assert_array_equal(_np(a), _np(b))
